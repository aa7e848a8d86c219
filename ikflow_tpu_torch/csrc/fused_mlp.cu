// Fused coupling-subnet MLP under the fp32 contract, on Hopper tensor cores
// (sm_90a): 3xTF32 on wgmma, 64-row tiles split by columns over a thread-block
// cluster, one warpgroup staging the operands for the other.
//
// Replaces the Pallas TPU kernel ikflow_tpu/flow/pallas_subnet.py::fused_mlp
// with bf16_hidden=False (pallas_call at :97, body _mlp_kernel at :42-59). For
// a tile of rows it computes h <- x, then h <- h W_l + b_l for every layer,
// with LeakyReLU(0.01) after all but the last, in one launch: fp32 in, fp32
// out, and no (B, width) activation ever goes to device memory.
//
// The fp32 contract. Plain TF32 keeps 10 mantissa bits and would cost the
// 1 mm IK seeds their accuracy, so each operand of a width x width layer is
// split into hi = rna_tf32(v) and lo = rna_tf32(v - hi) (cvt.rna.tf32.f32's
// rounding), and the tensor cores sum lo*hi + hi*lo + hi*hi in fp32 (lo*lo,
// below 2^-20 of the product, is dropped). TF32 products are exact in fp32
// and v - hi - lo is within 2^-22 |v|, so the result is as close to the fp32
// product as fp32 FFMA is (held to 1e-4 of addmm). The weights are split once
// per parameter set (flow/fused_subnet.py::pack_tf32x3_weight), the
// activations once per chunk as they are staged.
//
// What bounds it (width 1024, in 10|11, out 8|6; H100 SXM):
// - operations: the two 1024 x 1024 layers are 2 * B * 2 * 1024^2 FLOP, run
//   as three TF32 passes against the 495 TFLOP/s TF32 peak: 0.256 ms at
//   B = 10000 (the fp32 SIMT bound, at 67 TFLOP/s, is 0.632 ms). The first
//   and the last layer (under 1% of the FLOP) stay fp32 FFMA.
// - L2 bytes: a 64-row tile streams every packed weight once, 16.8 MB of
//   hi/lo planes plus 0.07 MB of fp32 first and last layer per tile:
//   ceil(B / 64) * 16.85 MB = 270 MB at B = 1000 and 2.65 GB at B = 10000
//   (the 16-row SIMT kernel read 533 MB and 5.29 GB of fp32). HBM: the
//   16.85 MB once per call when they are cold in L2, plus x and out.
// - DSMEM bytes: each hidden layer moves the 7 / 8 of the tile's activations
//   that a CTA does not hold, 229 KB per CTA, 1.8 MB per tile: 29 MB at
//   B = 1000 and 288 MB at B = 10000 per hidden layer.
//
// Design:
// - Cluster split. A cluster of C = width / 128 CTAs (8 at width 1024) shares
//   one tile of 64 rows. CTA r owns output columns [128 r, 128 r + 128) of
//   every hidden layer and streams only that 1 / C of each weight. At
//   B = 1000 that is 16 tiles x 8 = 128 CTAs on the 132 SMs, where the 16-row
//   SIMT kernel ran 63 blocks that each streamed all 8.4 MB. One shape serves
//   every B: the L2 bytes per row depend on the tile height only.
// - Activations. CTA r keeps its 64 x 128 slice of a layer's input and output
//   (ping-pong, fp32). The k-loop of a hidden layer runs over the whole width
//   in 32-column chunks; chunk k0 .. k0 + 31 lives in CTA k0 / 128 and is read
//   through distributed shared memory (mapa + ld.shared::cluster), 8 lanes per
//   128-byte row. CTA r walks the chunks starting from its own slice, so at
//   every step the eight CTAs read eight different peers (in the same order
//   for all, one peer would serve the whole cluster at once). barrier.cluster
//   between layers makes every slice visible and keeps a slice from being
//   overwritten while a peer still reads it.
// - Warp specialisation. Warpgroup 0 issues the products. Warpgroup 1 stages
//   the operands: each thread keeps the peer reads of the next 4 chunks in
//   flight in its registers (no wgmma fence waits on them), splits a landed
//   chunk into hi and lo and stores it into an A buffer, and copies the packed
//   weight planes of the chunk after next into a B buffer by cp.async. One
//   __syncthreads per chunk hands the staged chunk over.
// - Products. Per chunk and k-step of 8: three wgmma.m64n128k8.f32.tf32 from
//   shared memory (A: 64 rows; B: the CTA's 128 columns), 64 accumulators per
//   thread. The tensor cores truncate every partial sum to fp32, which over
//   3 x 128 k-steps biases a sum by hundreds of ulps; so each chunk's products
//   are summed from zero (scale-d 0 on its first wgmma) and added to 64 fp32
//   running sums in registers, rounded to nearest. A planes use the 128-byte
//   swizzle (rows of 32 words; a k-step advances the descriptor by 32 B), so
//   the staging stores of a row are free of bank conflicts; B planes are
//   unswizzled core matrices, packed in that order in global memory so that
//   a chunk is 32 contiguous KB.
// - Any width. A hidden width that is no multiple of 128 is zero-padded to the
//   next one: the packed planes hold the padded weight (rows and columns), and
//   the fp32 first and last layer weights and the biases are read with the
//   padding masked to zero. A padded column's activation is LeakyReLU(0) = 0,
//   so the result is exact, as the Pallas kernel's pad_subnet_params pads.
// - The first layer (K = in <= width) is fp32 FFMA into the CTA's slice, over
//   k in chunks of 64: the x chunk and the CTA's weight slice of it staged in
//   shared memory. The last layer
//   (out <= 16) is fp32 FFMA over the CTA's 128 rows of k into partial sums;
//   after a cluster barrier each CTA sums the C partials of its rows
//   (r % C == rank) in rank order, adds the bias and stores; a last barrier
//   keeps every CTA's partials alive until its peers have read them.
// - The ragged last tile: rows past B are zero on load and never stored.
//
// Shared memory per CTA: activations 2 x 64 x 132 x 4 = 67,584 B; A planes
// 2 buffers x (hi, lo) x 8 KB = 32,768 B (they also hold the x chunk before
// the first hidden layer); B planes 3 buffers x (hi, lo) x 16 KB = 98,304 B
// (also the first and last layer's weight slices); partials 64 x 16 x 4 =
// 4,096 B: 202,752 B, one CTA per SM.
#include "cluster_mlp.cuh"

namespace {

constexpr int kMathThreads = 128;  // warpgroup 0: wgmma over the CTA's 128 columns
constexpr int kLoadThreads = 128;  // warpgroup 1: stages the operands
constexpr int kChunk = 32;     // k per pipeline step: 4 wgmma k-steps of 8
constexpr int kABufs = 2;      // A planes: chunk j in use, chunk j + 1 being written
constexpr int kBBufs = 3;      // B planes: chunk j in use, j + 1 and j + 2 in flight
constexpr int kAAhead = 4;     // chunks of activations in flight from the peers, in registers

// wgmma operand planes, K-major. B planes, unswizzled core matrices
// (cluster_mlp.cuh: desc_b), kChunk / 4 = 8 of them along K per 8-row
// group. A hidden weight comes packed in exactly this form
// (flow/fused_subnet.py::pack_tf32x3_weight): for each CTA slice and chunk,
// its hi plane then its lo plane, 32 KB together. A planes: 128-byte
// swizzle, see desc_a.
static_assert(kMathThreads + kLoadThreads == kThreads, "two warpgroups");
static_assert(kSBO == kChunk / 4 * 128, "a B plane's 8-row group is kChunk / 4 core matrices deep");
constexpr int kAPlaneWords = kTileRows * kChunk;  // one of hi, lo: 8 KB
constexpr int kBPlaneWords = kSlice * kChunk;     // 16 KB

constexpr int kActFloats = kTileRows * kActStride;
constexpr int kPartialFloats = kTileRows * kMaxOut;
// Shared memory, in 4-byte words: two activation slices, the A and B plane
// buffers (hi and lo each), the partial sums of the last layer.
constexpr int kSmemWords = 2 * kActFloats + kABufs * 2 * kAPlaneWords + kBBufs * 2 * kBPlaneWords + kPartialFloats;
constexpr int kSmemBytes = 4 * kSmemWords;
constexpr int kAVecs = kTileRows * kChunk / 4 / kLoadThreads;  // float4 of an A chunk per loading thread
constexpr int kBVecs = 2 * kBPlaneWords / 4 / kLoadThreads;    // 16-byte copies of a packed B chunk per loading thread
static_assert(kTileRows * kInChunk <= kABufs * 2 * kAPlaneWords, "an x chunk must fit in the A planes");
static_assert(kInChunk * kSlice <= kBBufs * 2 * kBPlaneWords, "a first-layer weight chunk must fit in the B planes");
static_assert(kSlice * kMaxOut <= kBBufs * 2 * kBPlaneWords, "the last layer's weights must fit in the B planes");
static_assert(kSmemBytes <= 227 * 1024, "a block may use 227 KB of shared memory");
static_assert(kChunk * 4 == 128, "A rows are one 128-byte swizzle atom wide");
static_assert((2 * kActFloats * 4) % 1024 == 0, "A planes start on a 1024-byte swizzle atom");
static_assert(kSlice / kChunk % kAAhead == 0, "the chunks of a layer must fill whole rounds of register slots");

struct MlpArgs {
  const float* w[kMaxLayers];   // fp32 (K, N): read for the first and the last layer
  const float* wp[kMaxLayers];  // packed tf32 hi/lo planes, padded to `slices` x 128: read for 0 < l < n - 1
  const float* b[kMaxLayers];
  int n_layers;
  int in_dim;
  int width;   // the hidden width, a multiple of 4
  int slices;  // CTAs per cluster: width / 128 rounded up
  int out_dim;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// cvt.rna.tf32.f32 for finite v, on the bit pattern: add half of the 13
// dropped bits to the magnitude and truncate (round to nearest, ties away
// from zero). Two integer operations.
__device__ __forceinline__ uint32_t rna_tf32(float v) { return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u; }

// v = hi + lo + O(2^-22 |v|), hi and lo tf32 (fp32 bit patterns, low 13 bits 0).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));
}

// d (64 x 128, fp32) = A (64 x 8 tf32, K-major in shared memory) * B (8 x 128,
// K-major in shared memory) + (accumulate ? d : 0), issued by the warpgroup,
// asynchronous.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Layer 0: h_out[r][c] = leaky(sum_k x[row0 + r][k] W[k][col0 + c] + b[col0 + c])
// for the tile's 64 rows and this CTA's 128 columns, in fp32, over k in
// chunks of kInChunk: the x chunk (64 x kc, rows past B zero) into xs, this
// CTA's kc x 128 slice of W (columns past `width` zero) into Ws. A warp owns
// 8 rows, a lane 4 columns; xs is a broadcast read.
__device__ void input_layer(const float* __restrict__ x, int B, int row0, int K, const float* __restrict__ W,
                            const float* __restrict__ bias, int width, int col0, float* xs, float* Ws,
                            float* h_out) {
  const int r0 = (threadIdx.x >> 5) * 8;
  const int c = (threadIdx.x & 31) * 4;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kInChunk) {
    const int kc = min(kInChunk, K - k0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < kTileRows * kc; i += kThreads) {
      const int r = i / kc;
      xs[i] = row0 + r < B ? x[static_cast<size_t>(row0 + r) * K + k0 + i - r * kc] : 0.f;
    }
    for (int i = threadIdx.x; i < kc * kSlice / 4; i += kThreads) {
      const int k = i / (kSlice / 4), col = col0 + 4 * (i % (kSlice / 4));
      reinterpret_cast<float4*>(Ws)[i] =
          col < width ? __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(k0 + k) * width + col)) : zero4();
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(Ws + k * kSlice + c);
#pragma unroll
      for (int r = 0; r < 8; ++r) fma4(acc[r], xs[(r0 + r) * kc + k], w);
    }
  }
  const float4 bb = col0 + c < width ? __ldg(reinterpret_cast<const float4*>(bias + col0 + c)) : zero4();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<float4*>(h_out + (r0 + r) * kActStride + c) =
        make_float4(leaky(acc[r][0] + bb.x), leaky(acc[r][1] + bb.y), leaky(acc[r][2] + bb.z),
                    leaky(acc[r][3] + bb.w));
  }
}

// The tile's 64 x kChunk input columns k0 = chunk * kChunk ... from the CTA
// that holds them: loading thread p's float4 i is row idx / 8, columns
// 4 (idx % 8) ..., idx = p + i * kLoadThreads (8 lanes read a row's 128
// contiguous bytes).
__device__ __forceinline__ void load_a(int p, uint32_t h_in_addr, int chunk, float4 (&v)[kAVecs]) {
  const int k0 = chunk * kChunk;
  const uint32_t owner = static_cast<uint32_t>(k0 / kSlice);
  const int col = k0 - static_cast<int>(owner) * kSlice;
#pragma unroll
  for (int i = 0; i < kAVecs; ++i) {
    const int idx = p + i * kLoadThreads;
    const int r = idx / (kChunk / 4), c4 = idx % (kChunk / 4);
    v[i] = ld_peer4(peer_addr(h_in_addr + (r * kActStride + col + c4 * 4) * 4, owner));
  }
}

// A planes <- the chunk, split once into tf32 hi and lo.
__device__ __forceinline__ void store_a(int p, uint32_t* hi, uint32_t* lo, const float4 (&v)[kAVecs]) {
#pragma unroll
  for (int i = 0; i < kAVecs; ++i) {
    const int idx = p + i * kLoadThreads;
    const int o = a_offset(idx / (kChunk / 4), idx % (kChunk / 4)) / 4;
    uint4 h, l;
    split_tf32(v[i].x, h.x, l.x);
    split_tf32(v[i].y, h.y, l.y);
    split_tf32(v[i].z, h.z, l.z);
    split_tf32(v[i].w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// B planes <- the packed hi and lo planes of chunk `chunk` of this CTA's
// slice (32 contiguous KB), kBVecs cp.async of 16 bytes per loading thread.
__device__ __forceinline__ void load_b(int p, uint32_t planes_addr, const float* __restrict__ Wp, int slice,
                                       int n_chunks, int chunk) {
  const float* src = Wp + static_cast<size_t>(slice * n_chunks + chunk) * (2 * kBPlaneWords);
#pragma unroll
  for (int i = 0; i < kBVecs; ++i) {
    const int idx = p + i * kLoadThreads;
    cp_async16(planes_addr + idx * 16, src + idx * 4);
  }
}

// One width x width layer: h_out (this CTA's 64 x 128 slice) =
// leaky(h W[:, col0 : col0 + 128] + b), h spread over the cluster's h_in
// slices, W from its packed planes Wp (padded to `slices` x 128 rows and
// columns; bias columns past `width` read as zero). Warpgroup 0 computes the 128 columns
// with m64n128k8 wgmma on chunk j while warpgroup 1 stages chunk
// j + 1's activations (read from the peers kAAhead chunks ahead, into its own
// registers, which no wgmma fence waits on) and chunk j + 2's weights.
__device__ __forceinline__ void hidden_layer(const float* h_in, float* h_out, uint32_t* aplanes, uint32_t* bplanes,
                                             const float* __restrict__ Wp, const float* __restrict__ bias, int width,
                                             int slices, int rank) {
  const int wg = threadIdx.x >> 7;
  const int p = threadIdx.x - kMathThreads;  // loading thread index, for wg == 1
  const int col0 = rank * kSlice;
  const int n_chunks = slices * (kSlice / kChunk);
  const uint32_t h_in_addr = smem_addr(h_in);
  const uint32_t b_addr = smem_addr(bplanes);
  constexpr int kBBufBytes = 2 * kBPlaneWords * 4;
  auto a_plane = [&](int b, int lo) { return aplanes + (2 * b + lo) * kAPlaneWords; };
  // Step j takes k-chunk kc(j): CTA r starts at its own slice, so at every
  // step the cluster's CTAs read from distinct peers.
  auto kc = [&](int j) { return (j + rank * (kSlice / kChunk)) % n_chunks; };

  // Prologue: chunks 0 and 1 of the weights in flight, chunk 0's activations
  // staged, chunks 1 .. kAAhead's in flight into registers (slot j % kAAhead).
  float4 va[kAAhead][kAVecs];
  if (wg == 1) {
    load_b(p, b_addr, Wp, rank, n_chunks, kc(0));
    cp_async_commit();
    load_b(p, b_addr + kBBufBytes, Wp, rank, n_chunks, kc(1));
    cp_async_commit();
    load_a(p, h_in_addr, kc(0), va[0]);
    store_a(p, a_plane(0, 0), a_plane(0, 1), va[0]);
#pragma unroll
    for (int c = 1; c <= kAAhead; ++c) {
      if (c < n_chunks) load_a(p, h_in_addr, kc(c), va[c % kAAhead]);
    }
    cp_async_wait<1>();
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 1) {
    // Step j: stage chunk j + 1's activations (in flight since step
    // j + 1 - kAAhead), start chunk j + 1 + kAAhead's into the freed
    // registers and chunk j + 2's weights. n_chunks is a multiple of
    // kAAhead, so the register slots are fixed at compile time.
    auto stage = [&](int j, float4(&slot)[kAVecs]) {
      if (j + 1 < n_chunks) {
        if (j + 2 < n_chunks) load_b(p, b_addr + ((j + 2) % kBBufs) * kBBufBytes, Wp, rank, n_chunks, kc(j + 2));
        cp_async_commit();
        store_a(p, a_plane((j + 1) & 1, 0), a_plane((j + 1) & 1, 1), slot);
        if (j + 1 + kAAhead < n_chunks) load_a(p, h_in_addr, kc(j + 1 + kAAhead), slot);
        cp_async_wait<1>();  // this thread's copies of chunk j + 1 have landed
        fence_proxy_async();
      }
      __syncthreads();  // chunk j + 1 staged; chunk j's buffers free
    };
    for (int j = 0; j < n_chunks; j += kAAhead) {
#pragma unroll
      for (int u = 0; u < kAAhead; ++u) stage(j + u, va[(u + 1) % kAAhead]);
    }
    cp_async_wait<0>();
    return;
  }

  // Step j: the products of chunk j, summed by the tensor cores from zero and
  // then added to the running fp32 sums: the tensor cores truncate each
  // partial sum, so a chunk's partial sums stay small against the total.
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    fence_acc(acc);
    wgmma_fence();
    const uint32_t ah = smem_addr(a_plane(j & 1, 0)), al = smem_addr(a_plane(j & 1, 1));
    const uint32_t bh = b_addr + (j % kBBufs) * kBBufBytes, bl = bh + kBPlaneWords * 4;
#pragma unroll
    for (int s = 0; s < kChunk / 8; ++s) {
      const uint32_t oa = s * 32, ob = s * 2 * kLBO;  // 8 k: 32 B of an A row, two B core matrices
      wgmma_tf32(acc, desc_a(al + oa), desc_b(bh + ob), s > 0);
      wgmma_tf32(acc, desc_a(ah + oa), desc_b(bl + ob), 1);
      wgmma_tf32(acc, desc_a(ah + oa), desc_b(bh + ob), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    __syncthreads();  // chunk j + 1 staged; chunk j's buffers free
  }

  // Sums of warp w of the warpgroup (the accumulator layout): rows 16 w + g (+ 8), columns
  // 8 i + 2 t (+ 1), for i = 0 .. 15.
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * w + g;
    const int c = 8 * i + 2 * t;
    const float2 bb =
        col0 + c < width ? __ldg(reinterpret_cast<const float2*>(bias + col0 + c)) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(h_out + r * kActStride + c) =
        make_float2(leaky(sum[4 * i] + bb.x), leaky(sum[4 * i + 1] + bb.y));
    *reinterpret_cast<float2*>(h_out + (r + 8) * kActStride + c) =
        make_float2(leaky(sum[4 * i + 2] + bb.x), leaky(sum[4 * i + 3] + bb.y));
  }
}

// Last layer, this CTA's share: partial[r][n] = sum over its 128 k of
// h[r][k] Ws[k][n], Ws the CTA's 128 x N rows of W staged in shared memory.
// 4 lanes per row, each for n = q, q + 4, ...
__device__ void output_partial(const float* h, const float* Ws, int N, float* partial) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float s[kMaxOut / 4];
#pragma unroll
  for (int i = 0; i < kMaxOut / 4; ++i) s[i] = 0.f;
  const float* hr = h + r * kActStride;
  for (int k = 0; k < kSlice; ++k) {
    const float hv = hr[k];
    const float* wk = Ws + k * N;
#pragma unroll
    for (int i = 0; i < kMaxOut / 4; ++i) {
      const int n = q + 4 * i;
      if (n < N) s[i] = fmaf(hv, wk[n], s[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxOut / 4; ++i) {
    const int n = q + 4 * i;
    if (n < N) partial[r * kMaxOut + n] = s[i];
  }
}

__global__ void __launch_bounds__(kThreads, 1) fused_mlp_kernel(const float* __restrict__ x,
                                                                float* __restrict__ out, int B, MlpArgs a) {
  extern __shared__ float4 smem4[];
  float* act0 = reinterpret_cast<float*>(smem4);
  float* act1 = act0 + kActFloats;
  uint32_t* aplanes = reinterpret_cast<uint32_t*>(act1 + kActFloats);
  uint32_t* bplanes = aplanes + kABufs * 2 * kAPlaneWords;
  float* wstage = reinterpret_cast<float*>(bplanes);  // the first and last layer's weight slices
  float* partial = wstage + kBBufs * 2 * kBPlaneWords;

  const int cluster = a.slices;
  const int rank = static_cast<int>(cluster_rank());
  const int row0 = (blockIdx.x / cluster) * kTileRows;
  const int col0 = rank * kSlice;

  // The x chunks in the A planes, this CTA's slice of W_0 in the B planes.
  input_layer(x, B, row0, a.in_dim, a.w[0], a.b[0], a.width, col0, reinterpret_cast<float*>(aplanes), wstage, act0);

  float* h_in = act0;
  float* h_out = act1;
  for (int l = 1; l < a.n_layers - 1; ++l) {
    cluster_sync();  // every slice of h_in written; no peer still reads h_out
    hidden_layer(h_in, h_out, aplanes, bplanes, a.wp[l], a.b[l], a.width, a.slices, rank);
    float* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
  // This CTA's 128 rows of W_last (contiguous; rows past `width` zero) into the B planes.
  const int L = a.n_layers - 1;
  const int last_words = min(kSlice, a.width - col0) * a.out_dim;
  __syncthreads();
  for (int i = threadIdx.x; i < kSlice * a.out_dim / 4; i += kThreads) {
    reinterpret_cast<float4*>(wstage)[i] =
        4 * i < last_words ? __ldg(reinterpret_cast<const float4*>(a.w[L] + static_cast<size_t>(col0) * a.out_dim) + i)
                           : zero4();
  }
  __syncthreads();
  output_partial(h_in, wstage, a.out_dim, partial);
  cluster_sync();
  output_reduce(partial, cluster, rank, a.b[L], a.out_dim, out, row0, B);
  cluster_sync();  // no CTA leaves while a peer reads its partials
}

}  // namespace

extern "C" {

int ikflow_fused_mlp_smem_bytes() { return kSmemBytes; }

// How many clusters of this width's shape can be resident at once on the
// current device, into *n; returns the cudaError_t.
int ikflow_fused_mlp_max_active_clusters(int width, int* n) {
  if (!valid_shape(1, width, 1, 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(kTileRows * 1024, width, kSmemBytes, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, (const void*)fused_mlp_kernel, &cfg));
}

// x (B, in_dim), out (B, out_dim), w[l] (K_l, N_l), b[l] (N_l,) and, for the
// hidden layers 0 < l < n_layers - 1, wp[l] (their packed tf32 hi/lo planes,
// 2 * P * P words for P = width rounded up to a multiple of 128), all
// contiguous fp32 on the current device, 16-byte aligned; hidden widths equal
// `width`, a multiple of 4 up to 1024; in_dim <= width, out_dim <= 16. Launches on `stream` and returns the launch's
// cudaError_t.
int ikflow_fused_mlp(const float* x, float* out, int B, int in_dim, int width, int out_dim, int n_layers,
                     const float* const* w, const float* const* wp, const float* const* b, void* stream) {
  if (B <= 0 || !valid_shape(in_dim, width, out_dim, n_layers)) return static_cast<int>(cudaErrorInvalidValue);
  MlpArgs a;
  for (int l = 0; l < kMaxLayers; ++l) {
    a.w[l] = l < n_layers ? w[l] : nullptr;
    a.wp[l] = l > 0 && l < n_layers - 1 ? wp[l] : nullptr;
    a.b[l] = l < n_layers ? b[l] : nullptr;
  }
  a.n_layers = n_layers;
  a.in_dim = in_dim;
  a.width = width;
  a.slices = slices_of(width);
  a.out_dim = out_dim;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, width, kSmemBytes, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, fused_mlp_kernel, x, out, B, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ikflow_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
