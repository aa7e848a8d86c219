// Fused coupling-subnet MLP with bf16 hidden layers, on Hopper tensor cores
// (sm_90a): bf16 wgmma, 64-row tiles split by columns over a thread-block
// cluster, the CTA's weight slice streamed by bulk async copy into a ring.
//
// Replaces the Pallas TPU kernel ikflow_tpu/flow/pallas_subnet.py::fused_mlp
// with bf16_hidden=True (pallas_call at :97, body _mlp_kernel at :42-59). For
// a tile of rows it computes h <- x, then per layer h <- h W_l + b_l, with
// LeakyReLU(0.01) after all but the last. The layers 0 < l < n-1 (the
// width x width ones) round their input and their weight to bf16 (round to
// nearest even), sum the products in fp32 and add the bias in fp32; the first
// and the last layer, the biases, the activation and the output stay fp32. As
// on the TPU, no (B, width) activation ever goes to device memory.
//
// What bounds it (width 1024, in 10|11, out 8|6; H100 SXM): the two
// 1024 x 1024 layers are 2 * B * 2 * 1024^2 bf16 FLOP at 989 TFLOP/s,
// 0.042 ms at B = 10000; the function's bytes (4.3 MB of weights, x, out)
// take 0.0013 ms, so it is bound by operations from about 300 rows up. The
// kernel's own traffic is larger: a 64-row tile streams every hidden weight
// once from L2 (4.2 MB of bf16 per tile: 0.07 GB at B = 1000, 0.66 GB at
// B = 10000) and each CTA reads the 7/8 of a layer's input that its peers
// hold through distributed shared memory (112 KB per CTA and hidden layer).
//
// Design:
// - Cluster split. A cluster of C = ceil(width / 128) CTAs (8 at width 1024)
//   shares one tile of 64 rows. CTA r owns output columns [128 r, 128 r + 128)
//   of every hidden layer and streams only that 1 / C of each weight (256 KB
//   per layer at width 1024). At B = 1000 that is 16 tiles x 8 = 128 CTAs.
//   One tile height (64, wgmma's M) serves every B; a 128-row tile would halve
//   the L2 bytes from about 10000 rows up but fill only 64 CTAs at 1000 rows,
//   and is not built.
// - Occupancy. 115,264 B of shared memory and at most 128 registers a thread
//   (the build reports no spills), so two CTAs fit on an SM: 30 clusters of 8
//   at once, and 1000 rows run in one wave. After the first layer each
//   warpgroup runs its own path to the end, and setmaxnreg moves registers
//   from the staging warpgroup (80) to the one that holds the accumulators
//   (160).
// - Activations. CTA r keeps its bf16 64 x 128 slice of the layer's input as
//   two 8 KB blocks in the wgmma A layout (64 rows of 64 bf16 = 128 bytes,
//   128-byte swizzle). A hidden layer's k-loop runs over the width in chunks
//   of 64; chunk kc lives in CTA kc / 2, block kc % 2, and staging it is a
//   byte copy of that block into a local A slot. One slice, not a ping-pong
//   pair: a CTA overwrites its slice with the layer's output only after a
//   cluster barrier says that no peer still reads it, which buys the A ring
//   two more slots.
// - Pull, not push. Warpgroup 1 pulls the chunks from their owners with
//   ld.shared::cluster, 2 chunks ahead in its registers, and stores them into
//   a 4-slot A ring. A push by cp.async.bulk into the peers' rings would need
//   an empty barrier in every receiving CTA that every sender waits on
//   remotely; the pull needs only the barrier.cluster between layers. CTA r
//   walks the chunks from its own slice, so at every step the cluster's CTAs
//   read distinct peers.
// - Weights. The hidden weights are packed once per parameter set
//   (flow/fused_subnet.py::pack_bf16_weight) so that each (CTA slice, 64-row
//   chunk) is one contiguous 16 KB block in the order desc_b reads. They
//   stream into a 4-slot ring by 1-D cp.async.bulk (no tensor map), completing
//   on the slot's full mbarrier: the first 4 while layer 0 runs, then each one
//   by thread 0 as soon as its slot is released, across layer boundaries.
// - One full and one empty mbarrier per slot, for the A chunk and the weight
//   chunk together: full counts warpgroup 1's 128 arrivals plus the weights'
//   arrive.expect_tx (and the bytes), empty the 4 consumer warps.
// - Products. Warpgroup 0 runs wgmma.m64n128k16.f32.bf16.bf16 from shared
//   memory, 4 k-steps per chunk. The tensor cores truncate their partial
//   sums, so each chunk is summed from zero into 64 registers and added to 64
//   fp32 running sums (as K1 does): 99.2-99.6% of the outputs on the shipped
//   weights stay within 1e-5 of the plain version's exact fp32 sums, against
//   96.6-98.2% with the whole k range summed in the tensor cores. The
//   epilogue adds the bias (staged in shared memory by warpgroup 1), applies
//   the LeakyReLU and stores the slice in bf16 (round to nearest even), or,
//   after the last hidden layer, fp32 rows into the weight ring, which is
//   free by then.
// - Any width. A hidden width that is no multiple of 128 is zero-padded to the
//   next one: the packed weight holds the padded rows and columns, and the fp32
//   first and last layer weights and the biases are read with the padding
//   masked to zero. A padded column's activation is LeakyReLU(0) = 0, so the
//   result is exact, as the Pallas kernel's pad_subnet_params pads.
// - The first layer (K = in <= width) is fp32 FFMA into the CTA's slice, 64
//   input columns at a time: the x chunk staged in the slice, W_0's in the A
//   ring. The last layer (out <= 16) is fp32 FFMA over the CTA's 128 rows of k
//   into partial sums, reduced in rank order after a cluster barrier
//   (cluster_mlp.cuh, as K1); warpgroup 1 stages its weights into a free A
//   slot while the last hidden layer's final chunks run.
// - The ragged last tile: rows past B are zero on load and never stored.
//
// Shared memory per CTA: weight ring 4 x 16 KB = 65,536 B (at the end the
// fp32 activations, 64 x 132 x 4, and the partial sums); A ring 4 x 8 KB =
// 32,768 B (first the first layer's weight chunks); the activation slice
// 16,384 B (first the x chunks); 8 mbarriers; the bias slice, 512 B.
#include <cuda_bf16.h>

#include "cluster_mlp.cuh"

namespace {

constexpr int kChunk = 64;                           // k per pipeline step: 4 wgmma k-steps of 16
constexpr int kStages = 4;                           // slots of the weight ring and of the A ring
// Registers a thread, after the first layer: warpgroup 0 holds 2 x 64
// accumulators, warpgroup 1 little. setmaxnreg only moves registers within
// the CTA's allocation, 128 a thread (two CTAs per SM), so the two must not
// add up to more.
constexpr int kMathRegs = 160;
constexpr int kStageRegs = 80;
constexpr int kAAhead = 2;                           // chunks of activations in flight from the peers, in registers
constexpr int kABytes = kTileRows * kChunk * 2;      // one A chunk: 8 KB
constexpr int kWBytes = kSlice * kChunk * 2;         // one packed weight chunk: 16 KB
constexpr int kSliceBytes = kTileRows * kSlice * 2;  // one bf16 activation slice: 16 KB
constexpr int kAVecs = kABytes / 16 / 128;           // 16-byte copies of an A chunk per staging thread
constexpr int kWRingOff = 0;
constexpr int kARingOff = kWRingOff + kStages * kWBytes;
constexpr int kActOff = kARingOff + kStages * kABytes;
constexpr int kBarOff = kActOff + kSliceBytes;
constexpr int kFull = 0, kEmpty = kStages;  // a full and an empty mbarrier per slot
constexpr int kBiasOff = kBarOff + 8 * 2 * kStages;
constexpr int kSmemBytes = kBiasOff + kSlice * 4;
static_assert(kChunk * 2 == 128, "A rows are one 128-byte swizzle atom wide");
static_assert(kSBO == kChunk / 8 * 128, "a packed weight chunk's 8-row group is kChunk / 8 core matrices deep");
static_assert(kARingOff % 1024 == 0 && kActOff % 1024 == 0, "A blocks start on a 1024-byte swizzle atom");
static_assert((kTileRows * kActStride + kTileRows * kMaxOut) * 4 <= kStages * kWBytes,
              "the fp32 activations and the partial sums must fit in the weight ring");
static_assert(kTileRows * kInChunk * 4 <= kSliceBytes, "an x chunk must fit in the activation slice");
static_assert(kInChunk * kSlice * 4 <= kStages * kABytes, "a first-layer weight chunk must fit in the A ring");
static_assert(kSlice * kMaxOut * 4 <= kABytes, "the last layer's weights fit in one A slot");
static_assert(2 * (kSmemBytes + 1024) <= 228 * 1024, "two CTAs per SM");
static_assert(kMathRegs + kStageRegs <= 2 * 128 && kMathRegs % 8 == 0 && kStageRegs % 8 == 0,
              "setmaxnreg moves registers within the CTA's allocation");

struct MlpArgs {
  const float* w[kMaxLayers];           // fp32 (K, N): read for the first and the last layer
  const __nv_bfloat16* wp[kMaxLayers];  // packed bf16 weights, padded to `slices` x 128: read for 0 < l < n - 1
  const float* b[kMaxLayers];
  int n_layers;
  int in_dim;
  int width;   // the hidden width, a multiple of 4
  int slices;  // CTAs per cluster: width / 128 rounded up
  int out_dim;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes from global memory into this CTA's shared memory,
// completing as transactions on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// d (64 x 128, fp32) = A (64 x 16 bf16, K-major in shared memory) * B (16 x
// 128, K-major in shared memory) + (accumulate ? d : 0), issued by the
// warpgroup, asynchronous.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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

// Byte offset of column c (0 <= c < 128) of row r in a bf16 activation slice:
// block c / 64, then the swizzled A layout of that block.
__device__ __forceinline__ int slice_offset(int r, int c) {
  return (c >> 6) * kABytes + a_offset(r, (c & 63) >> 3) + (c & 7) * 2;
}

// Layer 0: leaky(sum_k x[row0 + r][k] W[k][col0 + c] + b[col0 + c]) for the
// tile's 64 rows and this CTA's 128 columns, in fp32, over k in chunks of
// kInChunk: the x chunk (rows past B zero) into xs, this CTA's kc x 128 slice
// of W (columns past `width` zero) into Ws. A warp owns 8 rows, a lane 4
// columns; xs is a broadcast read. Stored as a bf16 slice (h16, which may
// alias xs) or, when no hidden layer follows, as fp32 rows of stride
// kActStride (h32).
__device__ __forceinline__ void input_layer(const float* __restrict__ x, int B, int row0, int K,
                                            const float* __restrict__ W, const float* __restrict__ bias, int width,
                                            int col0, float* xs, float* Ws, uint8_t* h16, float* h32) {
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
  __syncthreads();  // every thread is done with xs
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float v0 = leaky(acc[r][0] + bb.x), v1 = leaky(acc[r][1] + bb.y);
    const float v2 = leaky(acc[r][2] + bb.z), v3 = leaky(acc[r][3] + bb.w);
    if (h16 != nullptr) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(h16 + slice_offset(r0 + r, c));
      o[0] = __floats2bfloat162_rn(v0, v1);
      o[1] = __floats2bfloat162_rn(v2, v3);
    } else {
      *reinterpret_cast<float4*>(h32 + (r0 + r) * kActStride + c) = make_float4(v0, v1, v2, v3);
    }
  }
}

// Where the pipeline of one CTA lives: shared-memory addresses of the rings
// and barriers, and the chunk schedule. Chunks are counted over all hidden
// layers (g = (l - 1) * n_chunks + j), so the rings and the barriers' phases
// run on across layer boundaries.
struct Pipe {
  uint32_t wring, aring, bars;
  int n_chunks;  // k-chunks per hidden layer: 2 * slices
  int total;     // chunks over all hidden layers
  int rank;
  __device__ uint32_t bar(int i) const { return bars + 8 * i; }
  // Step j of a layer takes k-chunk kc(j): CTA r starts at its own slice.
  __device__ int kc(int j) const { return (j + 2 * rank) % n_chunks; }
};

// The CTA's stream of weight chunks, kept by thread 0 (warpgroup 0): the
// next chunk to issue (g), its step in its layer and its k-chunk, advanced
// without divisions. A chunk goes into slot g % kStages once chunk
// g - kStages has been released from it. The arrive.expect_tx is the 129th
// arrival on the slot's full barrier, so the slot cannot read as full before
// the bytes are expected, whichever of its two producers comes first.
struct WeightStream {
  int next = 0, j = 0, kc = 0, layer = 1;
  __device__ void issue(const Pipe& p, const MlpArgs& a) {
    const int s = next % kStages;
    const __nv_bfloat16* src = a.wp[layer] + static_cast<size_t>(p.rank * p.n_chunks + kc) * (kWBytes / 2);
    mbar_arrive_expect_tx(p.bar(kFull + s), kWBytes);
    bulk_load(p.wring + s * kWBytes, src, kWBytes, p.bar(kFull + s));
    ++next;
    kc = kc + 1 == p.n_chunks ? 0 : kc + 1;
    if (++j == p.n_chunks) {
      j = 0;
      ++layer;
    }
  }
};

// Warpgroup 1 for one hidden layer (chunks g0 ...): first this CTA's slice of
// the bias into bias_s (columns past `width` zero), then the A ring, fed
// from the owners of the chunks kAAhead chunks ahead in registers.
__device__ __forceinline__ void stage_layer(const Pipe& p, uint32_t h_in, int g0, const float* __restrict__ bias,
                                            int width, int col0, float* bias_s) {
  const int t = threadIdx.x - 128;
  bias_s[t] = col0 + t < width ? __ldg(bias + col0 + t) : 0.f;
  float4 va[kAAhead][kAVecs];
  auto load = [&](int j, float4(&v)[kAVecs]) {
    const int kc = p.kc(j);
    const uint32_t src = peer_addr(h_in + (kc & 1) * kABytes, static_cast<uint32_t>(kc >> 1));
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) v[i] = ld_peer4(src + (t + i * 128) * 16);
  };
#pragma unroll
  for (int u = 0; u < kAAhead; ++u) {
    if (u < p.n_chunks) load(u, va[u]);
  }
  for (int j0 = 0; j0 < p.n_chunks; j0 += kAAhead) {
#pragma unroll
    for (int u = 0; u < kAAhead; ++u) {
      const int j = j0 + u, g = g0 + j;
      if (j < p.n_chunks) {
        const int s = g % kStages;
        if (g >= kStages) mbar_wait(p.bar(kEmpty + s), ((g - kStages) / kStages) & 1);
        const uint32_t dst = p.aring + s * kABytes;
#pragma unroll
        for (int i = 0; i < kAVecs; ++i) {
          const float4 v = va[u][i];
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + (t + i * 128) * 16), "f"(v.x),
                       "f"(v.y), "f"(v.z), "f"(v.w)
                       : "memory");
        }
        fence_proxy_async();
        mbar_arrive(p.bar(kFull + s));
        if (j + kAAhead < p.n_chunks) load(j + kAAhead, va[u]);
      }
    }
  }
}

// Warpgroup 0 for one hidden layer (chunks g0 ...): this CTA's 64 x 128 block
// of h W into acc, in the wgmma accumulator layout. The tensor cores sum
// each chunk's products from zero into part, which is then added to acc in
// fp32 (round to nearest): summed over the whole k range in the tensor
// cores, whose partial sums are truncated, only 96.6-98.2% of the outputs
// on the shipped weights stayed within 1e-5 of the exact fp32 sums, against
// 99.2-99.6% so. A chunk's slots are released once its group has completed,
// and thread 0 refills the weight slot with chunk g + kStages, across layer
// boundaries.
__device__ __forceinline__ void mma_layer(const Pipe& p, const MlpArgs& a, int g0, float (&acc)[64],
                                          WeightStream& ws) {
  const int lane = threadIdx.x & 31;
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) mbar_arrive(p.bar(kEmpty + g % kStages));
    if (threadIdx.x == 0 && ws.next < p.total) {  // ws.next == g + kStages
      mbar_wait(p.bar(kEmpty + g % kStages), (g / kStages) & 1);
      ws.issue(p, a);
    }
  };
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int j = 0; j < p.n_chunks; ++j) {
    const int g = g0 + j;
    const int s = g % kStages;
    mbar_wait(p.bar(kFull + s), (g / kStages) & 1);
    fence_acc(part);
    wgmma_fence();
    const uint32_t aa = p.aring + s * kABytes, wa = p.wring + s * kWBytes;
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      // 16 k: 32 B of an A row, two B core matrices; each chunk summed from zero
      wgmma_bf16(part, desc_a(aa + k * 32), desc_b(wa + k * 2 * kLBO), k > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(part);
    release(g);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

// h_out <- leaky(acc + bias_s): a bf16 slice (h16) or, after the last hidden
// layer, fp32 rows of stride kActStride (h32). Warp w of warpgroup 0 holds
// rows 16 w + g (+ 8), columns 8 i + 2 t (+ 1).
__device__ __forceinline__ void mma_epilogue(const float (&acc)[64], const float* bias_s, uint8_t* h16, float* h32) {
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));  // computed here: offsets hoisted out of the layer loop would spill
  const int lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * w + g;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bias_s + c);
    const float v0 = leaky(acc[4 * i] + bb.x), v1 = leaky(acc[4 * i + 1] + bb.y);
    const float v2 = leaky(acc[4 * i + 2] + bb.x), v3 = leaky(acc[4 * i + 3] + bb.y);
    if (h16 != nullptr) {
      *reinterpret_cast<__nv_bfloat162*>(h16 + slice_offset(r, c)) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(h16 + slice_offset(r + 8, c)) = __floats2bfloat162_rn(v2, v3);
    } else {
      *reinterpret_cast<float2*>(h32 + r * kActStride + c) = make_float2(v0, v1);
      *reinterpret_cast<float2*>(h32 + (r + 8) * kActStride + c) = make_float2(v2, v3);
    }
  }
}

// This CTA's 128 rows of the last layer's W (k = col0 ..., rows past `width`
// zero), transposed into Wt[n][k], n < kMaxOut (columns past N zero), by
// threads first_thread ... of the CTA.
__device__ __forceinline__ void stage_last_weights_t(const float* __restrict__ W, int width, int col0, int N,
                                                     float* Wt, int first_thread) {
  for (int i = threadIdx.x - first_thread; i < kMaxOut * kSlice; i += kThreads - first_thread) {
    const int n = i / kSlice, k = i % kSlice;
    Wt[i] = n < N && col0 + k < width ? __ldg(W + static_cast<size_t>(col0 + k) * N + n) : 0.f;
  }
}

// Last layer, this CTA's share: partial[r][n] = sum over its 128 k of
// h[r][k] Wt[n][k] (h fp32 with row stride kActStride, Wt from
// stage_last_weights_t). Thread (rows 4 rg ..., columns 4 ng ..., k-quarter
// kq) walks k = 16 m + 4 kq ... in 16-byte reads: 8 reads per 64 FMA, the 8
// lanes of a read phase on distinct banks or one address; the quarters are
// summed with two shuffles. Threads whose columns are all past N do no loads.
__device__ __forceinline__ void last_partial(const float* h, const float* Wt, int N, float* partial) {
  const int t = threadIdx.x;
  const int kq = t & 3, ng = (t >> 3) & 3, rg = 2 * (t >> 5) + ((t >> 2) & 1);
  float s[4][4] = {};
  if (4 * ng < N) {
#pragma unroll 2
    for (int m = 0; m < kSlice / 16; ++m) {
      const int k = 16 * m + 4 * kq;
      float4 hv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hv[i] = *reinterpret_cast<const float4*>(h + (4 * rg + i) * kActStride + k);
        wv[i] = *reinterpret_cast<const float4*>(Wt + (4 * ng + i) * kSlice + k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(hv[i].x, wv[j].x, s[i][j]);
          s[i][j] = fmaf(hv[i].y, wv[j].y, s[i][j]);
          s[i][j] = fmaf(hv[i].z, wv[j].z, s[i][j]);
          s[i][j] = fmaf(hv[i].w, wv[j].w, s[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], 1);
      s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], 2);
    }
  }
  if (kq == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * ng + j < N) partial[(4 * rg + i) * kMaxOut + 4 * ng + j] = s[i][j];
      }
    }
  }
}

// The last layer, by both warpgroups once the fp32 activations (h32) and its
// weights (wlast) are in place: this CTA's partial sums, then after a cluster
// barrier the reduction of the tile's outputs.
__device__ __forceinline__ void finish(const float* h32, const float* wlast, float* partial, const MlpArgs& a,
                                       int cluster, int rank, int row0, int B, float* __restrict__ out) {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  last_partial(h32, wlast, a.out_dim, partial);
  cluster_sync();
  output_reduce(partial, cluster, rank, a.b[a.n_layers - 1], a.out_dim, out, row0, B);
  cluster_sync();  // no CTA leaves while a peer reads its partials
}

__global__ void __launch_bounds__(kThreads, 2) fused_mlp_bf16_kernel(const float* __restrict__ x,
                                                                     float* __restrict__ out, int B, MlpArgs a) {
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* h32 = reinterpret_cast<float*>(smem + kWRingOff);  // fp32 activations before the last layer
  float* aring = reinterpret_cast<float*>(smem + kARingOff);
  uint8_t* act = smem + kActOff;
  float* bias_s = reinterpret_cast<float*>(smem + kBiasOff);

  const int cluster = a.slices;
  const int rank = static_cast<int>(cluster_rank());
  const int row0 = (blockIdx.x / cluster) * kTileRows;
  const int col0 = rank * kSlice;
  const int n_hidden = a.n_layers - 2;
  Pipe p;
  p.wring = smem_addr(smem + kWRingOff);
  p.aring = smem_addr(aring);
  p.bars = smem_addr(smem + kBarOff);
  p.n_chunks = 2 * a.slices;
  p.total = n_hidden * p.n_chunks;
  p.rank = rank;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(p.bar(kFull + s), 128 + 1);  // every thread of warpgroup 1, and the weights' arrive.expect_tx
      mbar_init(p.bar(kEmpty + s), 4);       // lane 0 of each warp of warpgroup 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  WeightStream ws;  // kept by thread 0
  ws.kc = p.kc(0);
  if (threadIdx.x == 0) {  // the first weight chunks stream in while layer 0 runs
    while (ws.next < kStages && ws.next < p.total) ws.issue(p, a);
  }

  input_layer(x, B, row0, a.in_dim, a.w[0], a.b[0], a.width, col0, reinterpret_cast<float*>(act), aring,
              n_hidden > 0 ? act : nullptr, h32);

  // From here on each warpgroup runs its own path to the end, with the
  // registers moved from the staging warpgroup to the one that holds the
  // accumulators (both paths end in finish()).
  const int L = a.n_layers - 1;
  // The last layer's weights go into the A slot of the chunk after the last
  // hidden layer's last (free once chunk total - kStages is consumed; after
  // the first layer alone, slot 0): warpgroup 1 stages them while the final
  // chunks run. Its partial sums go beside the fp32 activations in the
  // weight ring, which is free by then.
  float* wlast = reinterpret_cast<float*>(smem + kARingOff + (p.total % kStages) * kABytes);
  float* partial = h32 + kTileRows * kActStride;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    for (int l = 1; l <= n_hidden; ++l) {
      cluster_sync();  // every slice of this layer's input written
      float acc[64];
      mma_layer(p, a, (l - 1) * p.n_chunks, acc, ws);
      if (l < n_hidden) cluster_sync();  // no peer still reads this CTA's slice of the input
      mma_epilogue(acc, bias_s, l < n_hidden ? act : nullptr, h32);
    }
    finish(h32, wlast, partial, a, cluster, rank, row0, B, out);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kStageRegs));
    for (int l = 1; l <= n_hidden; ++l) {
      cluster_sync();
      stage_layer(p, smem_addr(act), (l - 1) * p.n_chunks, a.b[l], a.width, col0, bias_s);
      if (l < n_hidden) cluster_sync();
    }
    if (p.total >= kStages) mbar_wait(p.bar(kEmpty + p.total % kStages), ((p.total - kStages) / kStages) & 1);
    stage_last_weights_t(a.w[L], a.width, col0, a.out_dim, wlast, 128);
    finish(h32, wlast, partial, a, cluster, rank, row0, B, out);
  }
}

cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_mlp_bf16_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

int ikflow_fused_mlp_bf16_smem_bytes() { return kSmemBytes; }

// How many CTAs fit on an SM (*ctas) and how many clusters of this width's
// shape can be resident at once on the current device (*clusters); returns
// the cudaError_t.
int ikflow_fused_mlp_bf16_occupancy(int width, int* ctas, int* clusters) {
  if (!valid_shape(1, width, 1, 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fused_mlp_bf16_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(kTileRows * 1024, width, kSmemBytes, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, (const void*)fused_mlp_bf16_kernel, &cfg));
}

// x (B, in_dim), out (B, out_dim), w[l] (K_l, N_l) and b[l] (N_l,) fp32, and,
// for the hidden layers 0 < l < n_layers - 1, wp[l] (their packed bf16
// weights, P * P values for P = width rounded up to a multiple of 128), all
// contiguous on the current device, 16-byte aligned; hidden widths equal
// `width`, a multiple of 4 up to 1024; in_dim <= width, out_dim <= 16.
// Launches on `stream` and returns the launch's cudaError_t.
int ikflow_fused_mlp_bf16(const float* x, float* out, int B, int in_dim, int width, int out_dim, int n_layers,
                          const float* const* w, const void* const* wp, const float* const* b, void* stream) {
  if (B <= 0 || !valid_shape(in_dim, width, out_dim, n_layers)) return static_cast<int>(cudaErrorInvalidValue);
  MlpArgs a;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool used = l < n_layers;
    const bool hidden = used && l > 0 && l < n_layers - 1;
    if (hidden && wp[l] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.w[l] = used ? w[l] : nullptr;
    a.wp[l] = hidden ? static_cast<const __nv_bfloat16*>(wp[l]) : nullptr;
    a.b[l] = used ? b[l] : nullptr;
  }
  a.n_layers = n_layers;
  a.in_dim = in_dim;
  a.width = width;
  a.slices = slices_of(width);
  a.out_dim = out_dim;
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, width, kSmemBytes, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, fused_mlp_bf16_kernel, x, out, B, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ikflow_bf16_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
