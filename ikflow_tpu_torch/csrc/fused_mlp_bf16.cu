// Fused coupling-subnet MLP with bf16 hidden layers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ikflow_tpu/flow/pallas_subnet.py::fused_mlp
// with bf16_hidden=True (pallas_call at :97, body _mlp_kernel at :42-59). For
// a tile of rows it computes h <- x, then per layer h <- h W_l + b_l, with
// LeakyReLU(0.01) after all but the last. The layers 0 < l < n-1 (the
// width x width ones) take bf16 inputs and bf16 weights with fp32
// accumulation; the first and the last layer, the biases, the activation and
// the output stay fp32. As on the TPU, no (B, width) activation ever goes to
// device memory.
//
// What bounds it: the two 1024 x 1024 layers are ~99% of the arithmetic,
// 2 * B * 2 * 1024^2 bf16 FLOP, which the tensor cores run at 989 TFLOP/s;
// the narrow first and last layers add 2 * B * (in + out) * 1024 fp32 FLOP
// at 67 TFLOP/s. Against 4.3 MB of weights (bf16 hidden, fp32 first/last)
// the kernel is bound by operations above a few hundred rows, by bytes below.
//
// Design (a simple correct version; wgmma and TMA are later work):
// - A block owns kTileRows = 32 rows and 8 warps. Its activations stay in
//   shared memory: a bf16 buffer A (32 x width) and an fp32 buffer F
//   (32 x width) whose first half doubles as a second bf16 buffer B. The
//   first layer writes bf16 into A or B, chosen so that the last bf16 layer
//   reads A and writes its fp32 output into F without overlapping its input.
//   Rows are padded by 8 elements, so ldmatrix and the epilogue stores hit
//   distinct banks. 32 x 1032 x (2 + 4) bytes = 198 KB, hence the dynamic
//   shared-memory opt-in and one block per SM.
// - Layer 0 (K = in <= 64) is fp32 FFMA: a thread owns 4 columns and runs
//   over 16 rows at a time, with the input tile broadcast from shared memory.
// - A bf16 layer is mma.sync.m16n8k16 (bf16 x bf16 -> fp32). A warp owns
//   64 output columns (8 n-tiles) of all 32 rows (2 m-tiles): 64 fp32
//   accumulators per thread. A fragments come from shared memory through
//   ldmatrix.x4; B fragments come from global memory (the weights sit in the
//   50 MB L2), pre-packed once per parameter set into the fragment order
//   (flow/fused_subnet.py::pack_bf16_weight) so that each lane reads one
//   8-byte word per n-tile and k-step, a warp 256 contiguous bytes; the next
//   k-step's fragments are prefetched into registers. The epilogue adds the
//   bias, applies the LeakyReLU and rounds to bf16 with round-to-nearest-even
//   (__floats2bfloat162_rn, as torch .to(bfloat16) and jnp.astype), or, for
//   the last bf16 layer, stores fp32.
// - The narrow last layer (out <= 16) is fp32: split over k across the 32
//   lanes of a warp and reduced with shuffles, as in fused_mlp.cu.
// - The ragged last tile: rows past B are zero on load and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileRows = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 5;
constexpr int kMaxIn = 64;
constexpr int kMaxOut = 16;
constexpr int kMaxWidth = 1024;
constexpr int kPad = 8;         // elements of padding per activation row
constexpr int kWarpNTiles = 8;  // n-tiles of 8 columns a warp owns per pass
constexpr float kLeakySlope = 0.01f;

struct MlpArgs {
  const float* w[kMaxLayers];   // fp32 (K, N): read for the first and the last layer
  const uint2* wp[kMaxLayers];  // packed bf16 fragments: read for 0 < l < n-1
  const float* b[kMaxLayers];
  int n_layers;
  int in_dim;
  int width;
  int out_dim;
};

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kLeakySlope * v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void fma4(float* acc, float h, const float4& w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

// Layer 0: out[r][c] = leaky(sum_k x_s[r][k] W[k][c] + b[c]) for all kTileRows
// rows, c < N (N % 4 == 0), in fp32; stored as bf16 (kBf16Out) or fp32.
template <bool kBf16Out>
__device__ void input_layer(const float* __restrict__ x_s, int x_stride, const float* __restrict__ W,
                            const float* __restrict__ bias, int K, int N, void* out, int out_stride) {
  for (int c = threadIdx.x * 4; c < N; c += kThreads * 4) {
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + c));
    for (int r0 = 0; r0 < kTileRows; r0 += 16) {
      float acc[16][4];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * N + c));
#pragma unroll
        for (int r = 0; r < 16; ++r) fma4(acc[r], x_s[(r0 + r) * x_stride + k], w);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float v0 = leaky(acc[r][0] + bb.x), v1 = leaky(acc[r][1] + bb.y);
        const float v2 = leaky(acc[r][2] + bb.z), v3 = leaky(acc[r][3] + bb.w);
        const int off = (r0 + r) * out_stride + c;
        if (kBf16Out) {
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off);
          o[0] = __floats2bfloat162_rn(v0, v1);
          o[1] = __floats2bfloat162_rn(v2, v3);
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = make_float4(v0, v1, v2, v3);
        }
      }
    }
  }
}

__device__ __forceinline__ void load_b(uint2 (&b)[kWarpNTiles], const uint2* __restrict__ Wp, int nt0, int kt,
                                       int n_tiles, int k_tiles, int lane) {
#pragma unroll
  for (int j = 0; j < kWarpNTiles; ++j) {
    b[j] = nt0 + j < n_tiles ? __ldg(Wp + (static_cast<size_t>(nt0 + j) * k_tiles + kt) * 32 + lane)
                             : make_uint2(0u, 0u);
  }
}

// A bf16 layer: out[r][c] = leaky(sum_k A_s[r][k] Wp[k][c] + b[c]), K % 16 == 0,
// N % 8 == 0, products of bf16 summed in fp32 on the tensor cores; stored as
// bf16 (kBf16Out, rounded to nearest even) or fp32.
template <bool kBf16Out>
__device__ void mma_layer(const __nv_bfloat16* A_s, int lda, const uint2* __restrict__ Wp,
                          const float* __restrict__ bias, int K, int N, void* out, int ldo) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = N / 8;
  const int k_tiles = K / 16;
  // ldmatrix.x4 of a 16x16 tile: lanes 0-15 address rows 0-15 at column 0,
  // lanes 16-31 the same rows at column 8.
  const uint32_t a_addr0 = smem_addr(A_s + (lane % 16) * lda + (lane / 16) * 8);
  const uint32_t a_addr1 = a_addr0 + 16 * lda * static_cast<uint32_t>(sizeof(__nv_bfloat16));
  for (int nt0 = warp * kWarpNTiles; nt0 < n_tiles; nt0 += kWarps * kWarpNTiles) {
    float acc[2][kWarpNTiles][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int j = 0; j < kWarpNTiles; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    }
    uint2 b[kWarpNTiles];
    load_b(b, Wp, nt0, 0, n_tiles, k_tiles, lane);
    for (int kt = 0; kt < k_tiles; ++kt) {
      uint2 b_next[kWarpNTiles];
      load_b(b_next, Wp, nt0, kt + 1 < k_tiles ? kt + 1 : kt, n_tiles, k_tiles, lane);
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, a_addr0 + kt * 32);  // 16 bf16 = 32 bytes per k-step
      ldmatrix_x4(a1, a_addr1 + kt * 32);
#pragma unroll
      for (int j = 0; j < kWarpNTiles; ++j) {
        if (nt0 + j < n_tiles) {
          mma_bf16(acc[0][j], a0, b[j]);
          mma_bf16(acc[1][j], a1, b[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kWarpNTiles; ++j) b[j] = b_next[j];
    }
    // Accumulator fragment: d0, d1 at row g, columns 2t and 2t+1; d2, d3 at row g+8.
#pragma unroll
    for (int j = 0; j < kWarpNTiles; ++j) {
      if (nt0 + j >= n_tiles) continue;
      const int col = (nt0 + j) * 8 + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = m * 16 + g;
        const float v0 = leaky(acc[m][j][0] + bb.x), v1 = leaky(acc[m][j][1] + bb.y);
        const float v2 = leaky(acc[m][j][2] + bb.x), v3 = leaky(acc[m][j][3] + bb.y);
        if (kBf16Out) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
          *reinterpret_cast<__nv_bfloat162*>(o + r * ldo + col) = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(o + (r + 8) * ldo + col) = __floats2bfloat162_rn(v2, v3);
        } else {
          float* o = static_cast<float*>(out);
          *reinterpret_cast<float2*>(o + r * ldo + col) = make_float2(v0, v1);
          *reinterpret_cast<float2*>(o + (r + 8) * ldo + col) = make_float2(v2, v3);
        }
      }
    }
  }
}

// out[row0 + r][n] = sum_k h_in[r][k] W[k][n] + b[n] for n < N <= kMaxOut, rows < B, in fp32.
__device__ void output_layer(const float* __restrict__ h_in, int stride, const float* __restrict__ W,
                             const float* __restrict__ bias, int K, int N, float* __restrict__ out, int row0,
                             int B) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kTileRows; r += kWarps) {
    float part[kMaxOut];
#pragma unroll
    for (int n = 0; n < kMaxOut; ++n) part[n] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float h = h_in[r * stride + k];
      const float* wk = W + static_cast<size_t>(k) * N;
#pragma unroll
      for (int n = 0; n < kMaxOut; ++n) {
        if (n < N) part[n] = fmaf(h, __ldg(wk + n), part[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxOut; ++n) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part[n] += __shfl_xor_sync(0xffffffffu, part[n], off);
    }
    if (lane == 0 && row0 + r < B) {
#pragma unroll
      for (int n = 0; n < kMaxOut; ++n) {
        if (n < N) out[static_cast<size_t>(row0 + r) * N + n] = part[n] + __ldg(bias + n);
      }
    }
  }
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ constexpr int smem_bytes(int width, int in_dim) {
  return kTileRows * (width + kPad) * (static_cast<int>(sizeof(__nv_bfloat16)) + static_cast<int>(sizeof(float))) +
         kTileRows * round4(in_dim) * static_cast<int>(sizeof(float));
}

__global__ void __launch_bounds__(kThreads) fused_mlp_bf16_kernel(const float* __restrict__ x,
                                                                  float* __restrict__ out, int B, MlpArgs a) {
  extern __shared__ float4 smem4[];
  const int stride = a.width + kPad;  // row stride of every activation buffer, in elements
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* buf_f = reinterpret_cast<float*>(buf_a + kTileRows * stride);
  __nv_bfloat16* buf_b = reinterpret_cast<__nv_bfloat16*>(buf_f);  // aliases the first half of F
  float* x_s = buf_f + kTileRows * stride;
  const int row0 = blockIdx.x * kTileRows;

  const int in4 = round4(a.in_dim);
  for (int i = threadIdx.x; i < kTileRows * in4; i += kThreads) {
    const int r = i / in4;
    const int k = i - r * in4;
    x_s[i] = (row0 + r < B && k < a.in_dim) ? x[static_cast<size_t>(row0 + r) * a.in_dim + k] : 0.f;
  }
  __syncthreads();

  const int last = a.n_layers - 1;
  const int n_bf16 = a.n_layers - 2;  // layers 1 .. n-2
  if (n_bf16 == 0) {
    input_layer<false>(x_s, in4, a.w[0], a.b[0], a.in_dim, a.width, buf_f, stride);
  } else {
    // Ping-pong A/B so that the last bf16 layer reads A: its fp32 output in F
    // then overwrites only B, which is no longer needed.
    __nv_bfloat16* h_in = (n_bf16 % 2) ? buf_a : buf_b;
    __nv_bfloat16* h_out = (n_bf16 % 2) ? buf_b : buf_a;
    input_layer<true>(x_s, in4, a.w[0], a.b[0], a.in_dim, a.width, h_in, stride);
    __syncthreads();
    for (int l = 1; l < last - 1; ++l) {
      mma_layer<true>(h_in, stride, a.wp[l], a.b[l], a.width, a.width, h_out, stride);
      __syncthreads();
      __nv_bfloat16* tmp = h_in;
      h_in = h_out;
      h_out = tmp;
    }
    mma_layer<false>(h_in, stride, a.wp[last - 1], a.b[last - 1], a.width, a.width, buf_f, stride);
  }
  __syncthreads();
  output_layer(buf_f, stride, a.w[last], a.b[last], a.width, a.out_dim, out, row0, B);
}

}  // namespace

extern "C" {

int ikflow_fused_mlp_bf16_tile_rows() { return kTileRows; }

int ikflow_fused_mlp_bf16_smem_bytes(int width, int in_dim) { return smem_bytes(width, in_dim); }

// x (B, in_dim), out (B, out_dim), w[l] (K_l, N_l) fp32 for l = 0 and l = n-1,
// wp[l] the packed bf16 weights of the hidden layers 0 < l < n-1, b[l] (N_l,)
// fp32; all contiguous on the current device, hidden widths equal `width`.
// Launches on `stream` and returns the launch's cudaError_t.
int ikflow_fused_mlp_bf16(const float* x, float* out, int B, int in_dim, int width, int out_dim, int n_layers,
                          const float* const* w, const void* const* wp, const float* const* b, void* stream) {
  if (B <= 0 || n_layers < 2 || n_layers > kMaxLayers || out_dim < 1 || out_dim > kMaxOut || width % 16 != 0 ||
      width < 16 || width > kMaxWidth || in_dim < 1 || in_dim > kMaxIn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MlpArgs a;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool used = l < n_layers;
    const bool hidden = used && l > 0 && l < n_layers - 1;
    if (hidden && wp[l] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.w[l] = used ? w[l] : nullptr;
    a.wp[l] = hidden ? static_cast<const uint2*>(wp[l]) : nullptr;
    a.b[l] = used ? b[l] : nullptr;
  }
  a.n_layers = n_layers;
  a.in_dim = in_dim;
  a.width = width;
  a.out_dim = out_dim;
  const int smem = smem_bytes(width, in_dim);
  cudaError_t err =
      cudaFuncSetAttribute(fused_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + kTileRows - 1) / kTileRows;
  fused_mlp_bf16_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, out, B, a);
  return static_cast<int>(cudaGetLastError());
}

const char* ikflow_bf16_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
