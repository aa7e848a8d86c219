// Fused coupling-subnet MLP, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ikflow_tpu/flow/pallas_subnet.py::fused_mlp
// (pallas_call at :97, body _mlp_kernel at :42-59). It computes, for a tile of
// rows, h <- x, then h <- h W_l + b_l for every layer, with LeakyReLU(0.01)
// after all but the last, in one launch. As on the TPU, no (B, width)
// activation ever goes to device memory.
//
// What bounds it: the two width x width layers are ~99% of the arithmetic,
// 2 * B * (in*W + 2*W^2 + W*out) FLOP, about 4.2 MFLOP per row at W = 1024.
// At B = 10000 that is 42 GFLOP against 8.4 MB of weights, so the kernel is
// bound by fp32 operations (no TF32: the flow's outputs seed 1 mm IK).
//
// Design: a block owns kTileRows rows. Their activations stay in shared
// memory, ping-ponging between two buffers of kTileRows x width floats
// (2 x 64 KB at width 1024, hence the dynamic shared-memory opt-in). A
// 4 MB weight matrix cannot stay on chip, so each block streams the weights
// row by row from global memory, where they sit in the 50 MB L2: in a hidden
// layer each thread owns 4 adjacent output columns of every row of the tile,
// so one row of W is read once per tile as one coalesced float4 per thread,
// the next 4 rows are prefetched into registers while the current 4 are used,
// and every weight read feeds kTileRows FMAs. The activation operand is a
// shared-memory broadcast. The narrow output layer (2 x split columns) is
// instead split over k across the 32 lanes of a warp and reduced with
// shuffles. The ragged last tile is handled by masks: rows past B are zero on
// load and never stored. Sums over k run in order, as a plain loop would.
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 16;
constexpr int kThreads = 256;
constexpr int kMaxLayers = 5;
constexpr int kMaxOut = 16;
constexpr float kLeakySlope = 0.01f;

struct MlpArgs {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int n_layers;
  int in_dim;
  int width;
  int out_dim;
};

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kLeakySlope * v; }

__device__ __forceinline__ float4 load_w4(const float* __restrict__ W, int k, int K, int N, int c) {
  return k < K ? __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * N + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma4(float* acc, float h, const float4& w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

// h_out[r][c] = leaky(sum_k h_in[r][k] W[k][c] + b[c]), c < N (N % 4 == 0).
// h_in holds zeros in columns K .. roundup(K, 4) - 1.
__device__ void hidden_layer(const float* __restrict__ h_in, float* __restrict__ h_out, int stride,
                             const float* __restrict__ W, const float* __restrict__ bias, int K, int N) {
  for (int c = threadIdx.x * 4; c < N; c += kThreads * 4) {
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + c));
    float acc[kTileRows][4];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      acc[r][0] = bb.x;
      acc[r][1] = bb.y;
      acc[r][2] = bb.z;
      acc[r][3] = bb.w;
    }
    float4 nxt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nxt[j] = load_w4(W, j, K, N, c);
    for (int k0 = 0; k0 < K; k0 += 4) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = nxt[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) nxt[j] = load_w4(W, k0 + 4 + j, K, N, c);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(h_in + r * stride + k0);
        fma4(acc[r], h.x, w[0]);
        fma4(acc[r], h.y, w[1]);
        fma4(acc[r], h.z, w[2]);
        fma4(acc[r], h.w, w[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      *reinterpret_cast<float4*>(h_out + r * stride + c) =
          make_float4(leaky(acc[r][0]), leaky(acc[r][1]), leaky(acc[r][2]), leaky(acc[r][3]));
    }
  }
}

// out[row0 + r][n] = sum_k h_in[r][k] W[k][n] + b[n] for n < N <= kMaxOut, rows < B.
__device__ void output_layer(const float* __restrict__ h_in, int stride, const float* __restrict__ W,
                             const float* __restrict__ bias, int K, int N, float* __restrict__ out,
                             int row0, int B) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kTileRows; r += kThreads / 32) {
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

__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const float* __restrict__ x,
                                                             float* __restrict__ out, int B, MlpArgs a) {
  extern __shared__ float4 smem4[];
  const int stride = a.width;
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + kTileRows * stride;
  const int row0 = blockIdx.x * kTileRows;

  const int in4 = (a.in_dim + 3) & ~3;
  for (int i = threadIdx.x; i < kTileRows * in4; i += kThreads) {
    const int r = i / in4;
    const int k = i - r * in4;
    buf0[r * stride + k] =
        (row0 + r < B && k < a.in_dim) ? x[static_cast<size_t>(row0 + r) * a.in_dim + k] : 0.f;
  }
  __syncthreads();

  float* h_in = buf0;
  float* h_out = buf1;
  int K = a.in_dim;
  for (int l = 0; l < a.n_layers - 1; ++l) {
    hidden_layer(h_in, h_out, stride, a.w[l], a.b[l], K, a.width);
    __syncthreads();
    float* t = h_in;
    h_in = h_out;
    h_out = t;
    K = a.width;
  }
  output_layer(h_in, stride, a.w[a.n_layers - 1], a.b[a.n_layers - 1], K, a.out_dim, out, row0, B);
}

}  // namespace

extern "C" {

int ikflow_fused_mlp_tile_rows() { return kTileRows; }

// x (B, in_dim), out (B, out_dim), w[l] (K_l, N_l) and b[l] (N_l,), all
// contiguous fp32 on the current device; hidden widths equal `width`.
// Launches on `stream` and returns the launch's cudaError_t.
int ikflow_fused_mlp(const float* x, float* out, int B, int in_dim, int width, int out_dim, int n_layers,
                     const float* const* w, const float* const* b, void* stream) {
  if (B <= 0 || n_layers < 2 || n_layers > kMaxLayers || out_dim < 1 || out_dim > kMaxOut ||
      width % 4 != 0 || in_dim < 1 || in_dim > width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MlpArgs a;
  for (int l = 0; l < kMaxLayers; ++l) {
    a.w[l] = l < n_layers ? w[l] : nullptr;
    a.b[l] = l < n_layers ? b[l] : nullptr;
  }
  a.n_layers = n_layers;
  a.in_dim = in_dim;
  a.width = width;
  a.out_dim = out_dim;
  const int smem = 2 * kTileRows * width * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + kTileRows - 1) / kTileRows;
  fused_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, out, B, a);
  return static_cast<int>(cudaGetLastError());
}

const char* ikflow_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
