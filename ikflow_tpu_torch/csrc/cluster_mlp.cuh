// Device helpers shared by the two subnet-MLP kernels, K1 (fused_mlp.cu) and
// K1' (fused_mlp_bf16.cu), for Hopper (sm_90a): both split a 64-row tile by
// columns over a thread-block cluster of width / 128 CTAs, run the hidden
// layers on wgmma from shared memory, and reduce the fp32 last layer's
// per-CTA partial sums the same way.
//
// Here: the shape both share, shared-memory and cluster addressing (mapa,
// ld.shared::cluster, barrier.cluster), the wgmma descriptors and fences, the
// reduction of the partial sums in rank order, and the launch shape.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // two warpgroups: 0 issues the wgmma, 1 stages the operands
constexpr int kTileRows = 64;  // rows per cluster = the wgmma M
constexpr int kSlice = 128;    // hidden-layer output columns per CTA
constexpr int kMaxLayers = 5;
constexpr int kInChunk = 64;  // k per staged chunk of the first layer
constexpr int kMaxOut = 16;
constexpr int kMaxCluster = 8;  // portable cluster size: widths up to 1024
constexpr int kActStride = kSlice + 4;  // fp32 activation rows, padded against bank conflicts
constexpr float kLeakySlope = 0.01f;

// wgmma K-major B operand, unswizzled: an 8-row x 16-byte core matrix is 128
// contiguous bytes; the core matrices of an 8-row group follow each other
// along K (LBO = 128 B) and the groups follow each other (SBO). Both kernels
// pack their weights so that a 128-column chunk of 32 tf32 / 64 bf16 rows is
// 8 core matrices deep: SBO = 8 * 128 B.
constexpr int kLBO = 128;
constexpr int kSBO = 8 * 128;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kLeakySlope * v; }

__device__ __forceinline__ void fma4(float* acc, float h, const float4& w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA in the cluster: writes before it (shared memory
// included) are visible to reads after it, in every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of the same offset in CTA `rank`'s shared memory.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes from a peer's shared memory, bit for bit (no arithmetic on them).
__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Shared-memory matrix descriptors, K-major. B: unswizzled core matrices
// (kLBO between K neighbours, kSBO between 8-row groups). A: 128-byte
// swizzle, 128-byte rows in 8-row atoms of 1024 B (SBO); a k-step advances
// the start address by 32 B inside the atom.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Byte offset of (row, 16-byte unit c16) in a 128-byte-swizzled A operand:
// 128-byte rows in 8-row atoms, unit c16 stored at c16 ^ (row % 8).
__device__ __forceinline__ int a_offset(int row, int c16) {
  return (row >> 3) * 1024 + (row & 7) * 128 + ((c16 ^ (row & 7)) << 4);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory (plain stores) made visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that own them.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// out[row0 + r][n] = sum over the cluster's CTAs, in rank order, of their
// partials, plus b[n], for this CTA's rows r % cluster == rank.
__device__ void output_reduce(const float* partial, int cluster, int rank, const float* __restrict__ bias, int N,
                              float* __restrict__ out, int row0, int B) {
  const uint32_t base = smem_addr(partial);
  for (int e = threadIdx.x; e < kTileRows * N; e += kThreads) {
    const int r = e / N, n = e - r * N;
    if (r % cluster != rank || row0 + r >= B) continue;
    float s = 0.f;
    for (int c = 0; c < cluster; ++c) {
      s += ld_peer(peer_addr(base + (r * kMaxOut + n) * static_cast<int>(sizeof(float)), static_cast<uint32_t>(c)));
    }
    out[static_cast<size_t>(row0 + r) * N + n] = s + __ldg(bias + n);
  }
}

bool valid_shape(int in_dim, int width, int out_dim, int n_layers) {
  return n_layers >= 2 && n_layers <= kMaxLayers && out_dim >= 1 && out_dim <= kMaxOut && width % 4 == 0 &&
         width >= 4 && width <= kMaxCluster * kSlice && in_dim >= 1 && in_dim <= width;
}

int slices_of(int width) { return (width + kSlice - 1) / kSlice; }

// One cluster of slices_of(width) CTAs per 64-row tile.
cudaLaunchConfig_t launch_config(int B, int width, int smem_bytes, cudaStream_t stream, cudaLaunchAttribute* attr) {
  const int cluster = slices_of(width);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + kTileRows - 1) / kTileRows * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace
