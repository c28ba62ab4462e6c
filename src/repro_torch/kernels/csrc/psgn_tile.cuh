// Shared pieces of the per-sample gradient-norm kernels (psgn_direct.cu,
// psgn_gram.cu): the 128 x 128 register-tiled float32 product, the block sum
// and the fixed-order pass that sums each sample's partials.
#pragma once

#include "common.cuh"

namespace repro {
namespace psgn {

// A block owns a kTile x kTile tile of a product and contracts it kK deep
// per shared-memory stage.  kTile must match TILE in kernels/psgn.py, which
// sizes the partials.
constexpr int kTile = 128;
constexpr int kK = 8;
constexpr int kThreads = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kTile + 4;         // padded row of a stage (16-byte rows)
constexpr int kPerThread = kK * kTile / kThreads;  // staged elements per thread

// One stage: kK contraction rows of the tile's kTile columns, float32.
struct Stage {
  float v[kK][kLd];
};

// acc[r][c] += sum_k a.v[k][row r] * b.v[k][col c] over one stage.  Thread
// (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, and the same
// columns of tx: two float4 reads per operand and step, no bank conflicts.
__device__ __forceinline__ void stage_product(const Stage& a, const Stage& b, int ty, int tx,
                                              float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float ra[8], rb[8];
    const float4 a0 = *reinterpret_cast<const float4*>(&a.v[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a.v[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b.v[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b.v[k][64 + tx * 4]);
    ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
    ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
    rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
    rb[4] = b1.x; rb[5] = b1.y; rb[6] = b1.z; rb[7] = b1.w;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ra[r], rb[c], acc[r][c]);
  }
}

// The block's sum of v, valid on thread 0; warps, then warp sums in order.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// out[b] = sum of partials[b, :n], one block per sample, in a fixed order:
// the same inputs give the same bits on every run (no atomics).
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out, int n) {
  const float* row = partials + (size_t)blockIdx.x * n;
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) v += row[i];
  const float total = block_sum(v);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

inline int sum_partials(const float* partials, float* out, int B, int n, cudaStream_t stream) {
  sum_partials_kernel<<<B, kThreads, 0, stream>>>(partials, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace psgn
}  // namespace repro
