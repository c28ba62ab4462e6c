// Shared pieces of the two flash-attention backward kernels (flash_dq.cu,
// flash_dkv.cu): the tile geometry, tile staging and the recompute of p and
// dlogits from the forward's lse.
//
// Both kernels run 128 threads (4 warps) over 32 x 32 (query x key) tiles,
// with four float32 tiles of 32 rows x (hd + 4) in dynamic shared memory:
// 67.6 KB at hd = 128, above the 48 KB static limit, so each kernel opts in
// to more once per device (SmemOptIn).  The row padding of 4 floats
// keeps the row-per-lane float4 reads free of bank conflicts.
#pragma once

#include "common.cuh"

namespace repro {
namespace flash_bwd {

constexpr int kT = 32;                // query rows per tile and keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = kT / kWarps;  // rows (dq) or keys (dk/dv) each warp owns

inline size_t smem_bytes(int hd) { return (size_t)4 * kT * (hd + 4) * sizeof(float); }

// Stage rows [row0, row0 + kT) of a (rows, row_stride) array of T into a
// kT x (HD + 4) float32 tile; rows at or past n_rows become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const T* __restrict__ src,
                                           int row0, int n_rows, size_t row_stride) {
  constexpr int LD = HD + 4;
  constexpr int VEC = Vec16<T>::n;
  for (int e = threadIdx.x * VEC; e < kT * HD; e += kThreads * VEC) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    float buf[VEC];
    if (row < n_rows) {
      load16<T>(src + (size_t)row * row_stride + d, buf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) buf[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + r * LD + d + i) =
          make_float4(buf[i], buf[i + 1], buf[i + 2], buf[i + 3]);
  }
}

// _recompute_dlogits of the reference for one (query row, key) pair: s is
// the raw q.k dot, dp the dO.v dot.  Scale, then the tanh softcap BEFORE
// the mask; p is forced to 0 where the mask is false (exp of a masked logit
// is never taken), dlogits = p (dp - delta), times (1 - tanh^2) under a cap.
__device__ __forceinline__ void recompute(float s, float dp, float lse, float delta, bool ok,
                                          float scale, float softcap, float& p, float& ds) {
  float x = s * scale;
  float capped = 0.f;
  if (softcap > 0.f) {
    capped = tanhf(x / softcap);
    x = capped * softcap;
  }
  p = ok ? expf(x - lse) : 0.f;
  ds = p * (dp - delta);
  if (softcap > 0.f) ds *= 1.f - capped * capped;
}

// Causal, sliding-window mask on absolute positions (= indices here).
__device__ __forceinline__ bool attend(int row, int key, int S, int window) {
  const int rel = row - key;
  return row < S && key < S && rel >= 0 && (window <= 0 || rel < window);
}

}  // namespace flash_bwd
}  // namespace repro
