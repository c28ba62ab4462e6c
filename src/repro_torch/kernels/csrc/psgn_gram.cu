// Per-sample gradient squared norms of a dense layer, GRAM factorisation,
// for Hopper (sm_90a):
//
//   out[b] = sum_{t,t'} (x_t . x_t') (d_t . d_t')  ==  ||X_b^T D_b||_F^2
//
// Replaces: _gram_kernel (psgn_gram) in repro/kernels/psgn.py.
//
//   X: (B, S, Din), D: (B, S, Dout), float32 or bfloat16 each.
//
// Grid: one block per (128 x 128 tile pair of sequence positions, b).  The
// block forms Gx = X_i X_j^T and Gd = D_i D_j^T, each contracted over its
// whole feature width 8 features per shared-memory stage (the next stage
// prefetched into registers), both 128 x 128 tiles held in float32
// registers, 8 x 8 of each per thread, and reduces sum(Gx * Gd) to one
// partial.  Both Gram matrices are symmetric, so only the tile pairs i <= j
// run and an off-diagonal pair counts twice (an exact doubling): the same
// value at half the work of the TPU kernel's full (S/bi, S/bj) grid.  The
// TPU grid's cross-block sum becomes a second pass (psgn_tile.cuh) that sums
// each sample's partials in a fixed order: no float atomics, the same bits
// on every run.  Ragged S and widths are masked at the stage loads (zeros),
// never padded in memory.
//
// What bounds it on the H100: FLOPs, 2 * S^2 * (Din + Dout) per sample for
// the full Gram product (half of it with the symmetry).  This first version
// runs them on the float32 FMA pipes (67 TFLOP/s peak), not the tensor
// cores; wgmma tiles are a later step.

#include "psgn_tile.cuh"

namespace repro {
namespace {

using namespace psgn;

// acc += base[rows i0.., :] base[rows j0.., :]^T over all D features.  A
// stage holds 8 features of 128 positions, transposed to feature-major; a
// warp reads 4 positions x 8 neighbouring features.
template <typename T>
__device__ __forceinline__ void gram_tile(const T* __restrict__ base, int S, int D, int i0,
                                          int j0, Stage& si, Stage& sj, int tid,
                                          float (&acc)[8][8]) {
  float pi[kPerThread], pj[kPerThread];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = tid + r * kThreads, kk = e % kK, row = e / kK;
      const bool k_ok = k0 + kk < D;
      pi[r] = (k_ok && i0 + row < S) ? to_f(base[(size_t)(i0 + row) * D + k0 + kk]) : 0.0f;
      pj[r] = (k_ok && j0 + row < S) ? to_f(base[(size_t)(j0 + row) * D + k0 + kk]) : 0.0f;
    }
  };
  const int ty = tid >> 4, tx = tid & 15;
  load(0);
  for (int k0 = 0; k0 < D; k0 += kK) {
    __syncthreads();  // every thread is done with the previous stage
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = tid + r * kThreads;
      si.v[e % kK][e / kK] = pi[r];
      sj.v[e % kK][e / kK] = pj[r];
    }
    __syncthreads();
    if (k0 + kK < D) load(k0 + kK);
    stage_product(si, sj, ty, tx, acc);
  }
}

template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads, 1)
psgn_gram_kernel(const TX* __restrict__ x, const TD* __restrict__ d,
                 float* __restrict__ partials, int S, int Din, int Dout, int nT, int n_pairs) {
  __shared__ __align__(16) Stage si;
  __shared__ __align__(16) Stage sj;

  // pair p -> (ti, tj), ti <= tj, row-major over the upper triangle
  int ti = 0, p = blockIdx.x;
  while (p >= nT - ti) {
    p -= nT - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  float gx[8][8], gd[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) gx[r][c] = gd[r][c] = 0.0f;

  gram_tile(x + (size_t)b * S * Din, S, Din, ti * kTile, tj * kTile, si, sj, tid, gx);
  gram_tile(d + (size_t)b * S * Dout, S, Dout, ti * kTile, tj * kTile, si, sj, tid, gd);

  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) v = fmaf(gx[r][c], gd[r][c], v);
  const float total = block_sum(v);
  if (tid == 0)
    partials[(size_t)b * n_pairs + blockIdx.x] = (ti == tj ? 1.0f : 2.0f) * total;
}

template <typename TX, typename TD>
int launch(const void* x, const void* d, float* partials, float* out, int B, int S, int Din,
           int Dout, int nT, int n_pairs, cudaStream_t stream) {
  const dim3 grid(n_pairs, B);
  psgn_gram_kernel<TX, TD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(d), partials, S, Din, Dout, nT,
      n_pairs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(partials, out, B, n_pairs, stream);
}

template <typename TX>
int dispatch_d(int d_dtype, const void* x, const void* d, float* partials, float* out, int B,
               int S, int Din, int Dout, int nT, int n_pairs, cudaStream_t stream) {
  if (d_dtype == kFloat32)
    return launch<TX, float>(x, d, partials, out, B, S, Din, Dout, nT, n_pairs, stream);
  if (d_dtype == kBFloat16)
    return launch<TX, __nv_bfloat16>(x, d, partials, out, B, S, Din, Dout, nT, n_pairs,
                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// x: (B, S, Din), delta: (B, S, Dout), contiguous; dtype codes 0 float32, 1
// bfloat16, each on its own.  partials: (B, n_partials) float32 scratch with
// n_partials = nT * (nT + 1) / 2, nT = ceil(S / 128); out: (B,) float32.
// Two launches on `stream` (tile pairs, then the per-sample sum).  Returns
// the cudaError_t (0 on success).
extern "C" int psgn_gram_fwd(int x_dtype, int d_dtype, const void* x, const void* delta,
                             void* partials, void* out, int B, int S, int Din, int Dout,
                             int n_partials, void* stream) {
  using namespace repro;
  if (B < 1 || S < 1 || Din < 1 || Dout < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nT = (S + psgn::kTile - 1) / psgn::kTile;
  const long long n_pairs = (long long)nT * (nT + 1) / 2;
  if (n_pairs > 0x7fffffffLL || n_partials != n_pairs)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  if (x_dtype == kFloat32)
    return dispatch_d<float>(d_dtype, x, delta, p, o, B, S, Din, Dout, nT, n_partials, s);
  if (x_dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(d_dtype, x, delta, p, o, B, S, Din, Dout, nT,
                                     n_partials, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* psgn_gram_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
