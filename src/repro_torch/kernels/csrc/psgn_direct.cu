// Per-sample gradient squared norms of dense layers, DIRECT factorisation,
// for Hopper (sm_90a): out[b] = sum_l ||X_lb^T D_lb||_F^2 over L stacked
// same-shape layers.  L = 1 is psgn_direct; L > 1 is psgn_fused.
//
// Replaces: _direct_kernel (psgn_direct) and _fused_kernel (psgn_fused) in
// repro/kernels/psgn.py.
//
//   X: (L, B, S, Din), D: (L, B, S, Dout), float32 or bfloat16 each;
//   G_lb = X_lb^T D_lb is (Din, Dout) and never leaves the block that owns it.
//
// Grid: one block per (Dout tile, Din tile, l * B + b) of 128 x 128.  The
// TPU kernels keep the tile's accumulator in VMEM across a sequential S grid
// axis; here that axis is a loop inside the block: 8 positions of X and D at
// a time are staged in shared memory (as float32, the next stage prefetched
// into registers while this one is multiplied) and each thread accumulates an
// 8 x 8 piece of the tile in float32 registers.  The block then squares and
// sums its tile and writes ONE partial.  TPU grid steps carry the cross-tile
// and cross-layer sum in the output block; CUDA blocks run in no order, so a
// second pass (psgn_tile.cuh) sums each sample's L * nI * nJ partials in a
// fixed order: no float atomics, the same bits on every run.  Ragged S, Din
// and Dout are masked at the stage loads (zeros), never padded in memory.
//
// What bounds it on the H100: FLOPs, 2 * S * Din * Dout per (l, b).  This
// first version runs them on the float32 FMA pipes (67 TFLOP/s peak), not
// the tensor cores, which would take bf16 inputs at 989 TFLOP/s; wgmma
// tiles are a later step.  Products of bf16 values are exact in float32, so
// the kernel and its plain version differ only in summation order.

#include "psgn_tile.cuh"

namespace repro {
namespace {

using namespace psgn;

template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads)
psgn_direct_kernel(const TX* __restrict__ x, const TD* __restrict__ d,
                   float* __restrict__ partials, int L, int B, int S, int Din, int Dout,
                   int nI, int nJ) {
  __shared__ __align__(16) Stage sx;
  __shared__ __align__(16) Stage sd;

  const int jt = blockIdx.x, it = blockIdx.y, lb = blockIdx.z;
  const int i0 = it * kTile, j0 = jt * kTile;
  const TX* xb = x + (size_t)lb * S * Din;
  const TD* db = d + (size_t)lb * S * Dout;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // stage element e = tid + r * kThreads sits at (row e / kTile, col e % kTile):
  // a warp reads 32 neighbouring features of one position
  float px[kPerThread], pd[kPerThread];
  auto load = [&](int s0) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = tid + r * kThreads, row = e / kTile, col = e % kTile;
      const int s = s0 + row;
      px[r] = (s < S && i0 + col < Din) ? to_f(xb[(size_t)s * Din + i0 + col]) : 0.0f;
      pd[r] = (s < S && j0 + col < Dout) ? to_f(db[(size_t)s * Dout + j0 + col]) : 0.0f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  load(0);
  for (int s0 = 0; s0 < S; s0 += kK) {
    __syncthreads();  // every thread is done with the previous stage
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = tid + r * kThreads;
      sx.v[e / kTile][e % kTile] = px[r];
      sd.v[e / kTile][e % kTile] = pd[r];
    }
    __syncthreads();
    if (s0 + kK < S) load(s0 + kK);
    stage_product(sx, sd, ty, tx, acc);
  }

  float sq = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) sq = fmaf(acc[r][c], acc[r][c], sq);
  const float total = block_sum(sq);
  if (tid == 0) {
    const int l = lb / B, b = lb % B;
    partials[(size_t)b * L * nI * nJ + ((size_t)l * nI + it) * nJ + jt] = total;
  }
}

template <typename TX, typename TD>
int launch(const void* x, const void* d, float* partials, float* out, int L, int B, int S,
           int Din, int Dout, int nI, int nJ, cudaStream_t stream) {
  const dim3 grid(nJ, nI, L * B);
  psgn_direct_kernel<TX, TD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(d), partials, L, B, S, Din, Dout,
      nI, nJ);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(partials, out, B, L * nI * nJ, stream);
}

template <typename TX>
int dispatch_d(int d_dtype, const void* x, const void* d, float* partials, float* out, int L,
               int B, int S, int Din, int Dout, int nI, int nJ, cudaStream_t stream) {
  if (d_dtype == kFloat32)
    return launch<TX, float>(x, d, partials, out, L, B, S, Din, Dout, nI, nJ, stream);
  if (d_dtype == kBFloat16)
    return launch<TX, __nv_bfloat16>(x, d, partials, out, L, B, S, Din, Dout, nI, nJ, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// x: (L, B, S, Din), delta: (L, B, S, Dout), contiguous; dtype codes 0
// float32, 1 bfloat16, each on its own.  partials: (B, n_partials) float32
// scratch with n_partials = L * ceil(Din / 128) * ceil(Dout / 128); out: (B,)
// float32.  Two launches on `stream` (tiles, then the per-sample sum).
// Returns the cudaError_t (0 on success).
extern "C" int psgn_direct_fwd(int x_dtype, int d_dtype, const void* x, const void* delta,
                               void* partials, void* out, int L, int B, int S, int Din,
                               int Dout, int n_partials, void* stream) {
  using namespace repro;
  if (L < 1 || B < 1 || S < 1 || Din < 1 || Dout < 1 || L * B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nI = (Din + psgn::kTile - 1) / psgn::kTile;
  const int nJ = (Dout + psgn::kTile - 1) / psgn::kTile;
  if (nI > 65535 || n_partials != L * nI * nJ) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  if (x_dtype == kFloat32)
    return dispatch_d<float>(d_dtype, x, delta, p, o, L, B, S, Din, Dout, nI, nJ, s);
  if (x_dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(d_dtype, x, delta, p, o, L, B, S, Din, Dout, nI, nJ, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* psgn_direct_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
