// Per-sample gradient squared norms of a dense layer, GRAM factorisation,
// on Hopper's tensor cores (sm_90a), bf16 inputs:
//
//   out[b] = sum_{t,t'} (x_t . x_t') (d_t . d_t')  ==  ||X_b^T D_b||_F^2
//
// Replaces, on bf16 x and delta whose widths are multiples of 8:
// _gram_kernel (psgn_gram) in repro/kernels/psgn.py.  Other inputs take
// psgn_gram.cu.
//
//   X: (B, S, Din), D: (B, S, Dout), bf16.
//
// Grid: one block per (half of a 128 x 128 tile pair of positions i <= j,
// sample b): rows i0 .. i0 + 63 (the pair's upper or lower half) against
// columns j0 .. j0 + 127.  The block forms Gx = X_i X_j^T over Din, then Gd
// = D_i D_j^T over Dout, as m64n128k16 wgmma products on one consumer
// warpgroup: both operands are K-major (rows of positions, features
// contiguous), the natural layout, staged by TMA in boxes of 64 features x
// 64 rows with the 128-byte swizzle; a stage holds 64 features of the 64
// rows and of the 128 columns (24 KB), 4 stages ring through shared memory,
// one producer warp issues the loads.  Gx and Gd have the same register
// layout, so sum(Gx * Gd) is a dot product inside each thread's 64 + 64
// accumulators, then warps, then the block in a fixed order: ONE partial per
// (b, pair, half), doubled for an off-diagonal pair (both Gram matrices are
// symmetric), and the fixed-order second pass (psgn_tile.cuh) sums each
// sample's partials: no float atomics, the same bits on every run.
//
// Waves: 128 x 128 pairs would be 136 x B 2 = 272 blocks of one per SM
// (two 64 x 128 accumulators per thread on two warpgroups), 2.06 waves on
// 132 SMs, the last with 8 blocks.  The 64-row halves make 544 blocks of
// 160 threads and 97 KB of shared memory, two per SM, so the tail is half
// as long and each SM always has a second block to overlap one's loads,
// chain ends and epilogue with the other's products; the price is L2
// traffic, (64 + 128) rows per block instead of 128 + 128 per half pair
// (3.2 GB at gate/up).
// Ragged S and widths read zeros from TMA's out-of-bounds fill.
//
// What bounds it on the H100: FLOPs, S (S + 1) (Din + Dout) per sample over
// the upper triangle, at the bf16 tensor-core rate; products of bf16
// values are exact in float32, so only the summation order differs from the
// plain version.

#include "hopper.cuh"
#include "psgn_tile.cuh"

namespace repro {
namespace {

using namespace tc;

constexpr int kPair = 128;  // positions per side of a tile pair
constexpr int kRows = 64;   // rows of a block: half a pair
constexpr int kK = 64;      // features per stage
constexpr int kStages = 4;
constexpr int kChain = 4;   // stages per wgmma chain (see the consumer)
constexpr int kABytes = kRows * kK * 2;   // 8 KB, 1 box
constexpr int kBBytes = kPair * kK * 2;   // 16 KB, 2 boxes
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + kSwizzleAtom;
constexpr int kThreads = 160;  // consumer warpgroup (warps 0-3), producer warp 4

// tmp = A B^T over stages [k0, k1) of the ring, one wgmma chain: four k16
// products per stage, the first of the chain overwriting tmp (scale-d 0),
// so no other instruction writes the accumulators (which would make ptxas
// serialise the pipeline).  One stage's products stay in flight while the
// next stage is issued; each stage's buffer goes back to the producer once
// its products are done.
__device__ __forceinline__ void chain(float (&tmp)[64], uint8_t* smem, uint64_t* full,
                                      uint64_t* empty, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    const uint8_t* st = smem + s * kStageBytes;
    // a k16 slice is 32 bytes further along each 128-byte row
    const uint64_t da = smem_desc(st, 16, kSwizzleAtom);
    const uint64_t db = smem_desc(st + kABytes, 16, kSwizzleAtom);
    fence_regs(tmp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk)
      wgmma_m64n128k16_k(tmp, da + kk * (32 >> 4), db + kk * (32 >> 4), k > k0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(tmp);
    if (k > k0 && threadIdx.x == 0) mbar_arrive(&empty[(k - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(tmp);
  if (threadIdx.x == 0) mbar_arrive(&empty[(k1 - 1) % kStages]);
}

__global__ void __launch_bounds__(kThreads, 2)
psgn_gram_tc_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap md,
                    float* __restrict__ partials, int Din, int Dout, int nT, int n_partials) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float warp_sums[4];
  uint8_t* smem = align_1024(smem_raw);

  // block x = 2 pair + half; pair -> (ti, tj), ti <= tj, row-major over the
  // upper triangle
  const int half = blockIdx.x & 1;
  int ti = 0, p = blockIdx.x >> 1;
  while (p >= nT - ti) {
    p -= nT - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int b = blockIdx.y;
  const int nkx = (Din + kK - 1) / kK, nk = nkx + (Dout + kK - 1) / kK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 1);  // the consumer warpgroup's arrival
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread keeps the ring full, X's stages then D's
    if (threadIdx.x == 128) {
      prefetch_map(&mx);
      prefetch_map(&md);
      const int i0 = ti * kPair + half * kRows, j0 = tj * kPair;
      for (int k = 0; k < nk; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        const CUtensorMap* m = k < nkx ? &mx : &md;
        const int f0 = (k < nkx ? k : k - nkx) * kK;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_box(st, m, &full[s], f0, i0, b);
        tma_box(st + kABytes, m, &full[s], f0, j0, b);
        tma_box(st + kABytes + kBoxBytes, m, &full[s], f0, j0 + kBox, b);
      }
    }
  } else {
    // A wgmma chain adds each k16 product into its float32 accumulator
    // less exactly than round-to-nearest: one chain over the whole width
    // (688 k16 steps at 11008) put the result 4.8e-5 relative off its plain
    // version on an H100, where the FMA kernel is within 1e-7.  So a chain
    // spans kChain stages (256 features, 16 k16 steps) and is retired into
    // float32 sums with round-to-nearest: into gx while it covers X, else
    // (sum(Gx * Gd) is linear in Gd) straight into the dot product v.
    float gx[64], tmp[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) gx[r] = 0.0f;
    float v = 0.0f;
    for (int k = 0; k < nk;) {
      const int stop = k < nkx ? nkx : nk;  // a chain covers one operand
      const int k1 = k + kChain < stop ? k + kChain : stop;
      chain(tmp, smem, full, empty, k, k1);
      if (k < nkx) {
#pragma unroll
        for (int r = 0; r < 64; ++r) gx[r] += tmp[r];
      } else {
#pragma unroll
        for (int r = 0; r < 64; ++r) v = fmaf(gx[r], tmp[r], v);
      }
      k = k1;
    }
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
    asm volatile("bar.sync 1, 128;" ::: "memory");  // the consumer warps only
    if (threadIdx.x == 0) {
      const float total = ((warp_sums[0] + warp_sums[1]) + warp_sums[2]) + warp_sums[3];
      partials[(size_t)b * n_partials + blockIdx.x] = (ti == tj ? 1.0f : 2.0f) * total;
    }
  }
}

}  // namespace
}  // namespace repro

// x: (B, S, Din), delta: (B, S, Dout), bf16, contiguous, 16-byte aligned;
// Din and Dout multiples of 8.  partials: (B, n_partials) float32 scratch
// with n_partials = 2 nT (nT + 1) / 2, nT = ceil(S / 128); out: (B,)
// float32.  Two launches on `stream` (half tile pairs, then the per-sample
// sum).  Returns the cudaError_t (0 on success), or
// repro::tc::kTensorMapError + the CUresult when a tensor map cannot be made.
extern "C" int psgn_gram_tc_fwd(const void* x, const void* delta, void* partials, void* out,
                                int B, int S, int Din, int Dout, int n_partials, void* stream) {
  using namespace repro;
  if (B < 1 || B > 65535 || S < 1 || Din < 8 || Dout < 8 || Din % 8 || Dout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nT = (S + kPair - 1) / kPair;
  const long long n_blocks = nT * (nT + 1);  // 2 halves of nT (nT + 1) / 2 pairs
  if (n_blocks > 0x7fffffffLL || n_partials != n_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, md;
  int rc = tc::encode_rows(&mx, x, B, S, Din);
  if (rc == 0) rc = tc::encode_rows(&md, delta, B, S, Dout);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      psgn_gram_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  psgn_gram_tc_kernel<<<dim3(static_cast<unsigned>(n_blocks), B), kThreads, kSmemBytes, st>>>(
      mx, md, p, Din, Dout, static_cast<int>(nT), n_partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return psgn::sum_partials(p, static_cast<float*>(out), B, n_partials, st);
}

extern "C" const char* psgn_gram_tc_error(int code) { return repro::tc::error_string(code); }
