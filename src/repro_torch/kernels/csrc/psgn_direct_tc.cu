// Per-sample gradient squared norms of dense layers, DIRECT factorisation,
// on Hopper's tensor cores (sm_90a):
//
//   out[b] = sum_l ||X_lb^T D_lb||_F^2 over L same-shape layers
//
// Replaces, on x and delta whose widths are multiples of 8: _direct_kernel
// (psgn_direct, L = 1) and _fused_kernel (psgn_fused) in
// repro/kernels/psgn.py.  Ragged widths take psgn_direct.cu.
//
//   layer l: X_l (B, S, Din), D_l (B, S, Dout), each its own tensor: the L
//   layers come as a table of TMA maps (a __grid_constant__ kernel
//   parameter), so a group of layers is never stacked in memory.
//   G_lb = X_lb^T D_lb (Din, Dout) never leaves the block that owns its tile.
//
// Term pairs.  The products are bf16.  A float32 operand comes split into
// three bf16 terms, v = hi + mid + lo (psgn_split.cu), and G is the sum of
// T products of terms, X_i^T D_j over the pairs (i, j) of kernels/psgn.py's
// split_pairs: T = 1 for bf16 x bf16, 3 for one float32 operand, 6 for two
// (the pairs with i + j <= 2; each of the dropped mid.lo, lo.mid and lo.lo
// is below 2^-21 of |x||d|).  A product of two bf16 values is exact in
// float32, so the split route differs from the float32 plain version only in
// the order of its sums and in those dropped pairs.  Each pair has its
// entry in the table, an x map and a d map (a bf16 operand repeats its one
// map); a block runs its K loop over the T pairs times the S stages into
// ONE accumulator and squares it once at the end (summing ||X_i^T D_j||^2
// per pair would be wrong).  TF32 is no way in: both operands are MN-major
// (below), which PTX allows for f16 and bf16 only.
//
// Grid: one block per (Din tile of 128, Dout tile of 256) of one (l, b),
// those of one (l, b) consecutive in launch order, so X_lb and D_lb (16 + 16
// MB at Yi-6B's q/o widths, S 2048) stay in the 50 MB L2 while their tiles
// run.  The contraction runs over S, the OUTER axis of both X and D: both
// wgmma operands are MN-major (features contiguous), staged by TMA as boxes
// of 64 positions x 64 features with the 128-byte swizzle and read with
// wgmma's transpose bits set.  A stage holds 64 positions of one pair: 2
// boxes of X, 4 of D (48 KB); 4 stages ring through shared memory, their
// mbarrier phases counted over all T x ceil(S / 64) stages of the block.
// One producer warp issues the TMA loads, two consumer warpgroups each
// multiply their 64 Din rows by the 256 Dout columns (m64n256k16, 128
// float32 accumulators per thread, registers rebalanced with setmaxnreg),
// keeping one stage's wgmma group in flight while the next is issued.  The
// epilogue squares and sums the accumulators in registers, then warps, then
// the block in a fixed order, and writes ONE partial per (l, b, Din tile,
// Dout tile); the second pass (psgn_tile.cuh) sums each sample's partials
// in a fixed order: no float atomics, the same bits on every run.  Ragged
// S, Din and Dout read zeros from TMA's out-of-bounds fill; nothing is
// padded in memory.
//
// What bounds it on the H100: FLOPs, T x 2 S Din Dout per (l, b), at the
// bf16 tensor-core rate (989 TFLOP/s); the split adds 10 bytes of traffic
// per float32 element.  L2 traffic is the next limit: each tile reads
// (128 + 256) S 2 bytes per pair, 24 GB over the 16 q/o layers at S 2048,
// B 2 (T = 1); the 128 x 256 tile is the widest two warpgroups can hold.

#include "hopper.cuh"
#include "psgn_tile.cuh"

namespace repro {
namespace {

using namespace tc;

constexpr int kTileI = 128;   // Din rows of a block's tile: 2 warpgroups x 64
constexpr int kTileJ = 256;   // Dout columns
constexpr int kK = 64;        // positions per stage
constexpr int kStages = 4;
constexpr int kXBytes = kK * kTileI * 2;      // 16 KB, 2 boxes
constexpr int kDBytes = kK * kTileJ * 2;      // 32 KB, 4 boxes
constexpr int kStageBytes = kXBytes + kDBytes;
constexpr int kSmemBytes = kStages * kStageBytes + kSwizzleAtom;
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kMaxEntries = 32;  // (layer, pair) entries per launch: 64 maps, 8 KB of parameters

// Entry l * T + p: layer l's x and d terms of pair p.
struct Maps {
  CUtensorMap x[kMaxEntries];
  CUtensorMap d[kMaxEntries];
};

__global__ void __launch_bounds__(kThreads, 1)
psgn_direct_tc_kernel(const __grid_constant__ Maps maps, float* __restrict__ partials,
                      int l0, int n_partials, int B, int S, int T, int nI, int nJ) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float warp_sums[8];
  uint8_t* smem = align_1024(smem_raw);

  const int l = blockIdx.y / B, b = blockIdx.y % B;
  const int it = blockIdx.x / nJ, jt = blockIdx.x % nJ;
  const int nk = (S + kK - 1) / kK;
  const int n_stages = T * nk;  // pair p's stages are p * nk .. p * nk + nk - 1
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full.  setmaxnreg moves registers
    // within the block: the launch bounds give 168 a thread (384 x 168 =
    // 64512), and 128 x 40 + 256 x 232 is the same total, so the consumers'
    // increase is covered by the producer's decrease and cannot stall.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int p = 0; p < T; ++p) {
        prefetch_map(&maps.x[l * T + p]);
        prefetch_map(&maps.d[l * T + p]);
      }
      for (int k = 0; k < n_stages; ++k) {
        const int p = k / nk, pos = (k - p * nk) * kK;
        const CUtensorMap* mx = &maps.x[l * T + p];
        const CUtensorMap* md = &maps.d[l * T + p];
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
#pragma unroll
        for (int q = 0; q < kTileI / kBox; ++q)
          tma_box(st + q * kBoxBytes, mx, &full[s], it * kTileI + q * kBox, pos, b);
#pragma unroll
        for (int q = 0; q < kTileJ / kBox; ++q)
          tma_box(st + kXBytes + q * kBoxBytes, md, &full[s], jt * kTileJ + q * kBox, pos, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns Din rows 64 wg .. 64 wg + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[128];  // the first product overwrites it (scale-d 0); every pair adds to it
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % kStages;
      mbar_wait(&full[s], (k / kStages) & 1);
      const uint8_t* st = smem + s * kStageBytes;
      // a k16 slice is 16 rows of 128 bytes further into each box
      const uint64_t da = smem_desc(st + wg * kBoxBytes, kBoxBytes, kSwizzleAtom);
      const uint64_t db = smem_desc(st + kXBytes, kBoxBytes, kSwizzleAtom);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk)
        wgmma_m64n256k16_mn(acc, da + kk * (16 * 128 >> 4), db + kk * (16 * 128 >> 4),
                            k > 0 || kk > 0);
      wgmma_commit();
      // the previous stage's products are done: hand its buffer back
      wgmma_wait<1>();
      fence_regs(acc);
      if (k > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(k - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    float sq = 0.0f;
#pragma unroll
    for (int r = 0; r < 128; ++r) sq = fmaf(acc[r], acc[r], sq);
    sq = warp_sum(sq);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
    asm volatile("bar.sync 1, 256;" ::: "memory");  // the consumer warps only
    if (threadIdx.x == 0) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) total += warp_sums[w];
      partials[(size_t)b * n_partials + ((size_t)(l0 + l) * nI + it) * nJ + jt] = total;
    }
  }
}

}  // namespace
}  // namespace repro

// xs, ds: host arrays of L * T device pointers, entry l * T + p the x and
// delta terms of layer l's pair p, (B, S, Din) and (B, S, Dout) bf16,
// contiguous, 16-byte aligned; Din and Dout multiples of 8.  partials:
// (B, n_partials) float32 scratch with n_partials = L * ceil(Din / 128) *
// ceil(Dout / 256); out: (B,) float32.  Launches on `stream`: the tile
// kernel once per 32 / T layers, then the per-sample sum.  Returns the
// cudaError_t (0 on success), or repro::tc::kTensorMapError + the CUresult
// when a tensor map cannot be made.
extern "C" int psgn_direct_tc_fwd(const void* const* xs, const void* const* ds, int L, int T,
                                  void* partials, void* out, int B, int S, int Din, int Dout,
                                  int n_partials, void* stream) {
  using namespace repro;
  if (L < 1 || T < 1 || T > kMaxEntries || B < 1 || S < 1 || Din < 8 || Dout < 8 || Din % 8 ||
      Dout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_launch = kMaxEntries / T;  // layers
  if ((long long)(L < per_launch ? L : per_launch) * B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nI = (Din + kTileI - 1) / kTileI, nJ = (Dout + kTileJ - 1) / kTileJ;
  if (nI * nJ > 0x7fffffffLL || n_partials != L * nI * nJ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      psgn_direct_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  Maps maps = {};
  for (int l0 = 0; l0 < L; l0 += per_launch) {
    const int n = L - l0 < per_launch ? L - l0 : per_launch;
    for (int e = 0; e < n * T; ++e) {
      int rc = tc::encode_rows(&maps.x[e], xs[l0 * T + e], B, S, Din);
      if (rc == 0) rc = tc::encode_rows(&maps.d[e], ds[l0 * T + e], B, S, Dout);
      if (rc != 0) return rc;
    }
    const dim3 grid(static_cast<unsigned>(nI * nJ), n * B);
    psgn_direct_tc_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        maps, p, l0, n_partials, B, S, T, static_cast<int>(nI), static_cast<int>(nJ));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return psgn::sum_partials(p, static_cast<float*>(out), B, n_partials, st);
}

extern "C" const char* psgn_direct_tc_error(int code) { return repro::tc::error_string(code); }
