// Flash-attention backward, dq pass, on Hopper's tensor cores (sm_90a), bf16
// q, k, v, dout: causal (optionally sliding-window, softcapped)
// self-attention with grouped KV heads, recomputing p from the lse the
// forward wrote.
//
// Replaces, on bf16 inputs at head dims 64 and 128: _flash_dq_kernel (with
// _recompute_dlogits) in repro/kernels/attention.py, launched by
// _flash_backward:
//
//   dq_i = scale * sum_j bf(ds_ij) k_j,   ds_ij = p_ij (dO_i.v_j - delta_i)
//                                          [* (1 - tanh^2) under a softcap]
//
// with p_ij = exp(logit_ij - lse_i) where the mask allows and exactly 0
// elsewhere, bf() the rounding to bf16 (dlogits.astype(k.dtype)); dq leaves
// in float32.  float32 inputs and head dim 32 take flash_dq.cu.
//
// Structure.  One block per (128 query rows, query head, batch row): two
// warpgroups of 128 threads, each over 64 adjacent rows of the same head,
// and no producer warp (256 threads may use 255 registers a thread; a 288-
// or 384-thread block gets 168).  Thread 0 loads both warpgroups' q and dO
// once by TMA, then streams K/V tiles of 64 keys of KV head h / n_rep
// through a 3-stage ring, from the first tile the window reaches to the
// diagonal: both warpgroups read every tile, so K and V are read once per
// 128 rows, and the earlier warpgroup skips the last tile (past its
// diagonal), the later one any first tile out of its window.  Pairing
// adjacent rows of one head, not two heads of one KV group, works for any
// n_rep, MHA included.  Per tile a warpgroup forms S = Q K^T and dP = dO V^T
// (wgmma, both operands in shared memory, K-major, in the short chains of
// flash_tc.cuh), p and ds in registers with the mask, ds rounded to bf16 (a
// ds near a rounding tie taken again as fmaf chains, flash_tc.cuh), then dQ
// += dS K with dS in registers (the accumulator's layout is the A
// fragment's) and K MN-major (transpose bit set), 4 k16 steps.  dQ (64 x hd
// float32) stays in registers and is written once, scaled: no atomics, the
// same bits on every run.  A stage is refilled by the second warpgroup to
// say it has read it (a counter in shared memory), so neither waits for the
// other.
//
// Balance.  Grid (S / 128, H, B), the latest row blocks (the most key tiles
// under causality) launched first: 1024 blocks at the training shape.
//
// What bounds it on the H100: FLOPs, 3 products of 2 hd per causal (row,
// key) pair at the bf16 tensor-core rate.

#include "flash_tc.cuh"

namespace repro {
namespace {

using namespace tc;

constexpr int kBK = 64;  // keys per tile
constexpr int kBQ = 64;  // query rows per warpgroup
constexpr int kStages = 3;
constexpr int kWG = 2;                // warpgroups, over adjacent 64-row tiles
constexpr int kThreads = 128 * kWG;   // no producer warp: 256 threads may use 255 registers
constexpr int kRows = kWG * kBQ;      // query rows per block

template <int HD>
struct Shape {
  static constexpr int kFB = HD / kBox;               // feature boxes per row
  static constexpr int kTileBytes = kBox * HD * 2;    // 64 rows of q, dO, k or v
  static constexpr int kStageBytes = 2 * kTileBytes;  // k, then v
  // q of both warpgroups, dO of both, then the K/V ring
  static constexpr int kSmem = 2 * kWG * kTileBytes + kStages * kStageBytes + kSwizzleAtom;
  static constexpr int kO = HD / 2;  // accumulator floats of 64 x HD
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                   const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int S, int H, int KV, float scale, float softcap,
                   int window) {
  using G = Shape<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t qbar;
  __shared__ int released[kStages];  // warpgroups done with a stage, over all its uses
  __shared__ float slse[kRows];
  __shared__ float sdelta[kRows];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem;                                 // [warpgroup][feature box]
  uint8_t* sdo = smem + kWG * G::kTileBytes;          // [warpgroup][feature box]
  uint8_t* ring = smem + 2 * kWG * G::kTileBytes;     // [stage][k, v][feature box]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;

  // the key tiles rows r0 .. r0 + 63 see: from the first the window reaches
  // of row r0 to the diagonal of the last row below S (none if r0 >= S)
  auto first_tile = [&](int r0) { return window > 0 ? max(0, r0 - window + 1) / kBK : 0; };
  auto end_tile = [&](int r0) { return r0 < S ? (min(r0 + kBQ, S) - 1) / kBK + 1 : 0; };
  const int r0 = q0 + wg * kBQ;
  const int my_begin = first_tile(r0), my_end = end_tile(r0);
  const int t_begin = first_tile(q0);  // the block's tiles: the union of both
  const int n = max(end_tile(q0), end_tile(q0 + kBQ)) - t_begin;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);  // the expect_tx arrival
    mbar_init(&qbar, 1);
    mbar_init_fence();
  }
  if (tid < kStages) released[tid] = 0;
  {  // thread t holds lse (t < 128) or delta (t >= 128) of block row t % 128
    const int row = q0 + tid % kRows;
    const size_t at = ((size_t)b * H + h) * S + row;
    const float v = row < S ? (tid < kRows ? lse[at] : delta[at]) : 0.0f;
    (tid < kRows ? slse : sdelta)[tid % kRows] = v;
  }
  __syncthreads();

  // tile i of the block's range into stage i % kStages: K then V, one box
  // of 64 keys x 64 features each
  auto issue = [&](int i) {
    const int s = i % kStages, key0 = (t_begin + i) * kBK;
    uint8_t* st = ring + s * G::kStageBytes;
    mbar_expect_tx(&full[s], G::kStageBytes);
    for (int f = 0; f < G::kFB; ++f) {
      tma_box(st + f * kBoxBytes, &mk, &full[s], hk * HD + f * kBox, key0, b);
      tma_box(st + G::kTileBytes + f * kBoxBytes, &mv, &full[s], hk * HD + f * kBox, key0, b);
    }
  };
  if (tid == 0) {
    prefetch_map(&mk);
    prefetch_map(&mv);
    mbar_expect_tx(&qbar, 2 * kWG * G::kTileBytes);
    for (int w = 0; w < kWG; ++w)
      for (int f = 0; f < G::kFB; ++f) {
        tma_box(sq + w * G::kTileBytes + f * kBoxBytes, &mq, &qbar, h * HD + f * kBox,
                q0 + w * kBQ, b);
        tma_box(sdo + w * G::kTileBytes + f * kBoxBytes, &mdo, &qbar, h * HD + f * kBox,
                q0 + w * kBQ, b);
      }
    for (int i = 0; i < kStages && i < n; ++i) issue(i);
  }

  // --- rows r0 + 16 warp + g (a) and + 8 (b) of this warpgroup's dQ -----------
  const int lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int rl_a = (lt / 32) * 16 + g;  // the tile rows of rows a and b
  const uint8_t* my_q = sq + wg * G::kTileBytes;
  const uint8_t* my_do = sdo + wg * G::kTileBytes;
  const float* my_lse = slse + wg * kBQ;
  const float* my_delta = sdelta + wg * kBQ;
  float dqa[G::kO];
#pragma unroll
  for (int i = 0; i < G::kO; ++i) dqa[i] = 0.0f;
  mbar_wait(&qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages, t = t_begin + i, k0 = t * kBK;
    const uint8_t* sk = ring + s * G::kStageBytes;
    const uint8_t* sv = sk + G::kTileBytes;
    // every warpgroup waits on every tile, so each tracks the stages' phases
    mbar_wait(&full[s], (i / kStages) & 1);
    if (t >= my_begin && t < my_end) {
      // S = Q K^T and dP = dO V^T over hd
      float st[32], dpt[32], tmp[32];
      tile_dot<HD>(st, tmp, my_q, sk);
      tile_dot<HD>(dpt, tmp, my_do, sv);

      // ds in place of dP: element 4 c + e is row (e < 2 ? a : b), key k0 +
      // 8 c + 2 tig + (e & 1)
      uint32_t ties = 0;  // elements whose ds lies near a bf16 rounding tie
      const bool whole = (!kCausal || r0 >= k0 + kBK - 1) && r0 + kBQ <= S && k0 + kBK <= S &&
                         (window <= 0 || r0 + kBQ - 1 - k0 < window);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = rl_a + (e < 2 ? 0 : 8);
          const int idx = 4 * c + e;
          const bool ok = whole || attend(r0 + rl, k0 + 8 * c + 2 * tig + (e & 1), S, window);
          float p, ds;
          p_ds(st[idx], dpt[idx], my_lse[rl], my_delta[rl], ok, scale, softcap, p, ds);
          dpt[idx] = ds;
          if (fabsf(ds) >= kTieDs && near_tie(ds)) ties |= 1u << idx;
        }
      }
      // where the tensor cores' sums decide a bf16 rounding that matters,
      // take the logit and dp again as fmaf chains: each lane one flagged
      // element at a time, written back by a select (registers take no
      // runtime index)
      while (__any_sync(0xffffffffu, ties != 0)) {
        const int at = ties ? __ffs(ties) - 1 : -1;
        float p = 0.0f, ds = 0.0f;
        if (at >= 0) {
          ties &= ties - 1;
          const int rl = rl_a + (at % 4 < 2 ? 0 : 8);
          const int kl = 8 * (at / 4) + 2 * tig + (at & 1);
          p_ds(row_dot<HD>(my_q, rl, sk, kl), row_dot<HD>(my_do, rl, sv, kl), my_lse[rl],
               my_delta[rl], true, scale, softcap, p, ds);
        }
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          if (at == idx) dpt[idx] = ds;
      }
      uint32_t da[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) rs_fragment(da[kk], dpt, kk);

      // dQ += dS K: K's k16 slices 16 keys (2 KB) apart, the next feature
      // box (8 KB) along N
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        rs_product<HD>(dqa, da[kk], smem_desc(sk + kk * 2048, kBoxBytes, kSwizzleAtom));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
    }
    // this warpgroup has read stage s (its product has completed, so all its
    // warps have); the second warpgroup to say so refills it
    if (lt == 0 && (atomicAdd(&released[s], 1) & 1) && i + kStages < n) issue(i + kStages);
  }

  const size_t stride = (size_t)H * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + rl_a + 8 * half;
    if (row >= S) continue;
    float* dst = dq + ((size_t)b * S + row) * stride + (size_t)h * HD + 2 * tig;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(dst + 8 * c) =
          make_float2(dqa[4 * c + 2 * half] * scale, dqa[4 * c + 2 * half + 1] * scale);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int B, int S, int H, int KV, float scale, float softcap,
           int window, cudaStream_t stream) {
  using G = Shape<HD>;
  CUtensorMap mq, mdo, mk, mv;
  int rc = encode_rows(&mq, q, B, S, H * HD);
  if (rc == 0) rc = encode_rows(&mdo, dout, B, S, H * HD);
  if (rc == 0) rc = encode_rows(&mk, k, B, S, KV * HD);
  if (rc == 0) rc = encode_rows(&mv, v, B, S, KV * HD);
  if (rc != 0) return rc;
  auto kernel = flash_dq_tc_kernel<HD>;
  static SmemOptIn opt_in;
  rc = opt_in.apply(kernel, G::kSmem);
  if (rc != 0) return rc;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), S, H, KV, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q, dout: (B, S, H, hd); k, v: (B, S, KV, hd), bf16, contiguous, 16-byte
// aligned; lse, delta: (B, H, S) float32 -> dq: (B, S, H, hd) float32.
// dtype must be 1 (bfloat16); hd 64 or 128; softcap <= 0 means none, window
// <= 0 means none.  The signature is flash_dq_bwd's.  Returns the launch's
// cudaError_t (0 on success), or repro::tc::kTensorMapError + the CUresult
// when a tensor map cannot be made.
extern "C" int flash_dq_tc_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta, void* dq,
                               int B, int S, int H, int KV, int hd, float scale, float softcap,
                               int window, void* stream) {
  using namespace repro;
  if (dtype != kBFloat16 || B < 1 || B > 65535 || S < 1 || KV < 1 || H % KV != 0 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, softcap, window, s);
  if (hd == 64)
    return launch<64>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, softcap, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_dq_tc_error(int code) { return repro::tc::error_string(code); }
