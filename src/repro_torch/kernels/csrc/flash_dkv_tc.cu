// Flash-attention backward, dk/dv pass, on Hopper's tensor cores (sm_90a),
// bf16 q, k, v, dout: causal or not (optionally sliding-window, softcapped)
// attention with grouped KV heads of Sq query rows at positions q0 .. q0 +
// Sq - 1 against Sk keys at 0 .. Sk - 1 (self-attention: q0 = 0, Sk = Sq;
// a context-parallel rank's rows: q0 > 0), recomputing p from the lse the
// forward wrote.
//
// Replaces, on bf16 inputs at head dims 64, 80, 112 and 128, causal or not:
// _flash_dkv_kernel (with
// _recompute_dlogits) in repro/kernels/attention.py, launched by
// _flash_backward, AND the sum over the n_rep query heads of each KV head
// that the reference takes outside the kernel (attention.py:367-368):
//
//   dv_j = sum_h sum_i bf(p_hij) dO_hi
//   dk_j = scale * sum_h sum_i bf(ds_hij) q_hi
//
// with p recomputed from the forward's lse and forced to 0 where the mask is
// false, ds = p (dp - delta) [* (1 - tanh^2) under a softcap], bf() the
// rounding to bf16 (p.astype(do.dtype), dlogits.astype(q.dtype)); dk and dv
// leave in float32.  float32 inputs and head dims 16 and 32 take
// flash_dkv.cu.  Causality is a template parameter.
//
// Structure.  One block per (64-key tile, KV head, batch row), two
// warpgroups of 128 threads and no producer warp (256 threads may use 255
// registers a thread; a 288- or 384-thread block gets 168, and these
// accumulators need more).  Thread 0 loads K and V once by TMA (4-D maps,
// one head at a time: at hd 80 and 112 a row's second box is zero-filled
// past hd); each warpgroup keeps its own 64 x hd float32 dK and dV in
// registers and takes half the block's items, an item one query head's
// tile of 64 rows among those that see the key tile (from the tile holding
// the diagonal under causality, from row 0 without, to the last row the
// window lets see it).  With an even n_rep a warpgroup takes every other head (wg, wg
// + 2, ...) and all their tiles; with an odd one (n_rep 1: MHA, the
// encoder) every other item of the list ordered by (head, tile), so
// neither warpgroup idles.  The items stream as (q, dO) tiles of 64 rows
// through the warpgroup's own 2-stage TMA ring: its thread
// 0 refills a stage, and its threads put the rows' lse and delta beside it,
// once a named barrier says the warpgroup has read it.  Per tile: S^T = K
// Q^T and dP^T = V dO^T (wgmma, both operands in shared memory, K-major),
// P^T and dS^T in registers, rounded to bf16 at the reference's points,
// then dV += P^T dO and dK += dS^T Q with P^T and dS^T in registers (the
// accumulator's layout is the A fragment's) and dO and Q MN-major
// (transpose bit set), 4 k16 steps each.  At the end warpgroup 1 hands its
// sums to warpgroup 0 through shared memory, which adds them in that fixed
// order and writes dK (scaled once) and dV: no float atomics, the same bits
// on every run, and no (B, S, H, hd) per-head partials.
//
// Rounding.  p and ds are rounded to bf16 before the products: the scores
// run in short chains, and p or ds near a bf16 tie is taken again as fmaf
// chains (flash_tc.cuh).
//
// Balance.  Under causality key tile t sees (S / 64 - t) query tiles per
// head in self-attention: 32 down to 1 at S 2048.  The grid is (KV, B, key
// tiles) with the heaviest tiles launched first: 256 blocks at the training
// shape, the heaviest 32 tiles x 4 heads per warpgroup.  At a query offset
// q0 (a context-parallel rank's Sq rows against Sk = q0 + Sq keys) every
// key tile below q0 sees all Sq / 64 query tiles and the later ones fewer,
// so tile 0 is still the heaviest and the order still holds.  Without causality every key
// tile sees every query tile: at hubert's shape (S 1024, 16 KV heads, B 2)
// 512 blocks of 16 tiles, 8 per warpgroup.
//
// What bounds it on the H100: FLOPs, 4 products of 2 hd per causal (row,
// key) pair at the bf16 tensor-core rate.

#include "flash_tc.cuh"

namespace repro {
namespace {

using namespace tc;

constexpr int kBK = 64;  // keys per block
constexpr int kBQ = 64;  // query rows per tile
constexpr int kStages = 2;
constexpr int kWG = 2;         // consumer warpgroups, each over half the block's items
constexpr int kThreads = 128 * kWG;  // no producer warp: 256 threads may use 255 registers

template <int HD>
struct Shape {
  static constexpr int kFB = (HD + kBox - 1) / kBox;  // feature boxes per row
  static constexpr int kTileBytes = kFB * kBoxBytes;  // 64 rows of q, dO, k or v
  static constexpr int kStageBytes = 2 * kTileBytes;  // q, then dO
  // K and V, then each warpgroup's ring (warpgroup 1's later holds its dK
  // and dV sums for warpgroup 0: 2 x 64 x HD floats, at most a ring)
  static constexpr int kSmem = 2 * kTileBytes + kWG * kStages * kStageBytes + kSwizzleAtom;
  static constexpr int kO = HD / 2;  // accumulator floats of 64 x HD
  static_assert(2 * kBK * HD * 4 <= kStages * kStageBytes, "the hand-off fits a ring");
};

template <int HD, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int q_off,
                    int H, int KV, float scale, float softcap, int window) {
  using G = Shape<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWG][kStages];
  __shared__ __align__(8) uint64_t kvbar;
  __shared__ float slse[kWG][kStages][kBQ];
  __shared__ float sdelta[kWG][kStages][kBQ];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sk = smem;
  uint8_t* sv = smem + G::kTileBytes;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int n_rep = H / KV;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  uint8_t* ring = smem + 2 * G::kTileBytes + wg * kStages * G::kStageBytes;
  // the query tiles that see this key tile: from the one holding the first
  // row whose position reaches its first key (causal) to the last row
  // within the window of its last key
  const int k_last = min(k0 + kBK, Sk) - 1;
  const int q_end = window > 0 ? min(Sq, max(0, k_last + window - q_off)) : Sq;
  const int qt_begin = kCausal ? max(0, k0 - q_off) / kBQ : 0;
  const int n_q = max(0, (q_end + kBQ - 1) / kBQ - qt_begin);
  // warpgroup wg's items: the query heads wg, wg + 2, ... (n_rep even), or
  // items wg, wg + 2, ... of the list ordered by (head, tile) (n_rep odd)
  const bool by_head = n_rep % 2 == 0;
  const int items = by_head ? n_rep / kWG * n_q : (n_rep * n_q - wg + kWG - 1) / kWG;

  if (tid == 0) {
    for (int w = 0; w < kWG; ++w)
      for (int s = 0; s < kStages; ++s) mbar_init(&full[w][s], 1);  // the expect_tx arrival
    mbar_init(&kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // item it of this warpgroup: the list's entry g (head g / n_q of the KV
  // head's group, query tile g % n_q), rows q0 .. q0 + 63; its q and dO come
  // by TMA (issued by thread 0 of the warpgroup), its lse and delta through
  // registers into shared memory
  auto entry_of = [&](int it) {
    return by_head ? (wg + kWG * (it / n_q)) * n_q + it % n_q : wg + kWG * it;
  };
  auto head_of = [&](int it) { return hk * n_rep + entry_of(it) / n_q; };
  auto rows_of = [&](int it) { return (qt_begin + entry_of(it) % n_q) * kBQ; };
  auto issue = [&](int it) {
    const int s = it % kStages, h = head_of(it), q0 = rows_of(it);
    uint8_t* st = ring + s * G::kStageBytes;
    mbar_expect_tx(&full[wg][s], G::kStageBytes);  // every box's bytes, zero fill included
    for (int f = 0; f < G::kFB; ++f) {
      tma_head_box(st + f * kBoxBytes, &mq, &full[wg][s], f * kBox, h, q0, b);
      tma_head_box(st + G::kTileBytes + f * kBoxBytes, &mdo, &full[wg][s], f * kBox, h, q0, b);
    }
  };
  // thread lt holds lse (lt < 64) or delta (lt >= 64) of row lt % 64
  auto row_stat = [&](int it) {
    const int row = rows_of(it) + lt % kBQ;
    const size_t at = ((size_t)b * H + head_of(it)) * Sq + row;
    return row < Sq ? (lt < kBQ ? lse[at] : delta[at]) : 0.0f;
  };
  auto put_stat = [&](int it, float v) {
    float* dst = lt < kBQ ? slse[wg][it % kStages] : sdelta[wg][it % kStages];
    dst[lt % kBQ] = v;
  };

  if (tid == 0) {
    prefetch_map(&mq);
    prefetch_map(&mdo);
    mbar_expect_tx(&kvbar, 2 * G::kTileBytes);
    for (int f = 0; f < G::kFB; ++f) {
      tma_head_box(sk + f * kBoxBytes, &mk, &kvbar, f * kBox, hk, k0, b);
      tma_head_box(sv + f * kBoxBytes, &mv, &kvbar, f * kBox, hk, k0, b);
    }
  }
  for (int it = 0; it < kStages && it < items; ++it) {
    if (lt == 0) issue(it);
    put_stat(it, row_stat(it));
  }
  named_barrier(1 + wg, 128);

  // --- keys k0 + 16 warp + g (a) and + 8 (b) of this warpgroup's dK, dV ------
  const int lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int kl_a = (lt / 32) * 16 + g;  // the tile rows of keys a and b
  const int key_a = k0 + kl_a, key_b = key_a + 8;
  float dka[G::kO], dva[G::kO];
#pragma unroll
  for (int i = 0; i < G::kO; ++i) dka[i] = dva[i] = 0.0f;
  mbar_wait(&kvbar, 0);

  for (int it = 0; it < items; ++it) {
    const int s = it % kStages;
    const int q0 = rows_of(it);
    const uint8_t* sq = ring + s * G::kStageBytes;
    const uint8_t* sdo = sq + G::kTileBytes;
    // the statistics of the item this stage takes next, fetched early
    const float next_stat = it + kStages < items ? row_stat(it + kStages) : 0.0f;
    mbar_wait(&full[wg][s], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T over hd
    float st[32], dpt[32], tmp[32];
    tile_dot<HD>(st, tmp, sk, sq);
    tile_dot<HD>(dpt, tmp, sv, sdo);

    // p and ds in place: element 4 c + e is key (e < 2 ? a : b), row q0 +
    // 8 c + 2 tig + (e & 1)
    uint32_t ties = 0;  // elements whose p or ds lies near a bf16 rounding tie
    const bool whole = (!kCausal || q_off + q0 >= k0 + kBK - 1) && q0 + kBQ <= Sq &&
                       k0 + kBK <= Sk && (window <= 0 || q_off + q0 + kBQ - 1 - k0 < window);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * c + 2 * tig + (e & 1);
        const int idx = 4 * c + e;
        const bool ok =
            whole || attend<kCausal>(q0 + r, e < 2 ? key_a : key_b, Sq, Sk, q_off, window);
        float p, ds;
        p_ds(st[idx], dpt[idx], slse[wg][s][r], sdelta[wg][s][r], ok, scale, softcap, p, ds);
        st[idx] = p;
        dpt[idx] = ds;
        if ((p >= kTieP && near_tie(p)) || (fabsf(ds) >= kTieDs && near_tie(ds)))
          ties |= 1u << idx;
      }
    }
    // where the tensor cores' sums decide a bf16 rounding that matters, take
    // the logit and dp again as fmaf chains: each lane one flagged element
    // at a time, written back by a select (registers take no runtime index)
    while (__any_sync(0xffffffffu, ties != 0)) {
      const int at = ties ? __ffs(ties) - 1 : -1;
      float p = 0.0f, ds = 0.0f;
      if (at >= 0) {
        ties &= ties - 1;
        const int r = 8 * (at / 4) + 2 * tig + (at & 1);
        const int kl = kl_a + (at % 4 < 2 ? 0 : 8);
        p_ds(row_dot<HD>(sk, kl, sq, r), row_dot<HD>(sv, kl, sdo, r), slse[wg][s][r],
             sdelta[wg][s][r], true, scale, softcap, p, ds);
      }
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        if (at == idx) {
          st[idx] = p;
          dpt[idx] = ds;
        }
      }
    }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      rs_fragment(pa[kk], st, kk);
      rs_fragment(da[kk], dpt, kk);
    }

    // dV += P^T dO, dK += dS^T Q: k16 slices 16 rows (2 KB) apart, the
    // next feature box (8 KB) along N
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      rs_product<HD>(dva, pa[kk], smem_desc(sdo + kk * 2048, kBoxBytes, kSwizzleAtom));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      rs_product<HD>(dka, da[kk], smem_desc(sq + kk * 2048, kBoxBytes, kSwizzleAtom));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);

    // the stage is read: refill it with the item two ahead
    named_barrier(1 + wg, 128);
    if (it + kStages < items) {
      if (lt == 0) issue(it + kStages);
      put_stat(it + kStages, next_stat);
    }
  }

  // --- the two warpgroups' sums, added in a fixed order -----------------------
  float* part = reinterpret_cast<float*>(smem + 2 * G::kTileBytes + kStages * G::kStageBytes);
  if (wg == 1) {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int col = 8 * c + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = part + (kl_a + 8 * half) * HD + col;
        *reinterpret_cast<float2*>(row) = make_float2(dka[4 * c + 2 * half], dka[4 * c + 2 * half + 1]);
        *reinterpret_cast<float2*>(row + kBK * HD) =
            make_float2(dva[4 * c + 2 * half], dva[4 * c + 2 * half + 1]);
      }
    }
  }
  __syncthreads();
  if (wg == 1) return;
  const size_t stride = (size_t)KV * HD;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int col = 8 * c + 2 * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_a + 8 * half;
      if (key >= Sk) continue;
      const float* row = part + (kl_a + 8 * half) * HD + col;
      const float2 k1 = *reinterpret_cast<const float2*>(row);
      const float2 v1 = *reinterpret_cast<const float2*>(row + kBK * HD);
      const size_t at = ((size_t)b * Sk + key) * stride + (size_t)hk * HD + col;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2((dka[4 * c + 2 * half] + k1.x) * scale, (dka[4 * c + 2 * half + 1] + k1.y) * scale);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(dva[4 * c + 2 * half] + v1.x, dva[4 * c + 2 * half + 1] + v1.y);
    }
  }
}

template <int HD, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int q_off, int H,
           int KV, float scale, float softcap, int window, cudaStream_t stream) {
  using G = Shape<HD>;
  CUtensorMap mq, mdo, mk, mv;
  int rc = encode_heads(&mq, q, B, Sq, H, HD);
  if (rc == 0) rc = encode_heads(&mdo, dout, B, Sq, H, HD);
  if (rc == 0) rc = encode_heads(&mk, k, B, Sk, KV, HD);
  if (rc == 0) rc = encode_heads(&mv, v, B, Sk, KV, HD);
  if (rc != 0) return rc;
  auto kernel = flash_dkv_tc_kernel<HD, kCausal>;
  static SmemOptIn opt_in;
  rc = opt_in.apply(kernel, G::kSmem);
  if (rc != 0) return rc;
  const dim3 grid(KV, B, (Sk + kBK - 1) / kBK);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, q_off, H, KV, scale, softcap,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCausal>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int B, int Sq, int Sk,
                int q_off, int H, int KV, float scale, float softcap, int window,
                cudaStream_t stream) {
#define REPRO_DKV_TC_LAUNCH(HD)                                                           \
  return launch<HD, kCausal>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, q_off, H, KV, \
                             scale, softcap, window, stream)
  switch (hd) {
    case 64: REPRO_DKV_TC_LAUNCH(64);
    case 80: REPRO_DKV_TC_LAUNCH(80);
    case 112: REPRO_DKV_TC_LAUNCH(112);
    case 128: REPRO_DKV_TC_LAUNCH(128);
    default: break;
  }
#undef REPRO_DKV_TC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// q, dout: (B, Sq, H, hd) at positions q0 .. q0 + Sq - 1; k, v: (B, Sk,
// KV, hd) at positions 0 .. Sk - 1, bf16, contiguous, 16-byte aligned; lse,
// delta: (B, H, Sq) float32 -> dk, dv: (B, Sk, KV, hd) float32, summed over
// each KV head's H / KV query heads (self-attention: q0 = 0, Sk = Sq).  dtype must be 1
// (bfloat16); hd 64, 80, 112 or 128; softcap <= 0 means none, window <= 0
// means none; causal 0 or 1.  The signature is flash_dkv_bwd's.  Returns the launch's cudaError_t
// (0 on success), or repro::tc::kTensorMapError + the CUresult when a tensor
// map cannot be made.
extern "C" int flash_dkv_tc_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, int B, int Sq, int Sk, int q0, int H, int KV, int hd,
                                float scale, float softcap, int window, int causal,
                                void* stream) {
  using namespace repro;
  if (dtype != kBFloat16 || (causal != 0 && causal != 1) || B < 1 || B > 65535 || Sq < 1 ||
      Sk < 1 || q0 < 0 || KV < 1 || KV > 65535 || H % KV != 0 || (Sk + kBK - 1) / kBK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (causal)
    return dispatch_hd<true>(hd, q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, q0, H, KV, scale,
                             softcap, window, s);
  return dispatch_hd<false>(hd, q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, q0, H, KV, scale,
                            softcap, window, s);
}

extern "C" const char* flash_dkv_tc_error(int code) { return repro::tc::error_string(code); }
