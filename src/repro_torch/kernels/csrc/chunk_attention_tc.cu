// Chunk attention forward on Hopper's tensor cores (sm_90a), bf16 q, k, v:
// streaming-softmax attention of queries at explicit absolute positions
// over keys at explicit absolute positions with a per-key validity mask.
//
// Replaces, on bf16 inputs at head dims 64 and 128: _flash_fwd_kernel in
// repro/kernels/attention.py (reached through _flash_forward by
// chunk_attention, and by flash_attention's forward).  float32 inputs and
// head dim 32 take chunk_attention.cu, the FMA kernel.
//
// Numerics follow the reference kernel: scale hd**-0.5 after the q.k dot,
// the tanh softcap BEFORE the mask, an additive -1e30 bias (never -inf) for
// the causal, window, invalid-key and padded-row masks, float32 m/l/acc, p
// rounded to bf16 before the PV product, l_safe = max(l, 1e-30), and lse = m
// + log(l_safe) beside the output.
//
// Layout.  q (B, C, H, hd) and k, v (B, Sk, KV, hd) are viewed as (B, rows,
// heads * hd) for the TMA tensor maps; the column offset picks the head.
// Boxes are 64 features x 64 rows with the 128-byte swizzle, so hd 128 takes
// two boxes per row.  One warpgroup owns 64 query rows of one head; a block
// holds WG (1 or 2) of them, and its thread 0 loads the block's q once and
// then K/V tiles of 128 keys through a 2-stage ring (mbarriers), refilling
// a stage once every warpgroup has read it (no producer warp: see kThreads).  Per key tile a warpgroup forms S = Q K^T with wgmma (both
// operands in shared memory, K-major, hd / 16 k16 steps), runs the softmax
// in registers, and adds P V into its 64 x hd float32 accumulator with P in
// registers (the accumulator's layout is the A fragment's, rounded to bf16)
// and V from shared memory, MN-major (transpose bit set): 8 k16 steps a
// tile, rescaled per tile.
//
// Skipping key tiles, by position.  Before any load the block reads its
// rows' q_pos and every key's k_pos and k_valid, and lists the tiles in
// which some key is valid, at or before the block's last live position
// (causal) and inside the window of its first one: the tiles it skips hold
// no (row, key) pair that attends, so they add exactly 0 to every row that
// attends some key.  A tile every live row attends in full (and a block with
// no padded row) is marked, and its scores skip the masking.  A row that
// attends no key at all (a padded row at q_pos < 0, or a live row whose keys
// are all masked) takes, in the reference, the uniform mean of v over all Sk
// keys with lse = -1e30 + log(Sk); skipped tiles would change that, so such
// a row is recognised after the loop (its running max is still -1e30) and
// its output is that mean, summed over all Sk keys by its warpgroup.  Keys
// are not assumed monotonic: a serving chunk's keys are a prior table
// (sentinel tail included) followed by the chunk's own keys.  Every block
// adds the tiles it listed, and all tiles of its key range, to two device
// counters (one atomic each a block), which chunk_attention_tc_key_tiles
// reads and resets: the visited share is the kernel's own count.
//
// Order and fill.  Grid (H, B, row blocks), the latest row blocks (the most
// keys under causality) launched first.  WG is 2 (128 rows a block) where
// that still gives a block to every SM, else 1 (the serving chunk, C 256 at
// 32 heads: 128 blocks of 64 rows instead of 64 of 128).
//
// What bounds it on the H100: FLOPs, 4 hd per attended (row, key) pair at
// the bf16 tensor-core rate (989 TFLOP/s), where the context is long; the
// bytes of q, k, v and out where it is short.

#include <climits>

#include <math_constants.h>

#include "hopper.cuh"

namespace repro {
namespace {

using namespace tc;

constexpr int kBK = 128;           // keys per tile
constexpr int kStages = 2;
constexpr int kMaxTiles = 512;     // key tiles a block lists: Sk <= 65536
constexpr int kFullBit = 1 << 16;  // a listed tile every live row attends in full
// The mask is written for both forms; only the causal one is instantiated.
constexpr bool kCausal = true;

// key tiles listed, and key tiles in all, summed over the blocks of every
// launch since the last reset
__device__ unsigned long long key_tiles[2];

template <int HD, int WG>
struct Shape {
  static constexpr int kFB = HD / kBox;          // feature boxes per row
  static constexpr int kKB = kBK / kBox;         // key boxes per tile
  static constexpr int kQBytes = kBox * HD * 2;  // one warpgroup's 64 rows of q
  static constexpr int kKVBytes = kBK * HD * 2;  // one tile of K (or V)
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kSmem = WG * kQBytes + kStages * kStageBytes + kSwizzleAtom;
  static constexpr int kRows = WG * kBox;
  // the consumer warpgroups alone: their thread 0 issues the loads (a
  // producer warp would make 288 threads, which ptxas gives 168 registers
  // a thread, too few for these accumulators; 256 threads get 255)
  static constexpr int kThreads = WG * 128;
  static constexpr int kO = HD / 2;               // accumulator floats of 64 x HD
};

// Whether a query at position qp attends a valid key at kp (a negative qp
// is a padded row).
__device__ __forceinline__ bool attends(int qp, int kp, int window) {
  if (qp < 0) return false;
  const int rel = qp - kp;
  return (!kCausal || rel >= 0) && (window <= 0 || rel < window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD, int WG>
__global__ void __launch_bounds__(Shape<HD, WG>::kThreads, 1)
chunk_attention_tc_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos, const int* __restrict__ k_valid,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int C,
                          int Sk, int H, int KV, float scale, float softcap, int window) {
  using G = Shape<HD, WG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(8) uint64_t qbar;
  __shared__ int tiles[kMaxTiles];
  __shared__ int tile_all[kMaxTiles];
  __shared__ int n_listed, qmin, qmax, dead;
  __shared__ int need_mean[WG];
  __shared__ float colsum[WG][128];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* skv = smem + WG * G::kQBytes;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * G::kRows;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x;
  const int n_tiles = (Sk + kBK - 1) / kBK;

  // --- the block's tile list, from positions -------------------------------
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);    // thread 0's expect_tx arrival
      mbar_init(&empty[s], WG);  // one arrival per consumer warpgroup
    }
    mbar_init(&qbar, 1);
    mbar_init_fence();
    qmin = INT_MAX;
    qmax = -1;
    dead = 0;
  }
  if (tid < WG) need_mean[tid] = 0;
  for (int t = tid; t < n_tiles; t += G::kThreads) {
    tiles[t] = 0;
    tile_all[t] = 1;
  }
  __syncthreads();
  for (int r = tid; r < G::kRows; r += G::kThreads) {
    if (q0 + r >= C) continue;  // past the chunk: not a row at all
    const int p = __ldg(q_pos + q0 + r);
    if (p >= 0) {
      atomicMin(&qmin, p);
      atomicMax(&qmax, p);
    } else {
      dead = 1;
    }
  }
  __syncthreads();
  const int lo = qmin, hi = qmax;  // hi < 0: no live row
  for (int j = tid; j < n_tiles * kBK; j += G::kThreads) {
    const int t = j / kBK;
    if (j >= Sk) {
      tile_all[t] = 0;
      continue;
    }
    const int kp = __ldg(k_pos + j);
    const bool ok = __ldg(k_valid + j) != 0;
    // some live row may attend key j / every live row attends it
    if (hi >= 0 && ok && (!kCausal || kp <= hi) && (window <= 0 || kp > lo - window))
      tiles[t] = 1;
    if (!(ok && (!kCausal || kp <= lo) && (window <= 0 || kp > hi - window))) tile_all[t] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < n_tiles; ++t)
      if (tiles[t]) tiles[n++] = t | (tile_all[t] && !dead ? kFullBit : 0);
    n_listed = n;
    atomicAdd(&key_tiles[0], static_cast<unsigned long long>(n));
    atomicAdd(&key_tiles[1], static_cast<unsigned long long>(n_tiles));
  }
  __syncthreads();
  const int n = n_listed;
  const int wg = tid / 128;

  // --- loads: thread 0 issues q, then the listed K/V tiles ------------------
  // K: [feature box][key box] (a K-major B of 128 rows per feature box); V:
  // [key box][feature box] (an MN-major B, k16 steps along the keys)
  auto issue_kv = [&](int i) {
    const int s = i % kStages;
    const int key0 = (tiles[i] & (kFullBit - 1)) * kBK;
    uint8_t* sk = skv + s * G::kStageBytes;
    uint8_t* sv = sk + G::kKVBytes;
    mbar_expect_tx(&full[s], G::kStageBytes);
    for (int f = 0; f < G::kFB; ++f)
      for (int kb = 0; kb < G::kKB; ++kb) {
        tma_box(sk + (f * G::kKB + kb) * kBoxBytes, &mk, &full[s], hk * HD + f * kBox,
                key0 + kb * kBox, b);
        tma_box(sv + (kb * G::kFB + f) * kBoxBytes, &mv, &full[s], hk * HD + f * kBox,
                key0 + kb * kBox, b);
      }
  };
  if (tid == 0) {
    prefetch_map(&mq);
    prefetch_map(&mk);
    prefetch_map(&mv);
    mbar_expect_tx(&qbar, WG * G::kQBytes);
    for (int w = 0; w < WG; ++w)
      for (int f = 0; f < G::kFB; ++f)
        tma_box(sq + w * G::kQBytes + f * kBoxBytes, &mq, &qbar, h * HD + f * kBox,
                q0 + w * kBox, b);
    for (int i = 0; i < kStages && i < n; ++i) issue_kv(i);
  }

  // --- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 -------------------
  const int lt = tid % 128, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int row_a = q0 + wg * kBox + (lt / 32) * 16 + g, row_b = row_a + 8;
  const int qp_a = row_a < C ? __ldg(q_pos + row_a) : -1;
  const int qp_b = row_b < C ? __ldg(q_pos + row_b) : -1;
  const uint8_t* my_q = sq + wg * G::kQBytes;

  float o[G::kO];
#pragma unroll
  for (int i = 0; i < G::kO; ++i) o[i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;  // l: this thread's part
  mbar_wait(&qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int entry = tiles[i];
    const int key0 = (entry & (kFullBit - 1)) * kBK;
    const uint8_t* sk = skv + s * G::kStageBytes;
    const uint8_t* sv = sk + G::kKVBytes;
    mbar_wait(&full[s], (i / kStages) & 1);

    // S = Q K^T, contracting over hd: a k16 slice is 32 bytes further along
    // each 128-byte row, the next feature box every 4 slices
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t da = smem_desc(my_q + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, kSwizzleAtom);
      const uint64_t db =
          smem_desc(sk + (kk / 4) * G::kKB * kBoxBytes + (kk % 4) * 32, 16, kSwizzleAtom);
      wgmma_m64n128k16_k(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the logits: thread element 4 c + e is row (e < 2 ? a : b), key
    // key0 + 8 c + 2 tig + (e & 1)
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) {
      float x = sc[i2] * scale;
      if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
      sc[i2] = x;
    }
    if (!(entry & kFullBit)) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * c + 2 * tig + e;
          if (key >= Sk) {  // past the keys: not a key at all
            sc[4 * c + e] = sc[4 * c + 2 + e] = -CUDART_INF_F;
            continue;
          }
          const int kp = __ldg(k_pos + key);
          const bool kok = __ldg(k_valid + key) != 0;
          if (!(kok && attends(qp_a, kp, window))) sc[4 * c + e] += kNegInf;
          if (!(kok && attends(qp_b, kp, window))) sc[4 * c + 2 + e] += kNegInf;
        }
      }
    }

    // the streaming softmax; a row's statistics are shared by its quad
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      sc[4 * c] = expf(sc[4 * c] - mn_a);
      sc[4 * c + 1] = expf(sc[4 * c + 1] - mn_a);
      sc[4 * c + 2] = expf(sc[4 * c + 2] - mn_b);
      sc[4 * c + 3] = expf(sc[4 * c + 3] - mn_b);
      sum_a += sc[4 * c] + sc[4 * c + 1];
      sum_b += sc[4 * c + 2] + sc[4 * c + 3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      o[4 * c] *= corr_a;
      o[4 * c + 1] *= corr_a;
      o[4 * c + 2] *= corr_b;
      o[4 * c + 3] *= corr_b;
    }

    // O += P V: P in bf16 registers (all 8 fragments made before the first
    // product reads them), V's k16 slices 16 keys (2 KB) apart in a key box
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) rs_fragment(pa[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = smem_desc(sv + (kk / 4) * G::kFB * kBoxBytes + (kk % 4) * 2048,
                                    kBoxBytes, kSwizzleAtom);
      rs_product<HD>(o, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lt == 0) mbar_arrive(&empty[s]);
    // every warpgroup has read stage s: refill it with the tile two ahead
    if (tid == 0 && i + kStages < n) {
      mbar_wait(&empty[s], (i / kStages) & 1);
      issue_kv(i + kStages);
    }
  }

  // --- rows that attend no key: the uniform mean of v over all Sk keys ------
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const bool mean_a = m_a < 0.5f * kNegInf, mean_b = m_b < 0.5f * kNegInf;
  if ((mean_a && row_a < C) || (mean_b && row_b < C)) need_mean[wg] = 1;
  named_barrier(1 + wg, 128);
  constexpr int kParts = 128 / HD;  // threads per column
  if (need_mean[wg]) {
    const int col = lt % HD;
    float acc = 0.0f;
    for (int j = lt / HD; j < Sk; j += kParts)
      acc += __bfloat162float(v[(((size_t)b * Sk + j) * KV + hk) * HD + col]);
    colsum[wg][lt] = acc;
    named_barrier(1 + wg, 128);
  }

  const float ls_a = fmaxf(l_a, 1e-30f), ls_b = fmaxf(l_b, 1e-30f);
  const float inv_sk = 1.0f / static_cast<float>(Sk);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int col = 8 * c + 2 * tig;
    float mean0 = 0.0f, mean1 = 0.0f;
    if (mean_a || mean_b) {
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        mean0 += colsum[wg][p * HD + col];
        mean1 += colsum[wg][p * HD + col + 1];
      }
      mean0 *= inv_sk;
      mean1 *= inv_sk;
    }
    if (row_a < C) {
      const __nv_bfloat162 val = mean_a ? __floats2bfloat162_rn(mean0, mean1)
                                        : __floats2bfloat162_rn(o[4 * c] / ls_a, o[4 * c + 1] / ls_a);
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * C + row_a) * H + h) * HD + col) = val;
    }
    if (row_b < C) {
      const __nv_bfloat162 val = mean_b ? __floats2bfloat162_rn(mean0, mean1)
                                        : __floats2bfloat162_rn(o[4 * c + 2] / ls_b, o[4 * c + 3] / ls_b);
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * C + row_b) * H + h) * HD + col) = val;
    }
  }
  if (tig == 0) {
    const float uniform = kNegInf + logf(static_cast<float>(Sk));
    if (row_a < C) lse[((size_t)b * H + h) * C + row_a] = mean_a ? uniform : m_a + logf(ls_a);
    if (row_b < C) lse[((size_t)b * H + h) * C + row_b] = mean_b ? uniform : m_b + logf(ls_b);
  }
}

template <int HD, int WG>
int launch(const void* q, const void* k, const void* v, const void* q_pos, const void* k_pos,
           const void* k_valid, void* out, void* lse, int B, int C, int Sk, int H, int KV,
           float scale, float softcap, int window, cudaStream_t stream) {
  using G = Shape<HD, WG>;
  CUtensorMap mq, mk, mv;
  int rc = encode_rows(&mq, q, B, C, H * HD);
  if (rc == 0) rc = encode_rows(&mk, k, B, Sk, KV * HD);
  if (rc == 0) rc = encode_rows(&mv, v, B, Sk, KV * HD);
  if (rc != 0) return rc;
  auto kernel = chunk_attention_tc_kernel<HD, WG>;
  static SmemOptIn opt_in;
  rc = opt_in.apply(kernel, G::kSmem);
  if (rc != 0) return rc;
  const dim3 grid(H, B, (C + G::kRows - 1) / G::kRows);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      mq, mk, mv, static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<const int*>(k_valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), C, Sk, H, KV, scale, softcap,
      window);
  return static_cast<int>(cudaGetLastError());
}

// 128-row blocks where they still give every SM a block, else 64-row ones.
template <int HD>
int launch_rows(const void* q, const void* k, const void* v, const void* q_pos,
                const void* k_pos, const void* k_valid, void* out, void* lse, int B, int C,
                int Sk, int H, int KV, float scale, float softcap, int window,
                cudaStream_t stream) {
  int sms = 0;
  const int rc = device_sms(&sms);
  if (rc != 0) return rc;
  const long long wide = (long long)((C + 127) / 128) * H * B;
  if (wide >= sms)
    return launch<HD, 2>(q, k, v, q_pos, k_pos, k_valid, out, lse, B, C, Sk, H, KV, scale,
                         softcap, window, stream);
  return launch<HD, 1>(q, k, v, q_pos, k_pos, k_valid, out, lse, B, C, Sk, H, KV, scale,
                       softcap, window, stream);
}

}  // namespace
}  // namespace repro

// q: (B, C, H, hd); k, v: (B, Sk, KV, hd), bf16, contiguous, 16-byte
// aligned; q_pos: (C,) int32; k_pos, k_valid: (Sk,) int32 -> out: (B, C, H,
// hd) bf16, lse: (B, H, C) float32.  dtype must be 1 (bfloat16); hd 64 or
// 128; Sk <= 65536; softcap <= 0 means none, window <= 0 means none.  The
// signature is chunk_attention_fwd's.  Returns the launch's cudaError_t (0 on
// success), or repro::tc::kTensorMapError + the CUresult when a tensor map
// cannot be made.
extern "C" int chunk_attention_tc_fwd(int dtype, const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos,
                                      const void* k_valid, void* out, void* lse, int B, int C,
                                      int Sk, int H, int KV, int hd, float scale, float softcap,
                                      int window, void* stream) {
  using namespace repro;
  if (dtype != kBFloat16 || B < 1 || B > 65535 || C < 1 || Sk < 1 || KV < 1 || H % KV != 0 ||
      H > 65535 || (Sk + kBK - 1) / kBK > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_rows<128>(q, k, v, q_pos, k_pos, k_valid, out, lse, B, C, Sk, H, KV, scale,
                            softcap, window, s);
  if (hd == 64)
    return launch_rows<64>(q, k, v, q_pos, k_pos, k_valid, out, lse, B, C, Sk, H, KV, scale,
                           softcap, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// counts[0]: key tiles the kernel's blocks listed (loaded and multiplied),
// counts[1]: key tiles in all, over every launch on the current device since
// the last reset; reset != 0 zeroes them after the read.  Synchronous.
// Returns a cudaError_t (0 on success).
extern "C" int chunk_attention_tc_key_tiles(unsigned long long* counts, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(counts, repro::key_tiles, sizeof(repro::key_tiles));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    err = cudaMemcpyToSymbol(repro::key_tiles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}

extern "C" const char* chunk_attention_tc_error(int code) { return repro::tc::error_string(code); }
