// Chunk attention forward for Hopper (sm_90a): streaming-softmax attention of
// queries at explicit absolute positions over keys at explicit absolute
// positions with a per-key validity mask, causal or not.
//
// Replaces: _flash_fwd_kernel in repro/kernels/attention.py (reached through
// _flash_forward by chunk_attention, and by flash_attention's forward).
// The float32 route, bf16 at hd 16 and 32, and bf16 over more keys than
// chunk_attention_tc.cu's tile list holds (65536); bf16 at hd 64, 80, 112
// and 128 otherwise takes chunk_attention_tc.cu, and this kernel's bf16
// instances there are reached only past that cap or to compare the two
// kernels (kernels/attention.py's _chunk_launch).
//
// Numerics follow the reference kernel: scale hd**-0.5 after the q.k dot,
// tanh softcap BEFORE the mask, an additive -1e30 bias (never -inf) for
// the causal, window, invalid-key and padded-row masks, float32 m/l/acc,
// p rounded to v's type before the PV product, l_safe = max(l, 1e-30), and
// lse = m + log(l_safe) written beside the output.  The mask is the
// reference's _block_bias: a valid row and key, rel = q_pos - k_pos >= 0
// under causality, and rel < window where a window is set (without
// causality that cuts one side only: a row sees every later key).
// Validity comes only from the sentinels: a query row with q_pos < 0 is
// padding, a key with k_valid == 0 is garbage.  Positions are absolute and
// may exceed the array bounds (chunked prefill over a sentinel-padded prior
// table).  Causality is a template parameter: the inner loop has no branch
// on it.
//
// Grid: one block per (16-row query tile, query head, batch row); the TPU's
// sequential KV grid axis becomes the loop over 32-key tiles of KV head
// h / n_rep, staged through shared memory as float32.  Each of the 4 warps
// owns 4 query rows; in the score phase lane j scores key j of the tile for
// its warp's rows, in the PV phase lane l owns head-dim columns l, l+32, ...
// below HD (at HD 80 and 112 the last round has 16 live lanes).
//
// What bounds it on the H100: FLOPs (4*C*Sk*H*hd) at long prior context,
// bytes (q, k, v, out) at short context.  This first version runs the dots on
// the float32 FMA pipes (67 TFLOP/s peak), not the tensor cores (989 bf16),
// so it sits far from the FLOP bound; wgmma tiles with TMA staging are a
// later step.  Shared memory at hd=128 is 41 KB (16x132 q, 32x132 k, 32x128
// v floats), under the 48 KB static limit, which is why the tiles are small.
// The padded row of HD + 4 floats ends 4 (hd 32, 64, 128) or 20 (hd 16, 80, 112)
// words past a multiple of 32 banks, so the 8 lanes of a float4 phase start
// on distinct 4-bank groups: no bank conflicts at any instantiated head dim.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 16;               // query rows per block
constexpr int kBK = 32;               // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;   // query rows per warp

template <typename T, int HD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, const int* __restrict__ k_valid,
                       T* __restrict__ out, float* __restrict__ lse, int C, int Sk,
                       int H, int KV, float scale, float softcap, int window) {
  constexpr int LD = HD + 4;  // padded row: float4-aligned, no bank conflicts
  constexpr int PER_LANE = Cols<HD>::per_lane;
  constexpr int VEC = Vec16<T>::n;
  __shared__ __align__(16) float sq[kBQ * LD];
  __shared__ __align__(16) float sk[kBK * LD];
  __shared__ __align__(16) float sv[kBK * HD];
  __shared__ int skpos[kBK];
  __shared__ int skok[kBK];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * kRows;  // first tile row of this warp

  for (int e = tid * VEC; e < kBQ * HD; e += kThreads * VEC) {
    const int r = e / HD, d = e % HD, row = q0 + r;
    float buf[VEC];
    if (row < C) {
      load16<T>(q + (((size_t)b * C + row) * H + h) * HD + d, buf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) buf[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sq[r * LD + d + i] = buf[i];
  }

  int qp[kRows];
  float m[kRows], l[kRows], acc[kRows][PER_LANE];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    qp[r] = row < C ? q_pos[row] : -(1 << 30);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[r][i] = 0.f;
  }
  const bool warp_live = q0 + r0 < C;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (first pass: q is staged)
    for (int e = tid * VEC; e < kBK * HD; e += kThreads * VEC) {
      const int j = e / HD, d = e % HD, key = k0 + j;
      float kb[VEC], vb[VEC];
      if (key < Sk) {
        const size_t off = (((size_t)b * Sk + key) * KV + hk) * HD + d;
        load16<T>(k + off, kb);
        load16<T>(v + off, vb);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kb[i] = vb[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sk[j * LD + d + i] = kb[i];
        sv[j * HD + d + i] = vb[i];
      }
    }
    if (tid < kBK) {
      const int key = k0 + tid;
      skpos[tid] = key < Sk ? k_pos[key] : 0;
      skok[tid] = key < Sk ? (k_valid[key] != 0) : 0;
    }
    __syncthreads();
    if (!warp_live) continue;  // all of this warp's rows are past C

    // scores: lane j scores key k0 + j against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(sk + lane * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(sq + (r0 + r) * LD)[d4];
        s[r] = dot4(qq, kk, s[r]);
      }
    }
    const int kp = skpos[lane];
    const bool kok = skok[lane] != 0;
    const bool in_range = k0 + lane < Sk;  // keys past Sk are not keys at all

    float pv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float x = s[r] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      const int rel = qp[r] - kp;
      bool ok = kok && qp[r] >= 0 && (!kCausal || rel >= 0);
      if (window > 0) ok = ok && rel < window;
      x += ok ? 0.f : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(in_range ? x : kNegInf));
      const float corr = expf(m[r] - m_new);
      float p = in_range ? expf(x - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      pv[r] = to_f<T>(from_f<T>(p));  // p in v's type before the PV product
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[r][i] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[PER_LANE];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        vj[i] = Cols<HD>::live(lane, i) ? sv[j * HD + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pv[r], j);
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= C) continue;
    const float ls = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (Cols<HD>::live(lane, i))
        out[(((size_t)b * C + row) * H + h) * HD + lane + 32 * i] = from_f<T>(acc[r][i] / ls);
    if (lane == 0) lse[((size_t)b * H + h) * C + row] = m[r] + logf(ls);
  }
}

template <typename T, int HD, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, const void* k_valid, void* out, void* lse, int B, int C,
           int Sk, int H, int KV, float scale, float softcap, int window,
           cudaStream_t stream) {
  const dim3 grid((C + kBQ - 1) / kBQ, H, B);
  chunk_attention_kernel<T, HD, kCausal><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
      static_cast<const int*>(k_valid), static_cast<T*>(out), static_cast<float*>(lse),
      C, Sk, H, KV, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kCausal>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* q_pos,
                const void* k_pos, const void* k_valid, void* out, void* lse, int B,
                int C, int Sk, int H, int KV, float scale, float softcap, int window,
                cudaStream_t stream) {
#define REPRO_CHUNK_LAUNCH(HD)                                                          \
  return launch<T, HD, kCausal>(q, k, v, q_pos, k_pos, k_valid, out, lse, B, C, Sk, H, \
                                KV, scale, softcap, window, stream)
  switch (hd) {
    case 16: REPRO_CHUNK_LAUNCH(16);
    case 32: REPRO_CHUNK_LAUNCH(32);
    case 64: REPRO_CHUNK_LAUNCH(64);
    case 80: REPRO_CHUNK_LAUNCH(80);
    case 112: REPRO_CHUNK_LAUNCH(112);
    case 128: REPRO_CHUNK_LAUNCH(128);
    default:
      break;
  }
#undef REPRO_CHUNK_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int causal, int hd, const void* q, const void* k, const void* v,
             const void* q_pos, const void* k_pos, const void* k_valid, void* out, void* lse,
             int B, int C, int Sk, int H, int KV, float scale, float softcap, int window,
             cudaStream_t stream) {
  if (causal)
    return dispatch_hd<T, true>(hd, q, k, v, q_pos, k_pos, k_valid, out, lse, B, C, Sk, H,
                                KV, scale, softcap, window, stream);
  return dispatch_hd<T, false>(hd, q, k, v, q_pos, k_pos, k_valid, out, lse, B, C, Sk, H,
                               KV, scale, softcap, window, stream);
}

}  // namespace
}  // namespace repro

// q: (B, C, H, hd); k, v: (B, Sk, KV, hd); q_pos: (C,) int32; k_pos, k_valid:
// (Sk,) int32 -> out: (B, C, H, hd) in q's type, lse: (B, H, C) float32.
// dtype: 0 float32, 1 bfloat16; hd 16, 32, 64, 80, 112 or 128; softcap <= 0
// means none, window <= 0 means none; causal 0 or 1.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int chunk_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* k_pos,
                                   const void* k_valid, void* out, void* lse, int B,
                                   int C, int Sk, int H, int KV, int hd, float scale,
                                   float softcap, int window, int causal, void* stream) {
  if (B < 1 || C < 1 || Sk < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(causal, hd, q, k, v, q_pos, k_pos, k_valid, out, lse, B,
                                  C, Sk, H, KV, scale, softcap, window, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(causal, hd, q, k, v, q_pos, k_pos, k_valid, out,
                                          lse, B, C, Sk, H, KV, scale, softcap, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* chunk_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
