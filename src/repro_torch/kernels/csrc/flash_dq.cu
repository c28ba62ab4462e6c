// Flash-attention backward, dq pass, for Hopper (sm_90a): causal or
// non-causal (optionally sliding-window, softcapped) attention of Sq query
// rows at positions q0 .. q0 + Sq - 1 against Sk keys at 0 .. Sk - 1
// (self-attention: q0 = 0, Sk = Sq; a context-parallel rank's rows: q0 > 0),
// recomputing p from the lse the forward kernel (chunk_attention.cu) wrote.
//
// Replaces: _flash_dq_kernel (with _recompute_dlogits) in
// repro/kernels/attention.py, launched by _flash_backward.
//
//   dq_i = scale * sum_j bf(ds_ij) k_j,   ds_ij = p_ij (dO_i.v_j - delta_i)
//                                          [* (1 - tanh^2) under a softcap]
// with p_ij = exp(logit_ij - lse_i) where the mask allows and exactly 0
// elsewhere; bf() rounds to the input type, as the reference's
// dlogits.astype(k.dtype).  dq leaves in float32.
//
// Grid: one block per (32-row query tile, query head, batch row), the latest
// tiles (the most keys under causality; without it every tile has the same
// work) first.  The TPU's sequential KV grid axis becomes a loop over 32-key
// tiles of KV head h / n_rep, from the first tile the window reaches
// (position - key < window for the tile's first row) to the tile holding
// its last row's position under causality, to Sk without it: key tiles
// wholly above the diagonal have p == 0 for every row, so skipping them
// leaves dq unchanged and halves the causal work.
// Each of the 4 warps owns 8 query rows; in the score phase lane j scores
// key j against them (q.k and dO.v, each in the FMA forward kernel's fmaf
// order, so the logits match chunk_attention.cu's bit for bit; a bf16
// forward at hd 64, 80, 112 or 128 runs chunk_attention_tc.cu, whose tensor-core sums
// differ from these in rounding only), in the accumulation
// phase lane l owns head-dim columns l, l+32, ... below hd.  Causality is a
// template parameter.
//
// What bounds it on the H100: FLOPs, 3 matrix products of 2*hd per attended
// (row, key) pair, here on the float32 FMA pipes (67 TFLOP/s peak).  bf16
// inputs at head dims 64, 80, 112 and 128, causal or not, take
// flash_dq_tc.cu, on the tensor cores; float32 stays here, since TF32 would
// miss the 1e-4 its card tests hold, and so do hd 16 and 32.  The bf16
// instances at the tensor cores' head dims stay built, so that a check or a
// timing can hold that kernel against this one at the same call.

#include "flash_bwd.cuh"

namespace repro {
namespace {

using namespace flash_bwd;

template <typename T, int HD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk,
                int q_off, int H, int KV, float scale, float softcap, int window) {
  constexpr int LD = HD + 4;
  constexpr int PER_LANE = Cols<HD>::per_lane;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + kT * LD;
  float* sk = sdo + kT * LD;
  float* sv = sk + kT * LD;

  const int n_tiles = (Sq + kT - 1) / kT;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * kPerWarp;  // first tile row of this warp

  const size_t q_stride = (size_t)H * HD, k_stride = (size_t)KV * HD;
  const size_t q_base = (size_t)b * Sq * q_stride + (size_t)h * HD;
  const size_t k_base = (size_t)b * Sk * k_stride + (size_t)hk * HD;
  stage_rows<T, HD>(sq, q + q_base, q0, Sq, q_stride);
  stage_rows<T, HD>(sdo, dout + q_base, q0, Sq, q_stride);

  float lse_r[kPerWarp], delta_r[kPerWarp], acc[kPerWarp][PER_LANE];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int row = q0 + r0 + r;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    lse_r[r] = row < Sq ? lse[at] : 0.f;
    delta_r[r] = row < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[r][i] = 0.f;
  }
  const bool warp_live = q0 + r0 < Sq;
  // keys past the position of the block's last row are masked for all its
  // rows (causal); keys before its first row's position - window + 1 are
  // out of every row's window
  const int k_end = kCausal ? min(q_off + q0 + kT, Sk) : Sk;
  const int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) / kT * kT : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kT) {
    __syncthreads();  // the previous tile is consumed (first pass: q/dO staged)
    stage_rows<T, HD>(sk, k + k_base, k0, Sk, k_stride);
    stage_rows<T, HD>(sv, v + k_base, k0, Sk, k_stride);
    __syncthreads();
    if (!warp_live) continue;

    float s[kPerWarp], dp[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(sk + lane * LD);
    const float4* vrow = reinterpret_cast<const float4*>(sv + lane * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4];
      const float4 vv = vrow[d4];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        s[r] = dot4(reinterpret_cast<const float4*>(sq + (r0 + r) * LD)[d4], kk, s[r]);
        dp[r] = dot4(reinterpret_cast<const float4*>(sdo + (r0 + r) * LD)[d4], vv, dp[r]);
      }
    }
    const int key = k0 + lane;
    float ds_t[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      float p, ds;
      recompute(s[r], dp[r], lse_r[r], delta_r[r],
                attend<kCausal>(q0 + r0 + r, key, Sq, Sk, q_off, window), scale, softcap,
                p, ds);
      ds_t[r] = to_f<T>(from_f<T>(ds));  // dlogits in k's type before the product
    }
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float kj[PER_LANE];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        kj[i] = Cols<HD>::live(lane, i) ? sk[j * LD + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds_t[r], j);
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) acc[r][i] = fmaf(dsj, kj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Sq) continue;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (Cols<HD>::live(lane, i))
        dq[((size_t)b * Sq + row) * q_stride + (size_t)h * HD + lane + 32 * i] =
            acc[r][i] * scale;
  }
}

template <typename T, int HD, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int B, int Sq, int Sk, int q_off, int H, int KV,
           float scale, float softcap, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes(HD);
  static SmemOptIn opt_in;
  const int rc = opt_in.apply(flash_dq_kernel<T, HD, kCausal>, static_cast<int>(bytes));
  if (rc != 0) return rc;
  const dim3 grid((Sq + kT - 1) / kT, H, B);
  flash_dq_kernel<T, HD, kCausal><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), Sq, Sk, q_off, H, KV, scale,
      softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kCausal>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
                int q_off, int H, int KV, float scale, float softcap, int window,
                cudaStream_t stream) {
#define REPRO_DQ_LAUNCH(HD)                                                              \
  return launch<T, HD, kCausal>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, q_off, H, KV, \
                                scale, softcap, window, stream)
  switch (hd) {
    case 16: REPRO_DQ_LAUNCH(16);
    case 32: REPRO_DQ_LAUNCH(32);
    case 64: REPRO_DQ_LAUNCH(64);
    case 80: REPRO_DQ_LAUNCH(80);
    case 112: REPRO_DQ_LAUNCH(112);
    case 128: REPRO_DQ_LAUNCH(128);
    default:
      break;
  }
#undef REPRO_DQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int causal, int hd, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dq, int B, int Sq,
             int Sk, int q_off, int H, int KV, float scale, float softcap, int window,
             cudaStream_t stream) {
  if (causal)
    return dispatch_hd<T, true>(hd, q, k, v, dout, lse, delta, dq, B, Sq, Sk, q_off, H, KV,
                                scale, softcap, window, stream);
  return dispatch_hd<T, false>(hd, q, k, v, dout, lse, delta, dq, B, Sq, Sk, q_off, H, KV,
                               scale, softcap, window, stream);
}

}  // namespace
}  // namespace repro

// q, dout: (B, Sq, H, hd) at positions q0 .. q0 + Sq - 1; k, v: (B, Sk,
// KV, hd) at positions 0 .. Sk - 1; lse, delta: (B, H, Sq) float32 -> dq:
// (B, Sq, H, hd) float32.  Self-attention is q0 = 0, Sk = Sq.  dtype: 0
// float32, 1 bfloat16; hd 16, 32, 64, 80, 112 or 128; softcap <= 0 means
// none, window <= 0 means none; causal 0 or 1.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_dq_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int B, int Sq, int Sk, int q0, int H, int KV, int hd, float scale,
                            float softcap, int window, int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || q0 < 0 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(causal, hd, q, k, v, dout, lse, delta, dq, B, Sq, Sk, q0, H,
                                  KV, scale, softcap, window, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(causal, hd, q, k, v, dout, lse, delta, dq, B, Sq, Sk,
                                          q0, H, KV, scale, softcap, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_dq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
