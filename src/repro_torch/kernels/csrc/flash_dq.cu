// Flash-attention backward, dq pass, for Hopper (sm_90a): causal (optionally
// sliding-window, softcapped) self-attention, recomputing p from the lse the
// forward kernel (chunk_attention.cu) wrote.
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
// tiles (the most keys under causality) first.  The TPU's sequential KV grid
// axis becomes a loop over 32-key tiles of KV head h / n_rep, from the first
// tile the window reaches to the diagonal: key tiles wholly above the
// diagonal have p == 0 for every row, so skipping them leaves dq unchanged
// and halves the work.  Each of the 4 warps owns 8 query rows; in the score
// phase lane j scores key j against them (q.k and dO.v, each in the FMA
// forward kernel's fmaf order, so the logits match chunk_attention.cu's bit
// for bit; a bf16 forward at hd 64 or 128 runs chunk_attention_tc.cu, whose
// tensor-core sums differ from these in rounding only), in the accumulation
// phase lane l owns head-dim columns l, l+32, ...
//
// What bounds it on the H100: FLOPs, 3 matrix products of 2*hd per causal
// (row, key) pair, here on the float32 FMA pipes (67 TFLOP/s peak).  bf16
// inputs at head dims 64 and 128 take flash_dq_tc.cu, on the tensor cores;
// float32 stays here, since TF32 would miss the 1e-4 its card tests hold.

#include "flash_bwd.cuh"

namespace repro {
namespace {

using namespace flash_bwd;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int S, int H,
                int KV, float scale, float softcap, int window) {
  constexpr int LD = HD + 4;
  constexpr int PER_LANE = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + kT * LD;
  float* sk = sdo + kT * LD;
  float* sv = sk + kT * LD;

  const int n_tiles = (S + kT - 1) / kT;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * kPerWarp;  // first tile row of this warp

  const size_t q_stride = (size_t)H * HD, k_stride = (size_t)KV * HD;
  const size_t q_base = (size_t)b * S * q_stride + (size_t)h * HD;
  const size_t k_base = (size_t)b * S * k_stride + (size_t)hk * HD;
  stage_rows<T, HD>(sq, q + q_base, q0, S, q_stride);
  stage_rows<T, HD>(sdo, dout + q_base, q0, S, q_stride);

  float lse_r[kPerWarp], delta_r[kPerWarp], acc[kPerWarp][PER_LANE];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int row = q0 + r0 + r;
    const size_t at = ((size_t)b * H + h) * S + row;
    lse_r[r] = row < S ? lse[at] : 0.f;
    delta_r[r] = row < S ? delta[at] : 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[r][i] = 0.f;
  }
  const bool warp_live = q0 + r0 < S;
  // keys past the block's last row are masked for all its rows (causal);
  // keys before q0 - window + 1 are out of every row's window
  const int k_end = min(q0 + kT, S);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kT * kT : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kT) {
    __syncthreads();  // the previous tile is consumed (first pass: q/dO staged)
    stage_rows<T, HD>(sk, k + k_base, k0, S, k_stride);
    stage_rows<T, HD>(sv, v + k_base, k0, S, k_stride);
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
      recompute(s[r], dp[r], lse_r[r], delta_r[r], attend(q0 + r0 + r, key, S, window),
                scale, softcap, p, ds);
      ds_t[r] = to_f<T>(from_f<T>(ds));  // dlogits in k's type before the product
    }
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float kj[PER_LANE];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) kj[i] = sk[j * LD + lane + 32 * i];
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
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      dq[((size_t)b * S + row) * q_stride + (size_t)h * HD + lane + 32 * i] = acc[r][i] * scale;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int B, int S, int H, int KV, float scale,
           float softcap, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes(HD);
  static SmemOptIn opt_in;
  const int rc = opt_in.apply(flash_dq_kernel<T, HD>, static_cast<int>(bytes));
  if (rc != 0) return rc;
  const dim3 grid((S + kT - 1) / kT, H, B);
  flash_dq_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, H, KV, scale, softcap,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int B, int S, int H, int KV,
                float scale, float softcap, int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, softcap,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, softcap,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, softcap,
                            window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// q, dout: (B, S, H, hd); k, v: (B, S, KV, hd); lse, delta: (B, H, S)
// float32 -> dq: (B, S, H, hd) float32.  dtype: 0 float32, 1 bfloat16; hd in
// {32, 64, 128}; softcap <= 0 means none, window <= 0 means none.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int flash_dq_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int B, int S, int H, int KV, int hd, float scale, float softcap,
                            int window, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch_hd<float>(hd, q, k, v, dout, lse, delta, dq, B, S, H, KV, scale,
                                     softcap, window, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch_hd<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dq, B, S, H, KV,
                                             scale, softcap, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_dq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
