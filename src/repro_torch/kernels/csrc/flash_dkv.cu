// Flash-attention backward, dk/dv pass, for Hopper (sm_90a): causal
// (optionally sliding-window, softcapped) self-attention with grouped KV
// heads, recomputing p from the lse the forward kernel (chunk_attention.cu)
// wrote.
//
// Replaces: _flash_dkv_kernel (with _recompute_dlogits) in
// repro/kernels/attention.py, launched by _flash_backward, AND the sum over
// the n_rep query heads of each KV head that the reference takes outside the
// kernel (attention.py:367-368):
//
//   dv_j = sum_h sum_i bf(p_hij) dO_hi
//   dk_j = scale * sum_h sum_i bf(ds_hij) q_hi
//
// with bf() the rounding to the input type (p.astype(do.dtype),
// dlogits.astype(q.dtype)).  dk and dv leave in float32.
//
// Grid: one block per (32-key tile, KV head, batch row), the first tiles
// (seen by the most queries under causality) first.  The block stages its k
// and v tile once and loops over the n_rep query heads of its KV head and,
// for each, over the 32-row query tiles from the diagonal to the last row
// the window lets see the tile: query tiles wholly below the diagonal's
// other side see p == 0 and are skipped.  Summing the query heads inside
// the block needs no atomics, gives one fixed summation order, and never
// writes the reference's (B, S, H, hd) float32 per-query-head partials.
// Each of the 4 warps owns 8 keys and keeps their dk and dv rows in
// registers; in the score phase lane i scores query row i against them
// (q.k and dO.v in the FMA forward kernel's fmaf order, so the logits match
// chunk_attention.cu's bit for bit), in the accumulation phase lane l owns
// head-dim columns l, l+32, ...
//
// The float32 route (and bf16 at hd 32); bf16 at hd 64 and 128 takes
// flash_dkv_tc.cu.
//
// What bounds it on the H100: FLOPs, 4 matrix products of 2*hd per causal
// (row, key) pair.  This first version runs them on the float32 FMA pipes
// (67 TFLOP/s peak), not the tensor cores; wgmma tiles are a later step.

#include <type_traits>

#include "flash_bwd.cuh"

namespace repro {
namespace {

using namespace flash_bwd;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int S, int H, int KV, float scale, float softcap,
                 int window) {
  constexpr int LD = HD + 4;
  constexpr int PER_LANE = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + kT * LD;
  float* sq = sv + kT * LD;
  float* sdo = sq + kT * LD;
  __shared__ float slse[kT];
  __shared__ float sdelta[kT];

  const int k0 = blockIdx.x * kT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = warp * kPerWarp;  // first tile key of this warp

  const size_t q_stride = (size_t)H * HD, k_stride = (size_t)KV * HD;
  const size_t k_base = (size_t)b * S * k_stride + (size_t)hk * HD;
  stage_rows<T, HD>(sk, k + k_base, k0, S, k_stride);
  stage_rows<T, HD>(sv, v + k_base, k0, S, k_stride);

  float dk_acc[kPerWarp][PER_LANE], dv_acc[kPerWarp][PER_LANE];
#pragma unroll
  for (int c = 0; c < kPerWarp; ++c) {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
  }
  // rows before the tile's first key see none of it (causal); rows at or
  // past its last key + window see none of it either
  const int k_last = min(k0 + kT, S) - 1;
  const int q_end = window > 0 ? min(S, k_last + window) : S;

  for (int hh = 0; hh < n_rep; ++hh) {
    const int h = hk * n_rep + hh;
    const size_t q_base = (size_t)b * S * q_stride + (size_t)h * HD;
    const size_t row_base = ((size_t)b * H + h) * S;
    for (int q0 = k0; q0 < q_end; q0 += kT) {
      __syncthreads();  // the previous query tile is consumed
      stage_rows<T, HD>(sq, q + q_base, q0, S, q_stride);
      stage_rows<T, HD>(sdo, dout + q_base, q0, S, q_stride);
      if (tid < kT) {
        const int row = q0 + tid;
        slse[tid] = row < S ? lse[row_base + row] : 0.f;
        sdelta[tid] = row < S ? delta[row_base + row] : 0.f;
      }
      __syncthreads();

      // scores: lane i scores query row q0 + i against the warp's keys
      float s[kPerWarp], dp[kPerWarp];
#pragma unroll
      for (int c = 0; c < kPerWarp; ++c) s[c] = dp[c] = 0.f;
      const float4* qrow = reinterpret_cast<const float4*>(sq + lane * LD);
      const float4* orow = reinterpret_cast<const float4*>(sdo + lane * LD);
#pragma unroll 4
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 qq = qrow[d4];
        const float4 oo = orow[d4];
#pragma unroll
        for (int c = 0; c < kPerWarp; ++c) {
          s[c] = dot4(qq, reinterpret_cast<const float4*>(sk + (c0 + c) * LD)[d4], s[c]);
          dp[c] = dot4(oo, reinterpret_cast<const float4*>(sv + (c0 + c) * LD)[d4], dp[c]);
        }
      }
      const int row = q0 + lane;
      float p_t[kPerWarp], ds_t[kPerWarp];
#pragma unroll
      for (int c = 0; c < kPerWarp; ++c) {
        float p, ds;
        recompute(s[c], dp[c], slse[lane], sdelta[lane],
                  attend(row, k0 + c0 + c, S, window), scale, softcap, p, ds);
        p_t[c] = to_f<T>(from_f<T>(p));    // p in dO's type before the product
        ds_t[c] = to_f<T>(from_f<T>(ds));  // dlogits in q's type before the product
      }
      const int n_rows = min(kT, S - q0);
      for (int i = 0; i < n_rows; ++i) {
        float qi[PER_LANE], oi[PER_LANE];
#pragma unroll
        for (int x = 0; x < PER_LANE; ++x) {
          qi[x] = sq[i * LD + lane + 32 * x];
          oi[x] = sdo[i * LD + lane + 32 * x];
        }
#pragma unroll
        for (int c = 0; c < kPerWarp; ++c) {
          const float pc = __shfl_sync(0xffffffffu, p_t[c], i);
          const float dc = __shfl_sync(0xffffffffu, ds_t[c], i);
#pragma unroll
          for (int x = 0; x < PER_LANE; ++x) {
            dv_acc[c][x] = fmaf(pc, oi[x], dv_acc[c][x]);
            dk_acc[c][x] = fmaf(dc, qi[x], dk_acc[c][x]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kPerWarp; ++c) {
    const int key = k0 + c0 + c;
    if (key >= S) continue;
    const size_t at = ((size_t)b * S + key) * k_stride + (size_t)hk * HD + lane;
#pragma unroll
    for (int x = 0; x < PER_LANE; ++x) {
      dk[at + 32 * x] = dk_acc[c][x] * scale;
      dv[at + 32 * x] = dv_acc[c][x];
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int B, int S, int H, int KV, float scale,
           float softcap, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes(HD);
  static SmemOptIn opt_in;
  const int rc = opt_in.apply(flash_dkv_kernel<T, HD>, static_cast<int>(bytes));
  if (rc != 0) return rc;
  const dim3 grid((S + kT - 1) / kT, KV, B);
  flash_dkv_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), S,
      H, KV, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
                int KV, float scale, float softcap, int window, cudaStream_t stream) {
  // bf16 at hd 64 and 128 is the tensor-core kernel's (flash_dkv_tc.cu): only
  // float32 has instances there
  constexpr bool kWide = std::is_same<T, float>::value;
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, softcap,
                           window, stream);
    case 64:
      if constexpr (kWide)
        return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, softcap,
                             window, stream);
      break;
    case 128:
      if constexpr (kWide)
        return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, softcap,
                              window, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// q, dout: (B, S, H, hd); k, v: (B, S, KV, hd); lse, delta: (B, H, S)
// float32 -> dk, dv: (B, S, KV, hd) float32, summed over each KV head's
// H / KV query heads.  dtype: 0 float32 (hd 32, 64 or 128), 1 bfloat16
// (hd 32: bf16 at 64 and 128 is the tensor-core kernel's); softcap <= 0
// means none, window <= 0 means none.  Returns the launch's cudaError_t (0
// on success).
extern "C" int flash_dkv_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, int B, int S, int H, int KV, int hd, float scale,
                             float softcap, int window, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch_hd<float>(hd, q, k, v, dout, lse, delta, dk, dv, B, S, H, KV,
                                     scale, softcap, window, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch_hd<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                             KV, scale, softcap, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_dkv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
