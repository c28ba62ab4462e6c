// Paged decode attention for Hopper (sm_90a): one new query token per batch
// row against the shared paged KV pool, with the block-table gather done
// inside the KV loop, so the (B, n_max*block, KV, hd) gathered context never
// exists in memory.
//
// Replaces: _paged_decode_kernel in repro/kernels/attention.py (reached
// through paged_decode_attention from decode_step's paged branch).
//
// Numerics follow the reference kernel: scale hd**-0.5 after the q.k dot,
// tanh softcap, then positions >= length set to -1e30 (never -inf), float32
// m/l/acc updated online, p kept in float32 for the PV product, and
// out = acc / max(l, 1e-30) in q's type.
//
// Grid: one block per (batch row, KV head).  The block serves that KV head's
// n_rep query heads together, so each live pool row is read once per KV
// head, not once per query head.  The block loads its own tables[b, i] and
// lengths[b] (the TPU's scalar prefetch has no counterpart) and walks only
// the live table entries i < ceil(length / block), 64 tokens at a time:
// stage the tile's K/V rows in shared memory as float32, score them for the
// n_rep heads (thread per (head, token)), update m/l per head (warp per
// head), then accumulate PV (thread per (head, column)).  Table entries past
// the live prefix, the sentinel block 0 of dead rows, are never read.
//
// What bounds it on the H100: bytes.  The live KV (2 * length * KV * hd
// elements per row) is read once; the FLOPs are ~4 per element read, far
// below the ~295 operations per byte where the tensor cores become the limit.
// At B=8 rows and KV=4 heads the grid is 32 blocks on 132 SMs, so most of
// the card idles: a split over the KV axis (flash-decoding) is a later step.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;     // context tokens per pass
constexpr int kMaxOut = 16;   // (n_rep * hd) / kThreads outputs per thread, at most

size_t smem_bytes(int hd, int n_rep) {
  const size_t floats = (size_t)kTile * (hd + 4)  // k tile, padded rows
                        + (size_t)kTile * hd      // v tile
                        + (size_t)n_rep * hd      // queries
                        + (size_t)n_rep * kTile   // scores, then probabilities
                        + 3 * (size_t)n_rep;      // m, l, this tile's correction
  return floats * sizeof(float) + kTile * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV,
                    int hd, int num_blocks, int blk, int n_max, float scale,
                    float softcap) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = Vec16<T>::n;
  const int LD = hd + 4;
  const int n_rep = H / KV;
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * hd;
  float* sp = sq + n_rep * hd;
  float* sm = sp + n_rep * kTile;
  float* sl = sm + n_rep;
  float* sc = sl + n_rep;
  int* srow = reinterpret_cast<int*>(sc + n_rep);

  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int live = min(n_max, (length + blk - 1) / blk);  // live table entries
  const int span = live * blk;                            // tokens they hold
  const int n_out = n_rep * hd;

  for (int e = tid; e < n_out; e += kThreads) {
    const int hh = e / hd, d = e % hd;
    sq[e] = to_f<T>(q[((size_t)b * H + hk * n_rep + hh) * hd + d]);
  }
  for (int hh = tid; hh < n_rep; hh += kThreads) {
    sm[hh] = kNegInf;
    sl[hh] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < span; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    if (tid < kTile) {
      const int t = t0 + tid;
      int row = -1;
      if (t < span) {
        const int bid = tables[(size_t)b * n_max + t / blk];
        if (bid >= 0 && bid < num_blocks) row = bid * blk + t % blk;
      }
      srow[tid] = row;  // -1: past the live blocks (or an out-of-range id)
    }
    __syncthreads();
    for (int e = tid * VEC; e < kTile * hd; e += kThreads * VEC) {
      const int j = e / hd, d = e % hd, row = srow[j];
      float kb[VEC], vb[VEC];
      if (row >= 0) {
        const size_t off = ((size_t)row * KV + hk) * hd + d;
        load16<T>(pool_k + off, kb);
        load16<T>(pool_v + off, vb);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kb[i] = vb[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sk[j * LD + d + i] = kb[i];
        sv[j * hd + d + i] = vb[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < n_rep * kTile; e += kThreads) {
      const int hh = e / kTile, j = e % kTile;
      const float4* kr = reinterpret_cast<const float4*>(sk + j * LD);
      const float4* qr = reinterpret_cast<const float4*>(sq + hh * hd);
      float s = 0.f;
      for (int d4 = 0; d4 < hd / 4; ++d4) s = dot4(qr[d4], kr[d4], s);
      s *= scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      sp[e] = (t0 + j < length && srow[j] >= 0) ? s : kNegInf;
    }
    __syncthreads();
    for (int hh = warp; hh < n_rep; hh += kThreads / 32) {
      float* ph = sp + hh * kTile;
      float tmax = kNegInf;
      for (int j = lane; j < kTile; j += 32) tmax = fmaxf(tmax, ph[j]);
      const float m_old = sm[hh];
      const float m_new = fmaxf(m_old, warp_max(tmax));
      float psum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(ph[j] - m_new);
        ph[j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sc[hh] = corr;
        sl[hh] = sl[hh] * corr + psum;
        sm[hh] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_out) {
        const int hh = e / hd, d = e % hd;
        const float* ph = sp + hh * kTile;
        float a = acc[i] * sc[hh];
        for (int j = 0; j < kTile; ++j) a = fmaf(ph[j], sv[j * hd + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_out) {
      const int hh = e / hd, d = e % hd;
      const float ls = fmaxf(sl[hh], 1e-30f);
      out[((size_t)b * H + hk * n_rep + hh) * hd + d] = from_f<T>(acc[i] / ls);
    }
  }
}

template <typename T>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* tables,
           const void* lengths, void* out, int B, int H, int KV, int hd, int num_blocks,
           int blk, int n_max, float scale, float softcap, cudaStream_t stream) {
  const size_t bytes = smem_bytes(hd, H / KV);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T><<<dim3(B, KV), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, KV, hd, num_blocks, blk,
      n_max, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q: (B, 1, H, hd); pool_k, pool_v: (num_blocks, blk, KV, hd); tables:
// (B, n_max) int32; lengths: (B,) int32 -> out: (B, 1, H, hd) in q's type.
// dtype: 0 float32, 1 bfloat16; hd a multiple of 8 with (H / KV) * hd <= 2048;
// softcap <= 0 means none.  Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_fwd(int dtype, const void* q, const void* pool_k,
                                const void* pool_v, const void* tables,
                                const void* lengths, void* out, int B, int H, int KV,
                                int hd, int num_blocks, int blk, int n_max, float scale,
                                float softcap, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || hd % 8 != 0 || blk < 1 || n_max < 1 ||
      (H / KV) * hd > repro::kMaxOut * repro::kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, pool_k, pool_v, tables, lengths, out, B, H, KV, hd,
                                num_blocks, blk, n_max, scale, softcap, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, pool_k, pool_v, tables, lengths, out, B, H, KV,
                                        hd, num_blocks, blk, n_max, scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
