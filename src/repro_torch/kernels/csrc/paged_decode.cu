// Paged decode attention for Hopper (sm_90a), split over the context
// (flash-decoding): one new query token per batch row against the shared
// paged KV pool, with the block-table gather done inside the KV loop, so the
// (B, n_max*block, KV, hd) gathered context never exists in memory.
//
// Replaces: _paged_decode_kernel in repro/kernels/attention.py (reached
// through paged_decode_attention from decode_step's paged branch).
//
// Numerics follow the reference kernel: scale hd**-0.5 after the q.k dot,
// tanh softcap, then positions >= length set to -1e30 (never -inf), float32
// m/l/acc updated online, p kept in float32 for the PV product, and
// out = acc / max(l, 1e-30) in q's type.
//
// Grid: (splits, KV head, batch row).  A block serves its KV head's n_rep
// query heads together, so each live pool row is read once per KV head, not
// once per query head.  It loads lengths[b] (the TPU's scalar prefetch has
// no counterpart), counts the row's live table entries, live = ceil(length
// / block), and takes the contiguous share [split * per, (split + 1) * per)
// of them, per = ceil(live / splits): a short row spreads over all splits,
// and a split past the live entries writes the empty partial (m = -1e30,
// l = 0, acc = 0).  Table entries past the live prefix (the sentinel block
// 0 of dead rows) are never read; a free lane's all-sentinel table is read
// as block 0, as the reference reads it.  The block stages its share 32
// tokens at a time, K and V in the input type, gathered through the table
// with 16-byte cp.async copies into two buffers, so the next group's loads
// run under this group's scores and softmax update (warp per head, lane per
// token) and PV (thread per pair of (head, column) outputs).
//
// Combine: with one split the block writes the output itself.  Otherwise
// each block writes its unnormalised (m, l, acc) into a float32 workspace
// the wrapper allocates, and a second small kernel on the same stream, a
// block per (row, query head), adds the partials in split order: m = max
// m_s, l = sum l_s e^(m_s - m), acc = sum acc_s e^(m_s - m), out = acc /
// max(l, 1e-30).
// A fixed order and no atomics give the same bits on every run; a second
// launch, not a last-arriving block, needs no counter to reset and is safe
// across streams.
//
// What bounds it on the H100: bytes.  The live KV (2 * length * KV * hd
// elements per row) is read once; the FLOPs are ~4 per element read, far
// below the ~295 operations per byte where the tensor cores become the
// limit.  The split (kernels.attention.decode_plan: about two blocks per
// SM) is what lets a small batch (B 8 x KV 4 = 32 (row, head) pairs on 132
// SMs) fill the card.

#include <math_constants.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // context tokens per staged group: a lane each
constexpr int kHeads = 2;          // query heads a warp scores per pass over K
constexpr int kRowThreads = kThreads / (2 * kTile);  // threads staging one K or V row
constexpr int kMaxOut = 8;         // (n_rep * hd) / kThreads outputs per thread, at most
constexpr int kMaxSmem = 232448;   // the most dynamic shared memory a block may take
constexpr int kMaxSplits = 4096;   // the combine's weights stay within 48 KB

// Dynamic shared memory of a block: two buffers of K and V rows (each row
// padded by 16 bytes, so a warp reading one row a lane is free of bank
// conflicts), q, the group's scores, m / l / correction per head, each
// buffer's token flags (the block inside the pool), and the split's table
// entries.
size_t smem_bytes(int hd, int n_rep, int n_entries, int elt) {
  return (size_t)4 * kTile * (hd * elt + 16) +
         sizeof(float) * ((size_t)n_rep * hd + (size_t)n_rep * kTile + 3 * (size_t)n_rep) +
         sizeof(int) * (2 * (size_t)kTile + (size_t)n_entries);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 16 bytes of T from shared memory as floats.
template <typename T>
__device__ __forceinline__ void chunk16(const uint8_t* p, float* dst);
template <>
__device__ __forceinline__ void chunk16<float>(const uint8_t* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
template <>
__device__ __forceinline__ void chunk16<__nv_bfloat16>(const uint8_t* p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Two adjacent elements of T from shared memory as floats.
template <typename T>
__device__ __forceinline__ float2 pair(const uint8_t* p);
template <>
__device__ __forceinline__ float2 pair<float>(const uint8_t* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 pair<__nv_bfloat16>(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part, int H, int KV, int hd, int num_blocks, int blk,
                    int n_max, float scale, float softcap) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int VEC = Vec16<T>::n;
  const int n_rep = H / KV;
  const int rs = hd * (int)sizeof(T) + 16;  // bytes of a staged K or V row
  float* sq = reinterpret_cast<float*>(smem + 4 * kTile * rs);
  float* sp = sq + n_rep * hd;
  float* sm = sp + n_rep * kTile;
  float* sl = sm + n_rep;
  float* sc = sl + n_rep;
  int* sok = reinterpret_cast<int*>(sc + n_rep);  // [buffer][token]
  int* sbid = sok + 2 * kTile;

  const int split = blockIdx.x, splits = gridDim.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int live = max(0, min(n_max, (length + blk - 1) / blk));  // live table entries
  const int per = (live + splits - 1) / splits;
  const int e0 = split * per, e1 = min(live, e0 + per);  // this split's entries
  const int t0 = e0 * blk, t1 = min(e1 * blk, length);   // and tokens
  const int n_groups = t1 > t0 ? (t1 - t0 + kTile - 1) / kTile : 0;
  const int n_out = n_rep * hd;

  for (int i = tid; i < e1 - e0; i += kThreads) {
    const int bid = tables[(size_t)b * n_max + e0 + i];
    sbid[i] = bid >= 0 && bid < num_blocks ? bid : -1;  // -1: an id outside the pool
  }
  if (n_groups > 0) {
    for (int e = tid; e < n_out; e += kThreads)
      sq[e] = to_f<T>(q[((size_t)b * H + hk * n_rep) * hd + e]);
  }
  for (int hh = tid; hh < n_rep; hh += kThreads) {
    sm[hh] = kNegInf;
    sl[hh] = 0.f;
  }
  float acc[kMaxOut];  // pairs of (head, column) outputs: 2 i, 2 i + 1 of pair tid + i kThreads
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  __syncthreads();

  // group grp's K and V rows into buffer grp % 2: threads kRowThreads r ..
  // kRowThreads (r + 1) - 1 copy every kRowThreads-th 16-byte chunk of row
  // r (K rows, then V rows), whose token is the split's token grp kTile + r
  // % kTile; a token past the split or in a block outside the pool is zeros,
  // and flagged
  const int chunks = hd / VEC;  // 16-byte chunks of a row
  const int my_j = tid / kRowThreads % kTile, my_v = tid / (kRowThreads * kTile);
  const int my_part = tid % kRowThreads;
  auto stage = [&](int grp) {
    const int u = grp * kTile + my_j;  // the token's place in the split (t0 starts a block)
    const int entry = u / blk;
    const int bid = t0 + u < t1 ? sbid[entry] : -1;
    const size_t row = bid >= 0 ? (size_t)bid * blk + (u - entry * blk) : 0;
    const T* src = (my_v ? pool_v : pool_k) + (row * KV + hk) * hd;
    uint8_t* dst = smem + ((grp & 1) * 2 * kTile + my_v * kTile + my_j) * rs;
    for (int ch = my_part; ch < chunks; ch += kRowThreads)
      cp_async16(dst + ch * 16, src + ch * VEC, bid >= 0 ? 16 : 0);
    if (my_v == 0 && my_part == 0) sok[(grp & 1) * kTile + my_j] = bid >= 0;
    cp_async_commit();
  };

  // the thread's output pairs: pair tid + i kThreads is (head, columns) =
  // (e / hd, e % hd + {0, 1}) at e = 2 (tid + i kThreads); where hd / 2
  // divides kThreads, all of a thread's pairs lie in one column pair and
  // share one V load a token
  const bool one_col = kThreads % (hd / 2) == 0;
  int prow[kMaxOut / 2], pcol[kMaxOut / 2];  // the pair's scores, its bytes in a V row
#pragma unroll
  for (int i = 0; i < kMaxOut / 2; ++i) {
    const int e = 2 * (tid + i * kThreads);
    prow[i] = e < n_out ? (e / hd) * kTile : -1;
    pcol[i] = (e % hd) * (int)sizeof(T);
  }

  if (n_groups > 0) stage(0);
  for (int grp = 0; grp < n_groups; ++grp) {
    if (grp + 1 < n_groups) {
      stage(grp + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* sk = smem + (grp & 1) * 2 * kTile * rs;
    const uint8_t* sv = sk + kTile * rs;
    const int g0 = t0 + grp * kTile;
    const int nj = min(kTile, t1 - g0);  // tokens of the split in this group
    const int* ok = sok + (grp & 1) * kTile;
    // scores and the online softmax, warp per head (heads warp, warp +
    // kWarps, ... in passes of kHeads), lane j scoring token j: K's chunk
    // read and converted once for all the warp's heads, then per head scale,
    // softcap and the mask (the split ends at or before the length, so only
    // a block outside the pool is masked; a token past the split is no token
    // at all: -inf, p exactly 0), and m, l updated over the warp
    for (int h0 = warp; h0 < n_rep; h0 += kWarps * kHeads) {
      float sd[kHeads];
#pragma unroll
      for (int k = 0; k < kHeads; ++k) sd[k] = 0.f;
      if (lane < nj) {
        const uint8_t* kr = sk + lane * rs;
        for (int ch = 0; ch < chunks; ++ch) {
          float kb[VEC];
          chunk16<T>(kr + ch * 16, kb);
#pragma unroll
          for (int k = 0; k < kHeads; ++k) {
            if (h0 + k * kWarps < n_rep) {
              const float4* qr = reinterpret_cast<const float4*>(sq + (h0 + k * kWarps) * hd + ch * VEC);
#pragma unroll
              for (int i = 0; i < VEC; i += 4)
                sd[k] = dot4(qr[i / 4], make_float4(kb[i], kb[i + 1], kb[i + 2], kb[i + 3]), sd[k]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {
        const int hh = h0 + k * kWarps;
        if (hh >= n_rep) break;
        float x = -CUDART_INF_F;
        if (lane < nj) {
          x = sd[k] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (!ok[lane]) x = kNegInf;
        }
        const float m_old = sm[hh];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float p = expf(x - m_new);
        sp[hh * kTile + lane] = p;
        const float psum = warp_sum(p);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          sc[hh] = corr;
          sl[hh] = sl[hh] * corr + psum;
          sm[hh] = m_new;
        }
      }
    }
    __syncthreads();
    // PV: every pair of the thread rescaled, then all its pairs token by
    // token (independent chains, one after another in each)
#pragma unroll
    for (int i = 0; i < kMaxOut / 2; ++i) {
      if (prow[i] >= 0) {
        const float c = sc[prow[i] / kTile];
        acc[2 * i] *= c;
        acc[2 * i + 1] *= c;
      }
    }
    if (one_col) {
      for (int j = 0; j < nj; ++j) {
        const float2 vv = pair<T>(sv + j * rs + pcol[0]);
#pragma unroll
        for (int i = 0; i < kMaxOut / 2; ++i) {
          if (prow[i] >= 0) {
            const float p = sp[prow[i] + j];
            acc[2 * i] = fmaf(p, vv.x, acc[2 * i]);
            acc[2 * i + 1] = fmaf(p, vv.y, acc[2 * i + 1]);
          }
        }
      }
    } else {
      for (int j = 0; j < nj; ++j) {
        const uint8_t* vrow = sv + j * rs;
#pragma unroll
        for (int i = 0; i < kMaxOut / 2; ++i) {
          if (prow[i] >= 0) {
            const float p = sp[prow[i] + j];
            const float2 vv = pair<T>(vrow + pcol[i]);
            acc[2 * i] = fmaf(p, vv.x, acc[2 * i]);
            acc[2 * i + 1] = fmaf(p, vv.y, acc[2 * i + 1]);
          }
        }
      }
    }
    __syncthreads();  // the buffer and the scores are free
  }

  // one split: the output; several: this split's partial
  const size_t at = ((size_t)b * KV + hk) * splits + split;
#pragma unroll
  for (int i = 0; i < kMaxOut / 2; ++i) {
    const int e = 2 * (tid + i * kThreads);
    if (e < n_out) {
      if (splits == 1) {
        const float ls = fmaxf(sl[e / hd], 1e-30f);
        T* dst = out + ((size_t)b * H + hk * n_rep) * hd + e;
        dst[0] = from_f<T>(acc[2 * i] / ls);
        dst[1] = from_f<T>(acc[2 * i + 1] / ls);
      } else {
        *reinterpret_cast<float2*>(part + at * n_out + e) = make_float2(acc[2 * i], acc[2 * i + 1]);
      }
    }
  }
  if (splits > 1) {
    const size_t parts = (size_t)gridDim.z * KV * splits;
    float* pm = part + parts * n_out;
    float* pl = pm + parts * n_rep;
    for (int hh = tid; hh < n_rep; hh += kThreads) {
      pm[at * n_rep + hh] = sm[hh];
      pl[at * n_rep + hh] = sl[hh];
    }
  }
}

// Adds the splits' partials of one (batch row, query head) per block, in
// split order: warp 0 takes the weights e^(m_s - m) and l once, then a
// thread per output column sums its acc_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine(const float* __restrict__ part, T* __restrict__ out, int B, int H, int KV,
                     int hd, int splits) {
  extern __shared__ float w[];  // [split] e^(m_s - m), then [split] l_s e^(m_s - m)
  __shared__ float l_safe;
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x & 31;
  const int n_rep = H / KV, hk = h / n_rep, hh = h % n_rep, n_out = n_rep * hd;
  const size_t parts = (size_t)B * KV * splits;
  const size_t first = ((size_t)b * KV + hk) * splits;  // the (row, KV head)'s split 0
  const float* pm = part + parts * n_out + first * n_rep + hh;  // m_s at pm[s n_rep]
  const float* pl = pm + parts * n_rep;                         // l_s at pl[s n_rep]
  float* wl = w + splits;
  if (threadIdx.x < 32) {
    float m = kNegInf;
    for (int s = lane; s < splits; s += 32) m = fmaxf(m, pm[(size_t)s * n_rep]);
    m = warp_max(m);
    for (int s = lane; s < splits; s += 32) {
      w[s] = expf(pm[(size_t)s * n_rep] - m);
      wl[s] = pl[(size_t)s * n_rep] * w[s];
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int s = 0; s < splits; ++s) l += wl[s];
      l_safe = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  const float* pa = part + first * n_out + hh * hd;  // acc_s at pa[s n_out]
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a = fmaf(pa[(size_t)s * n_out + d], w[s], a);
    out[((size_t)b * H + h) * hd + d] = from_f<T>(a / l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* tables,
           const void* lengths, void* out, void* part, int B, int H, int KV, int hd,
           int num_blocks, int blk, int n_max, int splits, float scale, float softcap,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(hd, H / KV, (n_max + splits - 1) / splits, sizeof(T));
  if (bytes > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static SmemOptIn opt_in;  // the most a block may take, once: launches take what they need
  int rc = opt_in.apply(paged_decode_kernel<T>, kMaxSmem);
  if (rc != 0) return rc;
  paged_decode_kernel<T><<<dim3(splits, KV, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(part), H, KV, hd, num_blocks, blk, n_max, scale, softcap);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  paged_decode_combine<T><<<dim3(H, B), kThreads, 2 * splits * sizeof(float), stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), B, H, KV, hd, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q: (B, 1, H, hd); pool_k, pool_v: (num_blocks, blk, KV, hd); tables:
// (B, n_max) int32; lengths: (B,) int32 -> out: (B, 1, H, hd) in q's type.
// part: with splits > 1, a float32 workspace of B * KV * splits * (n_rep *
// hd + 2 n_rep) floats (the partials' acc, then m, then l), else unused.
// dtype: 0 float32, 1 bfloat16; hd a multiple of 8 with (H / KV) * hd <=
// 2048; softcap <= 0 means none.  Returns the launches' cudaError_t (0 on
// success).
extern "C" int paged_decode_fwd(int dtype, const void* q, const void* pool_k,
                                const void* pool_v, const void* tables,
                                const void* lengths, void* out, void* part, int B, int H, int KV,
                                int hd, int num_blocks, int blk, int n_max, int splits,
                                float scale, float softcap, void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV != 0 || hd % 8 != 0 || blk < 1 ||
      n_max < 1 || splits < 1 || splits > repro::kMaxSplits || (splits > 1 && part == nullptr) ||
      (H / KV) * hd > repro::kMaxOut * repro::kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, pool_k, pool_v, tables, lengths, out, part, B, H, KV, hd,
                                num_blocks, blk, n_max, splits, scale, softcap, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, pool_k, pool_v, tables, lengths, out, part, B, H,
                                        KV, hd, num_blocks, blk, n_max, splits, scale, softcap,
                                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
