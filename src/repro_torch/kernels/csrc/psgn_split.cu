// The bf16 split of float32 psgn operands (sm_90a):
//
//   v = hi + mid + lo, each term a bf16
//
// Part of the port of _direct_kernel (psgn_direct) and _fused_kernel
// (psgn_fused) in repro/kernels/psgn.py: the "split" route.  A float32 x or
// delta is split here, and psgn_direct_tc.cu contracts the terms on the
// tensor cores as term pairs summed in its float32 accumulator: a product
// of two bf16 values is exact in float32, so X^T D_hi + X^T D_mid + X^T D_lo
// is X^T D up to the order of the sums.  (TF32 cannot take these products:
// both wgmma operands are MN-major, since psgn contracts over S, the outer
// axis of X and D, and PTX allows the transpose only for f16 and bf16.)
//
//   srcs: n_src float32 tensors of n elements each; terms: (3, n_src, n)
//   bf16, hi of every source, then mid, then lo.
//
// hi is v cut to its top 16 bits (bf16 is the top half of a float32), mid
// the remainder r = v - hi cut the same way, lo the remainder r - mid cut
// again.  Both subtractions are exact in float32 (r holds v's low 16
// mantissa bits; r - mid at most 8 significant bits), and cutting never
// rounds up, so hi is finite wherever v is, FLT_MAX included.  The three
// terms sum to v exactly wherever v is a multiple of 2^-133, bf16's least
// subnormal: every |v| >= 2^-110 and every value whose bits below 2^-133 are
// zero.  Below that, lo drops the bits under 2^-133: the sum is v cut toward
// zero to a multiple of 2^-133, off by less than 2^-133 (9.2e-41).  A
// non-finite v maps to (v, 0, 0), a NaN kept a NaN by its quiet bit, so an
// infinity never becomes inf - inf = NaN.  ref.split_bf16 is the same
// function in integer and float32 arithmetic; the two agree bit for bit.
//
// What bounds it on the H100: bytes, 4 read and 6 written per element (the
// q-width float32 delta at B 2, S 2048: 168 MB, 0.050 ms at 3.35 TB/s).
// Each thread moves 4 elements: one 16-byte load, three 8-byte stores.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxSrc = 64;     // sources per launch (512 bytes of parameters)
constexpr int kMaxBlocks = 4096;  // blocks along one source; a grid-stride loop does the rest

struct Srcs {
  const float* p[kMaxSrc];
};

// The three bf16 terms of v, as bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t b = __float_as_uint(v);
  if ((b & 0x7f800000u) == 0x7f800000u) {  // inf or NaN: (v, 0, 0)
    hi = (b >> 16) | ((b & 0x007fffffu) ? 0x0040u : 0u);
    mid = lo = 0u;
    return;
  }
  const float r = __fsub_rn(v, __uint_as_float(b & 0xffff0000u));
  const float s = __fsub_rn(r, __uint_as_float(__float_as_uint(r) & 0xffff0000u));
  hi = b >> 16;
  mid = __float_as_uint(r) >> 16;
  lo = __float_as_uint(s) >> 16;
}

__global__ void __launch_bounds__(kThreads)
psgn_split_kernel(const __grid_constant__ Srcs srcs, uint16_t* __restrict__ terms, int s0,
                  int n_src, int n) {
  const int src = s0 + blockIdx.y;
  const float4* in = reinterpret_cast<const float4*>(srcs.p[blockIdx.y]);
  const size_t plane = (size_t)n_src * n;  // elements of one term over every source
  uint16_t* hi = terms + (size_t)src * n;
  const int n4 = n / 4;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += gridDim.x * kThreads) {
    const float4 v = __ldg(in + i);
    uint32_t h[4], m[4], l[4];
    split(v.x, h[0], m[0], l[0]);
    split(v.y, h[1], m[1], l[1]);
    split(v.z, h[2], m[2], l[2]);
    split(v.w, h[3], m[3], l[3]);
    // four bf16 of a term: one 8-byte store
    reinterpret_cast<uint2*>(hi)[i] = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    reinterpret_cast<uint2*>(hi + plane)[i] = make_uint2(m[0] | (m[1] << 16), m[2] | (m[3] << 16));
    reinterpret_cast<uint2*>(hi + 2 * plane)[i] =
        make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
  }
}

}  // namespace
}  // namespace repro

// srcs: a host array of n_src device pointers, each a contiguous float32
// tensor of n elements, 16-byte aligned; n a multiple of 8, so that every
// term of every source starts 16-byte aligned (the tensor maps need it).
// terms: (3, n_src, n) bf16.  Launches on `stream`, once per 64 sources.
// Returns the cudaError_t (0 on success).
extern "C" int psgn_split_fwd(const void* const* srcs, int n_src, int n, void* terms,
                              void* stream) {
  using namespace repro;
  if (n_src < 1 || n < 8 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n4 = n / 4;
  const int blocks = (n4 + kThreads - 1) / kThreads < kMaxBlocks
                         ? (n4 + kThreads - 1) / kThreads : kMaxBlocks;
  Srcs table = {};
  for (int s0 = 0; s0 < n_src; s0 += kMaxSrc) {
    const int k = n_src - s0 < kMaxSrc ? n_src - s0 : kMaxSrc;
    for (int s = 0; s < k; ++s) table.p[s] = static_cast<const float*>(srcs[s0 + s]);
    psgn_split_kernel<<<dim3(blocks, k), kThreads, 0, st>>>(
        table, static_cast<uint16_t*>(terms), s0, n_src, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* psgn_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
