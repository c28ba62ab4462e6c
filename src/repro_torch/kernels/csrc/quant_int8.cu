// Row-wise absmax int8 quantisation for Hopper (sm_90a):
//
//   scale_r = max(max_c |x_rc|, 1e-12) / 127
//   q_rc    = clip(round_half_even(x_rc / scale_r), -127, 127)  as int8
//
// Replaces: _quant_kernel (quantize_int8) in repro/kernels/quant.py.
//
//   x: (R, C) float32 or bfloat16, contiguous; q: (R, C) int8; scales: (R,)
//   float32.  The cross-pod gradient compressor calls it with a whole
//   gradient leaf viewed as one row (R = 1, a per-tensor scale); the
//   rowwise shape (many rows of moderate C) is the other caller.
//
// Two designs, chosen here from C:
//
//   one pass   C <= 32768 (kOneBlock): one launch, one block per row, 256
//              threads up to 4096 elements and 1024 beyond.  The block
//              loads its row into registers, takes the absmax, forms the
//              scale and writes the codes: x is read once.  This covers the
//              rowwise shape and every leaf of the pod slice.
//   two passes longer rows: the row's slot zeroed (a memset), then two
//              launches over blocks of (chunk, row), 16384 elements a
//              chunk.  The first folds the absmax of its chunk into the
//              row's slot with atomicMax on the bits of |x| (a max does not
//              depend on the order of reduction, so every run gives the
//              same bits); the second forms the scale from the slot and
//              writes its chunk's codes.  No deployment of the repo sends
//              such rows yet: its pod slices quantise leaves of at most
//              32768 elements.
//
// Both move 16 elements as a unit: 4 (float32) or 2 (bf16) 16-byte loads,
// one 16-byte store of 16 codes, where x and q are both 16-byte aligned,
// which holds at flat indices that are multiples of 16 when x's base is
// 16-byte aligned (q's always is).  A row's head before its first such index
// and its tail after its last whole unit are done element by element, one
// element a thread (by the chunk-0 block in the two-pass design); a row of
// an x that is not 16-byte aligned (a view at an offset) has no such index,
// and its units are read and written element by element.
//
// Bit-exactness with the reference: x / scale is an IEEE division
// (__fdiv_rn, no fast math), round is rintf (half to even, as jnp.round),
// bf16 is widened to float32 before abs and division, and the constant
// 1e-12 is rounded from double to float as the frameworks round it.
//
// Non-finite input, as the reference's max and clip give it: the absmax is
// a max over the bits of |x| as unsigned integers, where every NaN lies
// above +inf and +inf above every finite value, so a row holding a NaN gets
// a NaN scale and a row holding an infinity (and no NaN) an infinite one.
// Every code of such a row is then NaN / scale or x / inf -> NaN or 0, and
// a NaN code converts to 0, as the frameworks' float -> int8 cast does.
//
// What bounds it on the H100: bytes.  x read once and q written once: 5
// bytes per float32 element, 3 per bf16.  The two-pass design reads x twice,
// less what the second pass finds still in the 50 MB L2.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;       // the two-pass blocks, and the one-pass ones up to 4096
constexpr int kWideThreads = 1024;  // the one-pass blocks for longer rows
constexpr int kUnit = 16;     // elements of a unit: one 16-byte store of codes
constexpr int kMaxUnits = 2;  // units a thread of the one-pass design holds in registers
// The longest row of the one-pass design.
constexpr int kOneBlock = kWideThreads * kMaxUnits * kUnit;
constexpr int kPassUnits = 4;  // units a thread of the two-pass design takes
constexpr int kChunkUnits = kThreads * kPassUnits;  // a two-pass block's units

// A row's split into `head` elements up to its first aligned unit, `units`
// whole units, and `tail` elements after them (flat indices from `base`).
struct Row {
  size_t base;
  int head, units, tail;
};

__device__ __forceinline__ Row row_of(int r, int C, bool vec) {
  Row row;
  row.base = (size_t)r * C;
  row.head = vec ? min(static_cast<int>((kUnit - row.base % kUnit) % kUnit), C) : 0;
  row.units = (C - row.head) / kUnit;
  row.tail = C - row.head - row.units * kUnit;
  return row;
}

// The element of the row outside its units that this thread takes (head:
// threads 0-14, tail: threads 32-46), or -1.
__device__ __forceinline__ int edge_of(const Row& row) {
  const int t = threadIdx.x;
  if (t < row.head) return t;
  if (t >= 32 && t < 32 + row.tail) return row.head + row.units * kUnit + (t - 32);
  return -1;
}

__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(fabsf(v));  // NaN > +inf > every finite value
}

// max(absmax, 1e-12) in the same order of bits (a NaN absmax stays NaN), / 127
__device__ __forceinline__ float scale_of(unsigned int amax_bits) {
  const unsigned int floor_bits = __float_as_uint(static_cast<float>(1e-12));
  return __fdiv_rn(__uint_as_float(max(amax_bits, floor_bits)), 127.0f);
}

__device__ __forceinline__ uint32_t code(float v, float scale) {
  const float c = rintf(__fdiv_rn(v, scale));
  const int8_t q = isnan(c) ? int8_t(0)
                            : static_cast<int8_t>(static_cast<int>(fminf(fmaxf(c, -127.0f),
                                                                         127.0f)));
  return static_cast<uint8_t>(q);
}

template <typename T>
__device__ __forceinline__ void load_unit(const T* __restrict__ p, bool vec, float (&v)[kUnit]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kUnit; i += Vec16<T>::n) load16<T>(p + i, v + i);
  } else {
#pragma unroll
    for (int i = 0; i < kUnit; ++i) v[i] = to_f(p[i]);
  }
}

__device__ __forceinline__ void store_unit(int8_t* __restrict__ q, bool vec,
                                           const float (&v)[kUnit], float scale) {
  if (vec) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = code(v[4 * i], scale) | (code(v[4 * i + 1], scale) << 8) |
             (code(v[4 * i + 2], scale) << 16) | (code(v[4 * i + 3], scale) << 24);
    *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kUnit; ++i) q[i] = static_cast<int8_t>(code(v[i], scale));
  }
}

// This thread's units u0 + threadIdx.x + k * kBlock (k < kUnits) of the row
// at x + row.base: loaded into v, all loads issued before the first use.
// Returns the max of their bits of |x|.
template <typename T, int kBlock, int kUnits>
__device__ __forceinline__ unsigned int load_units(const T* __restrict__ x, const Row& row,
                                                   int u0, bool vec,
                                                   float (&v)[kUnits][kUnit]) {
  const int u = u0 + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
    if (u + k * kBlock < row.units)
      load_unit(x + row.base + row.head + (size_t)(u + k * kBlock) * kUnit, vec, v[k]);
  unsigned int m = 0u;
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
    if (u + k * kBlock < row.units)
#pragma unroll
      for (int i = 0; i < kUnit; ++i) m = max(m, abs_bits(v[k][i]));
  return m;
}

// The codes of the units load_units loaded.
template <int kBlock, int kUnits>
__device__ __forceinline__ void store_units(int8_t* __restrict__ q, const Row& row, int u0,
                                            bool vec, const float (&v)[kUnits][kUnit],
                                            float scale) {
  const int u = u0 + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
    if (u + k * kBlock < row.units)
      store_unit(q + row.base + row.head + (size_t)(u + k * kBlock) * kUnit, vec, v[k], scale);
}

// The block's max of v, on every thread.
template <int kBlock>
__device__ __forceinline__ unsigned int block_max(unsigned int v) {
  __shared__ unsigned int warps[kBlock / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned int m = 0u;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) m = max(m, warps[w]);
  return m;
}

// The one-pass design: row blockIdx.x, kBlock threads, at most kUnits units
// a thread.
template <typename T, int kBlock, int kUnits>
__global__ void __launch_bounds__(kBlock)
quant_row_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                 int C, int vec) {
  const Row row = row_of(blockIdx.x, C, vec);
  float v[kUnits][kUnit];
  unsigned int m = load_units<T, kBlock, kUnits>(x, row, 0, vec, v);
  const int e = edge_of(row);
  float ev = 0.0f;
  if (e >= 0) {
    ev = to_f(x[row.base + e]);
    m = max(m, abs_bits(ev));
  }
  const float scale = scale_of(block_max<kBlock>(m));
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
  store_units<kBlock, kUnits>(q, row, 0, vec, v, scale);
  if (e >= 0) q[row.base + e] = static_cast<int8_t>(code(ev, scale));
}

// The two-pass design's first pass: chunk blockIdx.x of row blockIdx.y
// folds its absmax into the row's zeroed slot.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_absmax_kernel(const T* __restrict__ x, unsigned int* __restrict__ amax, int C, int vec) {
  const Row row = row_of(blockIdx.y, C, vec);
  float v[kPassUnits][kUnit];
  unsigned int m =
      load_units<T, kThreads, kPassUnits>(x, row, blockIdx.x * kChunkUnits, vec, v);
  const int e = blockIdx.x == 0 ? edge_of(row) : -1;
  if (e >= 0) m = max(m, abs_bits(to_f(x[row.base + e])));
  m = block_max<kThreads>(m);
  if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, m);
}

// The second pass: the same chunk's codes from the row's absmax.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_codes_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                   const unsigned int* __restrict__ amax, int C, int vec) {
  const Row row = row_of(blockIdx.y, C, vec);
  const float scale = scale_of(amax[blockIdx.y]);
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[blockIdx.y] = scale;
  const int u0 = blockIdx.x * kChunkUnits;
  float v[kPassUnits][kUnit];
  load_units<T, kThreads, kPassUnits>(x, row, u0, vec, v);
  store_units<kThreads, kPassUnits>(q, row, u0, vec, v, scale);
  const int e = blockIdx.x == 0 ? edge_of(row) : -1;
  if (e >= 0) q[row.base + e] = static_cast<int8_t>(code(to_f(x[row.base + e]), scale));
}

template <typename T>
int launch(const void* x, void* q, void* scales, void* amax, int R, int C,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (C <= kOneBlock) {
    const unsigned blocks = static_cast<unsigned>(R);
    if (C <= kThreads * kUnit)
      quant_row_kernel<T, kThreads, 1><<<blocks, kThreads, 0, stream>>>(xt, qt, st, C, vec);
    else if (C <= kWideThreads * kUnit)
      quant_row_kernel<T, kWideThreads, 1><<<blocks, kWideThreads, 0, stream>>>(xt, qt, st, C,
                                                                                vec);
    else
      quant_row_kernel<T, kWideThreads, kMaxUnits><<<blocks, kWideThreads, 0, stream>>>(
          xt, qt, st, C, vec);
    return static_cast<int>(cudaGetLastError());
  }
  // R * C < 2^31 keeps R within the grid's 65535 rows
  if (amax == nullptr || R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  unsigned int* at = static_cast<unsigned int*>(amax);
  cudaError_t err = cudaMemsetAsync(at, 0, sizeof(unsigned int) * R, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C / kUnit + kChunkUnits - 1) / kChunkUnits, R);
  quant_absmax_kernel<T><<<grid, kThreads, 0, stream>>>(xt, at, C, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_codes_kernel<T><<<grid, kThreads, 0, stream>>>(xt, qt, st, at, C, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x: (R, C) contiguous, dtype code 0 float32 or 1 bfloat16; q: (R, C) int8,
// 16-byte aligned; scales: (R,) float32; amax: (R,) 32-bit scratch, used
// (and zeroed) by the two-pass design only.  One launch on `stream` for C <=
// 32768, else a memset and two.  Returns the cudaError_t (0 on success).
extern "C" int quant_int8_fwd(int dtype, const void* x, void* q, void* scales, void* amax,
                              int R, int C, void* stream) {
  using namespace repro;
  if (R < 1 || C < 1 || reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, q, scales, amax, R, C, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, q, scales, amax, R, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* quant_int8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
