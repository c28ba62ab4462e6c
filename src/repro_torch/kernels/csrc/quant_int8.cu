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
// One design covers both shapes.  Every row is cut into chunks of kChunk
// elements; one block takes one (row, chunk).  Pass 1 takes the absmax of
// its chunk and folds it into the row's slot with atomicMax on the bits of
// the non-negative float (for non-negative IEEE floats the order of the
// bits is the order of the values): max does not depend on the order of
// reduction, so every run gives the same bits, and a 45 M-element leaf
// needs no second reduction pass.  Pass 2 reads the row's absmax, forms the
// scale in float32 exactly as the reference does, and quantises its chunk;
// the chunk-0 block writes the row's scale.  The TPU kernel pads R up to a
// multiple of its block rows with jnp.pad; here the ragged tail of a row is
// masked, nothing is padded in memory.
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
// What bounds it on the H100: bytes.  x is read twice (once per pass; the
// second read mostly hits L2 only for small tensors) and q written once:
// 5 bytes per float32 element in the bound, 3 per bf16.  This first version
// uses scalar, coalesced loads; vector loads and a single pass over a row
// that fits one block are later steps.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;  // elements per block

__device__ __forceinline__ unsigned int block_max(unsigned int v) {
  __shared__ unsigned int warps[kThreads / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warps[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
  }
  return v;  // valid in thread 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, unsigned int* __restrict__ amax_bits, int C,
              int n_chunks) {
  const int row = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const T* base = x + (size_t)row * C;
  const int c0 = chunk * kChunk;
  unsigned int m = 0u;  // the bits of |x|: NaN > +inf > every finite value
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = c0 + k * kThreads + threadIdx.x;
    if (c < C) m = max(m, __float_as_uint(fabsf(to_f(base[c]))));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax_bits + row, m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, const unsigned int* __restrict__ amax_bits,
             int8_t* __restrict__ q, float* __restrict__ scales, int C, int n_chunks) {
  const int row = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  // max(absmax, 1e-12) in the same order of bits, so a NaN absmax stays NaN
  const unsigned int floor_bits = __float_as_uint(static_cast<float>(1e-12));
  const float absmax = __uint_as_float(max(amax_bits[row], floor_bits));
  const float scale = __fdiv_rn(absmax, 127.0f);
  if (chunk == 0 && threadIdx.x == 0) scales[row] = scale;
  const size_t off = (size_t)row * C;
  const int c0 = chunk * kChunk;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = c0 + k * kThreads + threadIdx.x;
    if (c < C) {
      const float v = rintf(__fdiv_rn(to_f(x[off + c]), scale));
      q[off + c] = isnan(v) ? int8_t(0)
                            : static_cast<int8_t>(static_cast<int>(fminf(fmaxf(v, -127.0f),
                                                                        127.0f)));
    }
  }
}

template <typename T>
int launch(const void* x, void* q, void* scales, void* amax, int R, int C,
           cudaStream_t stream) {
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const long long blocks = (long long)R * n_chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(amax, 0, (size_t)R * sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<unsigned int*>(amax), C, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned int*>(amax),
      static_cast<int8_t*>(q), static_cast<float*>(scales), C, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x: (R, C) contiguous, dtype code 0 float32 or 1 bfloat16; q: (R, C) int8;
// scales: (R,) float32; amax: (R,) 32-bit scratch (zeroed here).  A memset
// and two launches on `stream`.  Returns the cudaError_t (0 on success).
extern "C" int quant_int8_fwd(int dtype, const void* x, void* q, void* scales, void* amax,
                              int R, int C, void* stream) {
  using namespace repro;
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, q, scales, amax, R, C, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, q, scales, amax, R, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* quant_int8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
