// Shared pieces of the tensor-core flash backward kernels (flash_dq_tc.cu,
// flash_dkv_tc.cu): the causal (or not) / sliding-window mask, the 64 x 64
// score product over hd in short wgmma chains, and the near-tie recompute
// of a score as a float32 fmaf chain.  Head dims 64, 80, 112 and 128: a
// 64-row tile holds hd / 64 boxes rounded up (the last zero-filled past hd
// at 80 and 112), and both the chains and the recompute stop at hd.
//
// Rounding.  Both kernels round p or ds to bf16 before a product, so a
// logit or dp a few ulps off the plain version's can put one across a
// rounding tie, and one such flip at a large value moves a gradient by ulp
// times an operand (2e-3 at p near 1/3 in dv).  The tensor cores' sums are
// less exact than fmaf chains; so the scores run in chains of kChain k16
// steps added in float32 (tile_dot), and where a rounded value lands within
// kNearTie float32 ulps of a tie at a size where a flip matters (p >= kTieP,
// |ds| >= kTieDs), the kernels take its logit and dp again as fmaf chains
// from the same tiles in shared memory (row_dot), which leaves the flips as
// rare as the FMA kernels'.
#pragma once

#include "hopper.cuh"

namespace repro {
namespace tc {

constexpr int kChain = 2;  // k16 steps per wgmma chain of a score tile (see tile_dot)

// Query row `row` of Sq at position q0 + row against key `key` of Sk at
// position key (self-attention: q0 = 0, Sk = Sq); without causality a
// window cuts one side only (a row sees every later key).
template <bool kCausal>
__device__ __forceinline__ bool attend(int row, int key, int Sq, int Sk, int q0, int window) {
  const int rel = q0 + row - key;
  return row < Sq && key < Sk && (!kCausal || rel >= 0) && (window <= 0 || rel < window);
}

// d (64 x 64) = A B^T over hd, A and B K-major 64-row tiles: chains of
// kChain k16 steps, each begun afresh (the first in d, the others in tmp)
// and added into d in float32 with round-to-nearest, so no chain's
// truncating sum runs over all of hd.
template <int HD>
__device__ __forceinline__ void tile_dot(float (&d)[32], float (&tmp)[32], const uint8_t* a,
                                         const uint8_t* b) {
  constexpr int kSteps = HD / 16;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    const uint64_t da = smem_desc(a + off, 16, kSwizzleAtom), db = smem_desc(b + off, 16, kSwizzleAtom);
    if (kk < kChain) {
      wgmma_m64n64k16_k(d, da, db, kk > 0);
    } else {
      wgmma_m64n64k16_k(tmp, da, db, kk % kChain > 0);
    }
    if (kk % kChain == kChain - 1 || kk == kSteps - 1) {
      wgmma_commit();
      if (kk >= kChain) {
        wgmma_wait<0>();
        fence_regs(d);
        fence_regs(tmp);
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] += tmp[i];
        if (kk < kSteps - 1) wgmma_fence();
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
}

// Where p or ds is recomputed: within 16 float32 ulps of a bf16 tie, at p >=
// 2^-8 or |ds| >= 2^-5 (below, a flip moves dv by at most 2^-15 |dO|, dq or
// dk by scale 2^-12 |k| or |q|).
constexpr int kNearTie = 16;
constexpr float kTieP = 0.00390625f, kTieDs = 0.03125f;

// Whether v lies within kNearTie float32 ulps of a bf16 rounding tie (its
// low 16 bits near 0x8000), where a logit or dp a few ulps off could round
// it to the other neighbour.
__device__ __forceinline__ bool near_tie(float v) {
  return ((__float_as_uint(v) + (kNearTie - 0x8000)) & 0xFFFFu) < 2 * kNearTie;
}

// The dot of row ra of tile a with row rb of tile b (64-row bf16 tiles in
// boxes of 64 features with the 128-byte swizzle: the 16-byte chunk c of
// row r lies at chunk c ^ (r % 8)), as a float32 fmaf chain in feature
// order, as the FMA kernels form it.
template <int HD>
__device__ __forceinline__ float row_dot(const uint8_t* a, int ra, const uint8_t* b, int rb) {
  float acc = 0.0f;
#pragma unroll 1
  for (int c = 0; c < HD / 8; ++c) {
    const int box = (c / 8) * kBoxBytes, ch = c % 8;
    const uint4 va = *reinterpret_cast<const uint4*>(a + box + ra * 128 + ((ch ^ (ra & 7)) << 4));
    const uint4 vb = *reinterpret_cast<const uint4*>(b + box + rb * 128 + ((ch ^ (rb & 7)) << 4));
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&va);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&vb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(ha[i]), fb = __bfloat1622float2(hb[i]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  return acc;
}

// The reference's p and ds of one (row, key) pair from its raw q.k dot s
// and dO.v dot dp: scale, the tanh softcap, p = exp(logit - lse) where the
// mask allows (ok) and exactly 0 elsewhere, ds = p (dp - delta) [* (1 -
// tanh^2)].
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta, bool ok,
                                     float scale, float softcap, float& p, float& ds) {
  float x = s * scale;
  float capped = 0.0f;
  if (softcap > 0.0f) {
    capped = tanhf(x / softcap);
    x = capped * softcap;
  }
  p = ok ? expf(x - lse) : 0.0f;
  ds = p * (dp - delta);
  if (softcap > 0.0f) ds *= 1.0f - capped * capped;
}

}  // namespace tc
}  // namespace repro
