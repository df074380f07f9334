// The int64 fixed point in which the source gradients of csrc/warp2d.cu
// (vecint2d_bwd) and csrc/warp3d.cu (B5, vecint3d_bwd) are summed, so that
// the sums are the same bits in any order.
//
// A term t becomes the integer __float2ll_rn(t * 2^e); the sum S of such
// integers becomes the float __ll2float_rn(S) * 2^-e.  With m = max|term
// source| < 2^E (E from m's exponent field) and at most N <= 2^L terms a
// sum, each at most m, e = min(61 - E - L, 100) keeps every sum below 2^61;
// its resolution is 2^(E + L - 61) of max|g|'s order.  m = 0 gives e = 100
// and an exact 0, with no division; a non-finite m (a NaN or inf) is
// flagged, and the caller writes NaN.  ops/warp.py's
// _fixed_point_exponent takes e the same way.

#pragma once

#include <cuda_runtime.h>

namespace {

// The fixed point of a sum's terms, from max|g|'s bits.
struct Fixed {
  float scale, inv;   // 2^e and 2^-e
  bool finite;        // max|g| is finite
};

// `n` is the most terms a sum takes (n < 2^L).
__device__ __forceinline__ Fixed fixed_of(unsigned mbits, int n) {
  const int E = max((int)(mbits >> 23), 1) - 126;   // max|g| < 2^E
  const int L = 32 - __clz(n);                      // n < 2^L
  const int e = min(61 - E - L, 100);               // in [-98, 100]
  Fixed f;
  f.scale = __int_as_float((127 + e) << 23);
  f.inv = __int_as_float((127 - e) << 23);
  f.finite = mbits < 0x7f800000u;
  return f;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;   // ordered as |v|, NaN on top
}

}  // namespace
