// IEEE division with a fast path for a zero dividend.
//
// On sm_90 a correctly rounded division checks its operands (FCHK in f32)
// and leaves its reciprocal-based fast path for a +-0 dividend: on an H100,
// 16 dependent f32 divisions per thread ran ~2.9x slower with zero
// dividends than with normal ones (scripts/kernel_variants.py).  Cells
// without cloud or rain make most dividends of the Kessler and FCT kernels
// zero.
// div0(a, b) gives a / b bit for bit: for a = +-0 and any b but 0 and NaN,
// IEEE's quotient is a zero whose sign is sign(a) xor sign(b).
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float signed_zero(float a, float b) {
  return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                        (int)0x80000000u);
}
__device__ __forceinline__ double signed_zero(double a, double b) {
  return __longlong_as_double(
      (__double_as_longlong(a) ^ __double_as_longlong(b)) &
      (long long)0x8000000000000000ull);
}

template <typename T>
__device__ __forceinline__ T div0(T a, T b) {
#ifndef NO_DIV0
  if (a == T(0) && b != T(0) && b == b) return signed_zero(a, b);
#endif
  return a / b;
}

}  // namespace
