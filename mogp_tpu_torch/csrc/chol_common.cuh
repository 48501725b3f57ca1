// Scalar helpers shared by the Cholesky kernels (cholesky_batched.cu,
// cholesky_blocked.cu), overloaded for float and double so that each
// kernel is one template.  IEEE throughout: no fast-math, no TF32.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace mogp {

// a pivot the factorization may take the root of: false for <= 0, NaN, inf
__device__ __forceinline__ bool good_pivot(float d) {
  return d > 0.0f && d <= 3.402823466e+38f;
}
__device__ __forceinline__ bool good_pivot(double d) {
  return d > 0.0 && d <= 1.7976931348623157e+308;
}
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_nan(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double dev_nan(double) { return CUDART_NAN; }
__device__ __forceinline__ float dev_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) { return fma(a, b, c); }

}  // namespace mogp
