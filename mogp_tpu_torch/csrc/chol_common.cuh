// Scalar helpers shared by the Cholesky kernels (cholesky_batched.cu,
// cholesky_blocked.cu), overloaded for float and double so that each
// kernel is one template.  No fast-math and no single-pass TF32; the one
// approximate operation is dev_rsqrt, the pivot's reciprocal square root.
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
// 1 / sqrt(x): rsqrtf is within 2 ulp, rsqrt (double) within 1
__device__ __forceinline__ float dev_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double dev_rsqrt(double x) { return rsqrt(x); }
// four consecutive elements of shared memory, 16-byte aligned
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
}
__device__ __forceinline__ float dev_nan(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double dev_nan(double) { return CUDART_NAN; }
__device__ __forceinline__ float dev_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) { return fma(a, b, c); }

}  // namespace mogp
