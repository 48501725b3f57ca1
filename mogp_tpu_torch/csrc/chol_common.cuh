// Scalar helpers shared by the Cholesky kernels (cholesky_batched.cu,
// cholesky_blocked.cu), overloaded for float and double so that each
// kernel is one template.  No fast-math and no single-pass TF32; the one
// approximate operation is dev_rsqrt, the pivot's reciprocal square root.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// Phase stamps, for mogp_tpu_torch/tools/chol_phases.py only: it builds
// these sources with -DMOGP_PHASE_STAMPS, and thread 0 of block 0 then adds
// the clock64() cycles since its previous stamp to mogp_phase_cycles[i] at
// MOGP_PHASE(i).  The slots: K2 0 load, 1 tile, 2 rows, 3 trailing update,
// 4 store; the blocked diag step 0 load, 1 tiles, 2 rows, 3 trailing
// update, 4 store; variant 1's panel step 5 load, 6 rank-1 steps (less 12
// and 13: warp 0's work before each barrier and its waits at it, summed in
// registers by MOGP_LAP and added once by MOGP_LAP_FLUSH), 7 store;
// the rows step 8 load, 9 products, 10 substitutions, 11 store; the update
// 16 waiting for stages, 17 products, 18 epilogue; variant 3's panel step
// (block 0's warp 0, which runs the chain of tiles) 19 load, 25 the next
// tile's rank-16 update, 24 its rank-1 factorization, 20 its Newton
// inverse, 21 its rows' product M X^T, 22 the wait at the micro-panel's
// barrier for the other warps' products and updates, 23 store.  In the
// library's own build the macros are empty.
#ifdef MOGP_PHASE_STAMPS
__device__ long long mogp_phase_cycles[64];
#define MOGP_PHASE_BEGIN() long long mogp_phase_last_ = clock64()
#define MOGP_PHASE(i)                                                 \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                        \
      const long long mogp_phase_now_ = clock64();                    \
      mogp_phase_cycles[i] += mogp_phase_now_ - mogp_phase_last_;     \
      mogp_phase_last_ = mogp_phase_now_;                             \
    }                                                                 \
  } while (0)
#define MOGP_LAP_BEGIN() long long mogp_lap_[2] = {0, 0}, mogp_lap_last_ = clock64()
#define MOGP_LAP(i)                                                   \
  do {                                                                \
    const long long mogp_lap_now_ = clock64();                        \
    mogp_lap_[i] += mogp_lap_now_ - mogp_lap_last_;                   \
    mogp_lap_last_ = mogp_lap_now_;                                   \
  } while (0)
#define MOGP_LAP_FLUSH(s0, s1)                                        \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                        \
      mogp_phase_cycles[s0] += mogp_lap_[0];                          \
      mogp_phase_cycles[s1] += mogp_lap_[1];                          \
      mogp_phase_last_ = clock64();                                   \
    }                                                                 \
  } while (0)
#else
#define MOGP_PHASE_BEGIN()
#define MOGP_PHASE(i)
#define MOGP_LAP_BEGIN()
#define MOGP_LAP(i)
#define MOGP_LAP_FLUSH(s0, s1)
#endif

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
