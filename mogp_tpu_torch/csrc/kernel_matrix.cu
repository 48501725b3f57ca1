// Fused kernel-matrix build for Gaussian-process prediction, batched over
// output lanes:
//
//     out[l, i, j] = sigma2[l] * k(r2),
//     r2 = sum_d exp_theta[l, d] * (x1[l, i, d] - x2[j, d])^2,
//
// with k(r2) = exp(-r2 / 2) (squared exponential) or
// (1 + sqrt(5 r2) + 5 r2 / 3) exp(-sqrt(5 r2)) (Matern 5/2, exactly 1 where
// r2 == 0).  Shapes: x1 (L, n, D), x2 (m, D), exp_theta (L, D), sigma2 (L),
// out (L, n, m); all contiguous, one floating type.
//
// Replaces mogp_tpu/ops/pallas_kernels.py::pallas_kernel_matrix, which the
// JAX package vmaps over outputs; here the outputs are the grid's z axis and
// the sigma2 scale is fused into the store.
//
// What bounds it on an H100: at D = 14 every output element costs about
// 3 D + 20 flops and one 4- or 8-byte store, so the kernel does about 0.2
// flop per byte of the (L, n, m) output it writes and is bound by that
// write.  The design answer for now is coalesced stores: threads run along
// m, so each warp writes 32 consecutive elements of an output row.  The real
// fix is to fuse the consumers (mu = K*^T alpha, the R correction, solve_L)
// so that K* never reaches device memory; that is later work.
//
// The distance uses the direct-difference form: with D this small it costs
// the same as the matmul form |z1|^2 + |z2|^2 - 2 z1.z2 and has no
// cancellation; the max(r2, 0) of the TPU kernel is kept all the same.
// Ragged edges are masked here; nothing is padded on the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast-math: exp and sqrt stay IEEE).  C interface,
// loaded with ctypes by mogp_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // query columns per block, one per thread
constexpr int kRows = 16;      // training rows per block, kept in registers
constexpr int kDimChunk = 16;  // input dimensions staged per pass

constexpr int kSqExp = 0;
constexpr int kMat52 = 1;

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) { return fma(a, b, c); }

template <typename T, int Base>
__device__ __forceinline__ T kernel_of_r2(T r2) {
  if (Base == kSqExp) {
    return dev_exp(T(-0.5) * r2);
  }
  if (r2 > T(0)) {
    const T r = dev_sqrt(T(5) * r2);
    return (T(1) + r + (T(5) / T(3)) * r2) * dev_exp(-r);
  }
  return T(1);
}

template <typename T, int Base>
__global__ void __launch_bounds__(kThreads)
kernel_matrix_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ exp_theta,
                     const T* __restrict__ sigma2, T* __restrict__ out, int n,
                     int m, int D) {
  // x2 tile transposed (dimension-major) so that thread t reads column t
  // without bank conflicts; +1 pads the staging writes.
  __shared__ T x2s[kDimChunk][kThreads + 1];
  __shared__ T x1s[kRows][kDimChunk];
  __shared__ T scale[kDimChunk];

  const int lane = blockIdx.z;
  const int j0 = blockIdx.x * kThreads;
  const int i0 = blockIdx.y * kRows;
  const int t = threadIdx.x;

  const T* x1_lane = x1 + static_cast<size_t>(lane) * n * D;
  const T* theta_lane = exp_theta + static_cast<size_t>(lane) * D;

  T acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = T(0);

  for (int d0 = 0; d0 < D; d0 += kDimChunk) {
    const int dc = min(kDimChunk, D - d0);
    if (t < kDimChunk) scale[t] = t < dc ? dev_sqrt(theta_lane[d0 + t]) : T(0);
    __syncthreads();
    // Stage scaled inputs; masked rows and dimensions are zero, so they add
    // nothing to r2 and padded rows are never stored.
    for (int k = t; k < kThreads * kDimChunk; k += kThreads) {
      const int row = k / kDimChunk;
      const int col = k - row * kDimChunk;
      const int j = j0 + row;
      x2s[col][row] = (j < m && col < dc)
                          ? x2[static_cast<size_t>(j) * D + d0 + col] * scale[col]
                          : T(0);
    }
    for (int k = t; k < kRows * kDimChunk; k += kThreads) {
      const int row = k / kDimChunk;
      const int col = k - row * kDimChunk;
      const int i = i0 + row;
      x1s[row][col] =
          (i < n && col < dc)
              ? x1_lane[static_cast<size_t>(i) * D + d0 + col] * scale[col]
              : T(0);
    }
    __syncthreads();
    for (int c = 0; c < dc; ++c) {
      const T z2 = x2s[c][t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const T diff = x1s[r][c] - z2;
        acc[r] = dev_fma(diff, diff, acc[r]);
      }
    }
    __syncthreads();
  }

  const int j = j0 + t;
  if (j >= m) return;
  const T s2 = sigma2[lane];
  T* out_lane = out + static_cast<size_t>(lane) * n * m;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i < n) {
      const T r2 = acc[r] > T(0) ? acc[r] : T(0);
      out_lane[static_cast<size_t>(i) * m + j] = s2 * kernel_of_r2<T, Base>(r2);
    }
  }
}

template <typename T>
void launch(const void* x1, const void* x2, const void* exp_theta,
            const void* sigma2, void* out, int L, int n, int m, int D,
            int base, cudaStream_t stream) {
  const dim3 grid((m + kThreads - 1) / kThreads, (n + kRows - 1) / kRows, L);
  const dim3 block(kThreads);
  const T* a = static_cast<const T*>(x1);
  const T* b = static_cast<const T*>(x2);
  const T* e = static_cast<const T*>(exp_theta);
  const T* s = static_cast<const T*>(sigma2);
  T* o = static_cast<T*>(out);
  if (base == kSqExp) {
    kernel_matrix_kernel<T, kSqExp><<<grid, block, 0, stream>>>(a, b, e, s, o, n, m, D);
  } else {
    kernel_matrix_kernel<T, kMat52><<<grid, block, 0, stream>>>(a, b, e, s, o, n, m, D);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// base: 0 squared exponential, 1 Matern 5/2; is_double: 0 float, 1 double.
int mogp_kernel_matrix(const void* x1, const void* x2, const void* exp_theta,
                       const void* sigma2, void* out, int L, int n, int m,
                       int D, int base, int is_double, void* stream) {
  if (base != kSqExp && base != kMat52) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    launch<double>(x1, x2, exp_theta, sigma2, out, L, n, m, D, base, s);
  } else {
    launch<float>(x1, x2, exp_theta, sigma2, out, L, n, m, D, base, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mogp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
