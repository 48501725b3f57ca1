// Batched lower Cholesky factorization of small symmetric positive-definite
// matrices, one thread block per matrix:
//
//     out[b] = L,  L L^T = A[b],  L lower triangular, upper triangle zero,
//
// for A (B, n, n) and out (B, n, n), contiguous, one floating type.  Only
// the lower triangle of A is read.  A matrix with a pivot that is not
// positive and finite comes out all NaN, upper triangle included; the
// other matrices of the batch are untouched.
//
// Replaces tools/pallas_cholesky_experiment.py::cholesky_batched (K2),
// which factors a VMEM-resident chunk of matrices in lockstep, one wide
// vector operation per column.  Here the batch is the grid: each block
// keeps its own matrix on chip for the whole factorization.
//
// What bounds it on an H100: the fit factors (lanes x rungs) matrices at
// n ~ 210, about n^3 / 6 = 1.5 Mflop each against 2 n^2 words of device
// traffic, so device memory is not the limit; shared-memory traffic and the
// 2 n block-wide barriers of the column loop are.  The design answer:
//
// * The packed lower triangle lives in dynamic shared memory, column-major
//   (column j holds rows j..n-1 contiguously): the column scale, the
//   broadcast of L[k, j] and the rank-1 update of column k all touch
//   consecutive words, so a warp's accesses are free of bank conflicts.
//   n(n+1)/2 words: 88.6 KB in float and 177 KB in double at n = 210, two
//   blocks or one block per SM.  The block opts into up to 227 KB, so this
//   path takes n <= 340 in float and n <= 240 in double.
// * Right-looking, unblocked: for each column j, scale it by the square
//   root of its pivot, then subtract the rank-1 update from the trailing
//   triangle, one warp per trailing column, lanes along its rows.
// * The pivot is read by every thread, so every thread takes the same
//   decision on failure and the loop exits uniformly; no flag is shared.
// * Two barriers per column.  A variant with one (the update using the
//   unscaled column, each column scaled one step late, the column cached
//   in registers) measured slower on the H100 at (960, 210, 210).
//
// Loads and stores walk A and out row-major, so device traffic is
// coalesced; the scatter into the packed triangle happens in shared memory.
//
// Larger n (cholesky_batched_global_kernel): the same column loop, one
// block per matrix, working in `out` itself.  The factor is built as
// U = L^T in the upper triangle, so row j of U is column j of L and both
// the column scale and the row-wise rank-1 update touch consecutive words
// of device memory; a last pass moves U into the lower triangle and zeroes
// the upper one.  It has no bound on n, but its update runs from L2 and
// device memory, and a small batch leaves most SMs idle: a blocked
// factorization over many blocks is the way to make it fast.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast-math: sqrt and division stay IEEE).  C
// interface, loaded with ctypes by mogp_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// 512 threads: two blocks of 16 warps per SM in float at n = 210, which
// hides the shared-memory latency of the update better than 8 warps
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the global-memory path: as many loads in flight per SM as a block allows
constexpr int kGlobalThreads = 1024;
constexpr int kGlobalWarps = kGlobalThreads / 32;

// offset of column j in the packed column-major lower triangle
__device__ __forceinline__ int col_start(int j, int n) {
  return j * n - (j * (j - 1)) / 2;
}

__device__ __forceinline__ bool good_pivot(float d) {
  return d > 0.0f && d <= 3.402823466e+38f;  // false for NaN and inf
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cholesky_batched_kernel(const T* __restrict__ a, T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* p = reinterpret_cast<T*>(smem_raw);

  const size_t nn = static_cast<size_t>(n) * n;
  const T* a_mat = a + blockIdx.x * nn;
  T* out_mat = out + blockIdx.x * nn;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int nsq = n * n;

  for (int e = t; e < nsq; e += kThreads) {
    const int i = e / n;
    const int k = e - i * n;
    if (k <= i) p[col_start(k, n) + i - k] = a_mat[e];
  }
  __syncthreads();

  bool bad = false;
  for (int j = 0; j < n; ++j) {
    const int cj = col_start(j, n);
    const T d = p[cj];
    if (!good_pivot(d)) {
      bad = true;  // every thread read the same pivot: a uniform exit
      break;
    }
    const T s = dev_sqrt(d);
    for (int i = j + 1 + t; i < n; i += kThreads) p[cj + i - j] = p[cj + i - j] / s;
    __syncthreads();
    // every thread has read the pivot: the diagonal can take its root
    if (t == 0) p[cj] = s;
    for (int k = j + 1 + warp; k < n; k += kWarps) {
      const T lk = p[cj + k - j];
      const int ck = col_start(k, n);
      for (int i = k + lane; i < n; i += 32) {
        p[ck + i - k] = dev_fma(-p[cj + i - j], lk, p[ck + i - k]);
      }
    }
    __syncthreads();
  }

  for (int e = t; e < nsq; e += kThreads) {
    const int i = e / n;
    const int k = e - i * n;
    T v = T(0);
    if (bad) {
      v = dev_nan(v);
    } else if (k <= i) {
      v = p[col_start(k, n) + i - k];
    }
    out_mat[e] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGlobalThreads)
cholesky_batched_global_kernel(const T* __restrict__ a, T* out, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  const T* a_mat = a + blockIdx.x * nn;
  T* u = out + blockIdx.x * nn;  // U = L^T, row-major: u[k n + i], i >= k
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;

  // u[r, c] = A[c, r] for c >= r: coalesced stores, strided loads
  for (size_t e = t; e < nn; e += kGlobalThreads) {
    const size_t r = e / n;
    const size_t c = e - r * n;
    if (c >= r) u[e] = a_mat[c * n + r];
  }
  __syncthreads();

  bool bad = false;
  for (int j = 0; j < n; ++j) {
    T* uj = u + static_cast<size_t>(j) * n;
    const T d = uj[j];
    if (!good_pivot(d)) {
      bad = true;  // every thread read the same pivot: a uniform exit
      break;
    }
    const T s = dev_sqrt(d);
    for (int i = j + 1 + t; i < n; i += kGlobalThreads) uj[i] = uj[i] / s;
    __syncthreads();
    if (t == 0) uj[j] = s;
    for (int k = j + 1 + warp; k < n; k += kGlobalWarps) {
      const T lk = uj[k];
      T* uk = u + static_cast<size_t>(k) * n;
      for (int i = k + lane; i < n; i += 32) uk[i] = dev_fma(-uj[i], lk, uk[i]);
    }
    __syncthreads();
  }

  // L = U^T into the lower triangle, zeros above; each (r, c) pair with
  // c > r belongs to one thread, so the swap needs no barrier
  for (size_t e = t; e < nn; e += kGlobalThreads) {
    const size_t r = e / n;
    const size_t c = e - r * n;
    if (bad) {
      u[e] = dev_nan(T(0));
    } else if (c > r) {
      u[c * n + r] = u[e];
      u[e] = T(0);
    }
  }
}

template <typename T>
int launch(const void* a, void* out, int batch, int n, int in_shared,
           cudaStream_t stream) {
  if (!in_shared) {
    cholesky_batched_global_kernel<T><<<batch, kGlobalThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<T*>(out), n);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = static_cast<size_t>(n) * (n + 1) / 2 * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cholesky_batched_kernel<T><<<batch, kThreads, bytes, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// the error of raising the block's shared-memory limit.  is_double: 0
// float, 1 double.  in_shared: 1 for the shared-memory kernel (the caller
// checks that the packed triangle fits), 0 for the global-memory one.
// batch >= 1 and n >= 1.
int mogp_cholesky_batched(const void* a, void* out, int batch, int n,
                          int is_double, int in_shared, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(a, out, batch, n, in_shared, s);
  return launch<float>(a, out, batch, n, in_shared, s);
}

}  // extern "C"
