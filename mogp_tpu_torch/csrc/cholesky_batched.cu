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
// traffic.  At (960, 210, 210) float32 the bound is 0.076 ms (254 MB at
// 3.35 TB/s; the flops take 0.044 ms at 67 TFLOP/s), but one matrix is a
// chain of dependent columns in one block, so barriers and shared-memory
// traffic are what it waits on.  The unblocked design took 2n = 420
// block-wide barriers per matrix and three shared accesses (two loads, a
// store) per FMA of its rank-1 updates.  The design answer:
//
// * The packed lower triangle lives in dynamic shared memory, column-major
//   (column j holds rows j..n-1 contiguously): a warp's lanes on
//   consecutive rows of one column touch consecutive words, free of bank
//   conflicts.  n(n+1)/2 words: 88.6 KB in float and 177 KB in double at
//   n = 210, two blocks or one block per SM.  The block opts into up to
//   227 KB, so this path takes n <= 340 in float and n <= 240 in double.
// * Right-looking in micro-panels of kNB = 16 columns, three barriers per
//   panel (42 per matrix at n = 210, not 420):
//   1. warp 0 factors the panel's 16 x 16 diagonal tile in registers, lane
//      r holding row r, as cholesky_blocked.cu's factor_tile does; a bad
//      pivot sets a shared flag;
//   2. a thread per row solves the panel's rows below the tile, L[i, P] =
//      A[i, P] L_D^-T, in registers;
//   3. the rank-16 update of the trailing triangle: work items of 64 rows
//      (two per lane) by 16 columns, spread over the warps; each lane keeps
//      its rows' 16 panel entries in registers, the entries of column k
//      arrive as broadcasts (every lane reads the same word) and serve both
//      rows, and each trailing element is loaded and stored once per panel
//      for 16 FMAs.
// * The tile's pivots are a serial chain: each takes one rsqrt (within 2
//   ulp in float), no square root and no division; the reciprocal scales
//   the column, as LAPACK's potf2 scales by 1 / L[k][k], and the rows below
//   use the reciprocals.  The next column and pivot come by shuffles; the
//   columns after it are updated off the chain from a 32-element scratch,
//   read in 16-byte broadcasts.
// * The flag is read by every thread after a barrier, so the loop exits
//   uniformly on a bad pivot and the matrix comes out all NaN.
//
// Loads and stores walk A and out row-major, so device traffic is
// coalesced; the scatter into the packed triangle happens in shared memory.
//
// Larger n go to the blocked factorization of cholesky_blocked.cu (K3-K5,
// routed by ops/cholesky_batched.py::route): there a panel loop spreads
// each matrix over many blocks.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast-math).  C
// interface, loaded with ctypes by mogp_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

#include "chol_common.cuh"

namespace {

using mogp::dev_fma;
using mogp::dev_nan;
using mogp::dev_rsqrt;
using mogp::good_pivot;
using mogp::load4;

// 256 threads with up to 128 registers each: two blocks per SM in float at
// n = 210, each lane holding two rows of the panel in the trailing update
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 16;    // micro-panel width
constexpr int kRows = 64;  // rows of one work item of the trailing update: two per lane

// one element global -> shared by cp.async
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

// offset of column j in the packed column-major lower triangle
__device__ __forceinline__ int col_start(int j, int n) {
  return j * n - (j * (j - 1)) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
cholesky_batched_kernel(const T* __restrict__ a, T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* p = reinterpret_cast<T*>(smem_raw);
  __shared__ int bad;
  __shared__ T dinv[kNB];                // 1 / L[j0 + q][j0 + q] of the panel
  __shared__ __align__(16) T col[32];    // the tile's column in the making

  const size_t nn = static_cast<size_t>(n) * n;
  const T* a_mat = a + blockIdx.x * nn;
  T* out_mat = out + blockIdx.x * nn;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;

  // the lower triangle in, a warp per row, by cp.async: every copy in flight
  // at once, scattered into the packed columns without passing registers
  for (int i = warp; i < n; i += kWarps) {
    for (int k = lane; k <= i; k += 32) {
      cp_async_elem(p + col_start(k, n) + i - k, a_mat + i * n + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (t == 0) bad = 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += kNB) {
    const int nb = min(kNB, n - j0);
    // element (i, j0 + q) of the panel, i >= j0 + q, is p[cs(q) + i]: two
    // registers for the sixteen column offsets (q is a constant once unrolled)
    const int cs0 = col_start(j0, n) - j0, step = n - j0 - 1;
    auto cs = [cs0, step](int q) { return cs0 + q * step - (q * (q - 1)) / 2; };

    // 1. the diagonal tile, by warp 0: lane l holds row j0 + l
    if (warp == 0) {
      T v[kNB];
#pragma unroll
      for (int k = 0; k < kNB; ++k) v[k] = (lane < nb && k <= lane) ? p[cs(k) + j0 + lane] : T(0);
      T d = __shfl_sync(0xffffffffu, v[0], 0);
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        if (k >= nb) break;
        if (!good_pivot(d)) {  // every lane read the same pivot
          if (lane == 0) bad = 1;
          break;
        }
        // the pivot chain is the tile's latency: one rsqrt, no division, and
        // the next pivot formed on lane k + 1 from its own row at once
        const T r = dev_rsqrt(d);
        if (lane == k) dinv[k] = r;
        v[k] = lane == k ? d * r : lane > k ? v[k] * r : v[k];
        if (k + 1 < kNB) {  // column k + 1 by a shuffle, the rest from col
          const int k1 = k + 1 < kNB ? k + 1 : k;  // in range where the branch is dead
          const T lk1 = __shfl_sync(0xffffffffu, v[k], k1);
          const T own = dev_fma(-v[k], v[k], v[k1]);
          v[k1] = dev_fma(-v[k], lk1, v[k1]);
          d = __shfl_sync(0xffffffffu, own, k1);
        }
        col[lane] = v[k];  // L[j0 + lane][j0 + k] below the pivot
        __syncwarp();
        // unmasked: a lane's entries above its diagonal are never read back
#pragma unroll
        for (int c4 = 0; c4 < kNB; c4 += 4) {
          if (c4 + 3 <= k + 1) continue;
          T w[4];
          load4(col + c4, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (c4 + q > k + 1) v[c4 + q] = dev_fma(-v[k], w[q], v[c4 + q]);
          }
        }
        __syncwarp();  // col is read before the next step writes it
      }
      if (lane < nb) {
#pragma unroll
        for (int k = 0; k < kNB; ++k) {
          if (k <= lane) p[cs(k) + j0 + lane] = v[k];
        }
      }
    }
    __syncthreads();
    if (bad) break;           // read by every thread after the barrier: a uniform exit
    const int c0 = j0 + kNB;  // the trailing triangle starts here (nb == kNB below)
    if (c0 >= n) break;

    // 2. the panel's rows below the tile, a thread per row
    for (int i = c0 + t; i < n; i += kThreads) {
      T x[kNB];
#pragma unroll
      for (int q = 0; q < kNB; ++q) x[q] = p[cs(q) + i];
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        x[k] *= dinv[k];
#pragma unroll
        for (int c = k + 1; c < kNB; ++c) x[c] = dev_fma(-x[k], p[cs(k) + j0 + c], x[c]);
      }
#pragma unroll
      for (int q = 0; q < kNB; ++q) p[cs(q) + i] = x[q];
    }
    __syncthreads();

    // 3. P(i, k) -= sum_q L[i][j0 + q] L[k][j0 + q] for c0 <= k <= i < n, in
    // items of 64 rows (lane: rows r0 + lane and r0 + 32 + lane) by 16
    // columns, item m to warp m % kWarps.  Row k of the panel (a broadcast)
    // serves both rows; the next one is loaded before this one's results are
    // stored, which the compiler could not reorder itself.
    int item = 0;
    for (int r0 = c0; r0 < n; r0 += kRows) {
      const int ia = r0 + lane, ib = ia + 32;
      const int rlast = min(n, r0 + kRows) - 1;
      for (int k0 = c0; k0 <= rlast; k0 += kNB, ++item) {
        if (item % kWarps != warp) continue;
        T xa[kNB], xb[kNB], y[kNB];
#pragma unroll
        for (int q = 0; q < kNB; ++q) {
          xa[q] = ia < n ? p[cs(q) + ia] : T(0);
          xb[q] = ib < n ? p[cs(q) + ib] : T(0);
          y[q] = p[cs(q) + k0];
        }
        const int k1 = min(k0 + kNB, rlast + 1);
        for (int k = k0; k < k1; ++k) {
          T da[4] = {T(0), T(0), T(0), T(0)}, db[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
          for (int q = 0; q < kNB; ++q) {  // four short chains per row, not one long one
            da[q % 4] = dev_fma(xa[q], y[q], da[q % 4]);
            db[q % 4] = dev_fma(xb[q], y[q], db[q % 4]);
          }
          if (k + 1 < k1) {
#pragma unroll
            for (int q = 0; q < kNB; ++q) y[q] = p[cs(q) + k + 1];
          }
          const int ck = col_start(k, n) - k;
          if (k <= ia && ia < n) p[ck + ia] -= (da[0] + da[1]) + (da[2] + da[3]);
          if (k <= ib && ib < n) p[ck + ib] -= (db[0] + db[1]) + (db[2] + db[3]);
        }
      }
    }
    __syncthreads();
  }

  // the factor out, a warp per row: upper triangle zero, all NaN on a bad pivot
  for (int i = warp; i < n; i += kWarps) {
    for (int k = lane; k < n; k += 32) {
      T v = T(0);
      if (bad) {
        v = dev_nan(v);
      } else if (k <= i) {
        v = p[col_start(k, n) + i - k];
      }
      out_mat[i * n + k] = v;
    }
  }
}

template <typename T>
int launch(const void* a, void* out, int batch, int n, cudaStream_t stream) {
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
// float, 1 double.  The caller checks that the packed triangle fits the
// block's shared memory.  batch >= 1 and n >= 1.
int mogp_cholesky_batched(const void* a, void* out, int batch, int n,
                          int is_double, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(a, out, batch, n, s);
  return launch<float>(a, out, batch, n, s);
}

}  // extern "C"
