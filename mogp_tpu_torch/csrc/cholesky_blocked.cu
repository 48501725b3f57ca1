// Blocked batched lower Cholesky factorization for matrices too large for
// one block's shared memory (K3, K4, K5):
//
//     out[b] = L,  L L^T = A[b],  L lower triangular, upper triangle zero,
//
// for A (B, n, n) and out (B, n, n), contiguous, one floating type.  Only
// the lower triangle of A is read.  A matrix with a pivot that is not
// positive and finite comes out all NaN, upper triangle included; the
// other matrices of the batch are untouched (the contract of K2,
// cholesky_batched.cu).
//
// Replaces the three blocked experiments of tools/exp_chol.py, which
// advance a VMEM-resident chunk of matrices through a right-looking
// factorization in 128-column panels, with the trailing Schur complement
// updated on the MXU:
//
// * variant 1, K3 (chol_blocked, :111): the panel is factored column by
//   column with rank-1 steps;
// * variant 2, K4 (chol_blocked_v2, :269): the panel is factored in
//   rank-8 micro-panels, each applied to the rest of the panel with one
//   rank-8 update;
// * variant 3, K5 (chol_blocked_v3, :411): 16-column micro-panels whose
//   16 x 16 diagonal tile is factored and then inverted by Newton
//   iteration, X <- X (2I - L X), 4 steps, so that the panel rows come
//   from the product X M and all O(n^3) work is products.
//
// On an H100 one block cannot hold a matrix of this size, so each panel is
// three launches over the batch, and the panel loop runs on the host
// (n / 128 panels):
//
// 1. diag (one block per matrix): the 128 x 128 diagonal block, in shared
//    memory, factored by the variant's micro-panel scheme (micro-panel
//    width MB = 1, 8 or 16).  A bad pivot sets the matrix's status word.
// 2. rows (blocks of 32 rows x matrices): L21 = A21 L11^-T, the rows below
//    the diagonal block, with the same micro-panels: each block holds L11
//    and its 32 rows in shared memory; a warp owns each row, solves its MB
//    columns (substitution, or the product with the stored inverse tile for
//    variant 3) and applies them to the rest of the row with one rank-MB
//    update.  Rows do not depend on each other: no block barrier.
// 3. update (128 x 128 lower tiles x matrices, flattened into blockIdx.x):
//    A22 -= L21 L21^T, shared by the variants.  Only tiles on or below the
//    diagonal; within a diagonal tile only the lower triangle is written.
//
// What bounds it: the update carries almost all of the n^3 / 3 flops and
// is a product with a depth of 128, so IEEE FP32 / FP64 FMA throughput
// bounds it; each thread accumulates an 8 x 8 tile in registers from 16 x
// 128 slices in shared memory (16 FMAs per 16-byte shared load).  No TF32 and no
// tensor cores: ten-bit mantissas destroy K's conditioning.  The diag
// step is one block per matrix and latency-bound on its barriers (three
// per micro-panel; the tile is factored by one warp in registers), which is
// where the variants differ: 384 barriers per panel for MB = 1, 48 for
// MB = 8, 24 for MB = 16.
//
// The NaN contract across launches: status[b] (int, zeroed by the caller)
// is set by the diag step to the 1-based column of the failing pivot (the
// `info` of cholesky_ex); every later launch skips a matrix whose status
// is set, and the last launch writes such a matrix all NaN.  No host sync.
// Offsets of a matrix are 64-bit (B n^2 passes 2^31 on batched ladders).
// A ragged last panel (n not a multiple of 128) is masked, never padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 (no
// fast-math).  C interface, loaded with ctypes by mogp_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

#include "chol_common.cuh"

namespace {

using mogp::dev_fma;
using mogp::dev_nan;
using mogp::dev_sqrt;
using mogp::good_pivot;

constexpr int kNB = 128;           // panel width
constexpr int kLD = kNB + 1;       // shared row stride: column walks hit distinct banks
constexpr int kRowTile = 32;       // rows of L21 per block of the rows step
constexpr int kDiagThreads = 512;  // the serial step: as many warps as help
constexpr int kPanelThreads = 256;
constexpr int kMaxMB = 16;         // widest micro-panel (variant 3)
constexpr int kTM = 8;             // update: each thread owns kTM x kTM outputs
constexpr int kBM = 16 * kTM;      // update tile, 128 x 128
constexpr int kKC = 16;            // update: depth of one shared-memory slice
constexpr int kUpdThreads = 256;
constexpr int kCopyThreads = 256;
constexpr int kCopyElems = 1 << 16;  // elements per block of the copy passes

__device__ __forceinline__ size_t mat_offset(int lane, int n) {
  return static_cast<size_t>(lane) * n * n;
}

// out = tril(A); upper triangle zero.  Grid: lanes x row chunks.
template <typename T>
__global__ void __launch_bounds__(kCopyThreads)
blk_init_kernel(const T* __restrict__ a, T* __restrict__ out, int n, int rows_per, int chunks) {
  const int lane = blockIdx.x / chunks;
  const int r0 = (blockIdx.x % chunks) * rows_per;
  const int r1 = min(n, r0 + rows_per);
  const size_t off = mat_offset(lane, n);
  for (int r = r0; r < r1; ++r) {
    const size_t row = off + static_cast<size_t>(r) * n;
    for (int c = threadIdx.x; c < n; c += kCopyThreads) out[row + c] = c <= r ? a[row + c] : T(0);
  }
}

// a matrix whose status is set becomes all NaN
template <typename T>
__global__ void __launch_bounds__(kCopyThreads)
blk_finish_kernel(T* __restrict__ out, const int* __restrict__ status, int n, int rows_per,
                  int chunks) {
  const int lane = blockIdx.x / chunks;
  if (status[lane] == 0) return;
  const int r0 = (blockIdx.x % chunks) * rows_per;
  const int r1 = min(n, r0 + rows_per);
  const size_t off = mat_offset(lane, n);
  for (int r = r0; r < r1; ++r) {
    const size_t row = off + static_cast<size_t>(r) * n;
    for (int c = threadIdx.x; c < n; c += kCopyThreads) out[row + c] = dev_nan(T(0));
  }
}

// Factor the mb x mb diagonal tile D (row stride kLD) in place with rank-1
// steps, by one warp: lane r holds row r in registers, and row c's entries
// arrive by shuffles.  The reciprocals of its diagonal go to dinv.  Sets
// *bad to the pivot's 1-based column in the tile and stops on a pivot that
// is not positive and finite; every lane reads the same pivot, so the warp
// exits together.
//
// INV (variant 3) then inverts the factored tile by Newton iteration from
// X0 = diag(1 / d): X <- X (2I - L X), in registers (lane r holds row r of
// X), into X (mb rows of kMaxMB).  The error I - L X is strictly lower
// triangular and squares each step, so ceil(log2 16) = 4 steps are exact
// in exact arithmetic (tools/exp_chol.py:313-327).
template <typename T, int MB, bool INV>
__device__ void factor_tile(T* D, T* dinv, T* X, int mb, int* bad) {
  const int l = threadIdx.x % 32;
  T a[MB];
#pragma unroll
  for (int k = 0; k < MB; ++k) a[k] = (l < mb && k <= l) ? D[l * kLD + k] : T(0);
#pragma unroll
  for (int k = 0; k < MB; ++k) {
    if (k >= mb) break;
    const T d = __shfl_sync(0xffffffffu, a[k], k);
    if (!good_pivot(d)) {
      if (l == 0) *bad = k + 1;
      return;
    }
    const T s = dev_sqrt(d);
    a[k] = l == k ? s : l > k ? a[k] / s : a[k];
#pragma unroll
    for (int c = k + 1; c < MB; ++c) {
      const T lck = __shfl_sync(0xffffffffu, a[k], c);  // L[c][k]
      if (l >= c) a[c] = dev_fma(-a[k], lck, a[c]);
    }
  }
  if (l < mb) {
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      if (k <= l) D[l * kLD + k] = a[k];
      if (k == l) dinv[k] = T(1) / a[k];
    }
  }
  if (INV) {
    T x[MB], p[MB];
#pragma unroll
    for (int c = 0; c < MB; ++c) x[c] = (c == l && l < mb) ? T(1) / a[c] : T(0);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
#pragma unroll
      for (int c = 0; c < MB; ++c) p[c] = T(0);
#pragma unroll
      for (int k = 0; k < MB; ++k) {  // P = L X, row l
#pragma unroll
        for (int c = 0; c < MB; ++c) {
          p[c] = dev_fma(a[k], __shfl_sync(0xffffffffu, x[c], k), p[c]);
        }
      }
      T q[MB];
#pragma unroll
      for (int c = 0; c < MB; ++c) q[c] = T(2) * x[c];
#pragma unroll
      for (int k = 0; k < MB; ++k) {  // X (2I - P), row l
#pragma unroll
        for (int c = 0; c < MB; ++c) {
          q[c] = dev_fma(-x[k], __shfl_sync(0xffffffffu, p[c], k), q[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < MB; ++c) x[c] = q[c];
    }
    if (l < mb) {
#pragma unroll
      for (int c = 0; c < MB; ++c) X[l * kMaxMB + c] = x[c];
    }
  }
}

// The rank-mb update of row R by the micro-panel (columns 0..mb of R and of
// the rows C(c) = C0 + c * kLD): R[mb + c] -= sum_k v[k] C(c)[k] for c in
// [0, cols) (cols <= 128), with v[k] = R[k] already in registers; one warp,
// each lane four columns at once (independent FMA chains).
template <typename T, int MB>
__device__ __forceinline__ void rank_update_row(T* R, const T* C0, const T (&v)[MB], int mb,
                                                int cols) {
  const int l = threadIdx.x % 32;
  T acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = l + 32 * q;
    acc[q] = c < cols ? R[mb + c] : T(0);
  }
#pragma unroll
  for (int k = 0; k < MB; ++k) {
    if (k < mb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = l + 32 * q;
        if (c < cols) acc[q] = dev_fma(-v[k], C0[c * kLD + k], acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = l + 32 * q;
    if (c < cols) R[mb + c] = acc[q];
  }
}

// One row's mb micro-panel entries R[0..mb), times L_D^-T, into v:
// forward substitution against the factored tile D with the reciprocals
// dinv of its diagonal (variants 1, 2), or the product with its inverse X
// (variant 3).
template <typename T, int MB, bool INV>
__device__ __forceinline__ void solve_vals(const T* R, const T* D, const T* dinv, const T* X,
                                           int mb, T (&v)[MB]) {
#pragma unroll
  for (int k = 0; k < MB; ++k) v[k] = k < mb ? R[k] : T(0);
  if (INV) {
#pragma unroll
    for (int k = MB - 1; k >= 0; --k) {
      if (k < mb) {
        T acc = T(0);
#pragma unroll
        for (int i = 0; i <= k; ++i) acc = dev_fma(X[k * kMaxMB + i], v[i], acc);
        v[k] = acc;  // v[i > k] are done, v[i <= k] still the inputs
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      if (k < mb) {
        T acc = v[k];
#pragma unroll
        for (int i = 0; i < k; ++i) acc = dev_fma(-v[i], D[k * kLD + i], acc);
        v[k] = acc * dinv[k];
      }
    }
  }
}

// Step 1: factor the diagonal block at (base, base), width w = min(128,
// n - base), one block per matrix.  Variant 3 also leaves the inverse of
// each 16 x 16 diagonal tile in inv (kNB x kMaxMB per matrix) for step 2.
template <typename T, int MB, bool INV>
__global__ void __launch_bounds__(kDiagThreads)
blk_diag_kernel(T* __restrict__ out, int* __restrict__ status, T* __restrict__ inv, int n,
                int base) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // kNB x kLD
  T* dinv = S + kNB * kLD;                // kNB reciprocals of the diagonal
  T* Xi = dinv + kNB;                     // INV: kNB x kMaxMB
  __shared__ int bad;
  const int lane = blockIdx.x;
  if (status[lane]) return;
  const int w = min(kNB, n - base);
  T* A = out + mat_offset(lane, n) + static_cast<size_t>(base) * n + base;
  const int t = threadIdx.x;
  // the upper triangle of the block is zero in out: load it all, so that
  // the loads do not wait on a data-dependent branch
#pragma unroll 8
  for (int e = t; e < kNB * kNB; e += kDiagThreads) {
    const int r = e / kNB, c = e % kNB;
    if (r < w && c < w) S[r * kLD + c] = A[static_cast<size_t>(r) * n + c];
  }
  if (t == 0) bad = 0;
  __syncthreads();

  for (int j0 = 0; j0 < w; j0 += MB) {
    const int mb = min(MB, w - j0);
    T* D = S + j0 * kLD + j0;
    if (t < 32) factor_tile<T, MB, INV>(D, dinv + j0, Xi + j0 * kMaxMB, mb, &bad);
    __syncthreads();
    if (bad) {  // read by every thread after the barrier: a uniform exit
      if (t == 0) status[lane] = base + j0 + bad;
      return;
    }
    const int below = w - j0 - mb;
    for (int r = t; r < below; r += kDiagThreads) {
      T* R = S + (j0 + mb + r) * kLD + j0;
      T v[MB];
      solve_vals<T, MB, INV>(R, D, dinv + j0, Xi + j0 * kMaxMB, mb, v);
#pragma unroll
      for (int k = 0; k < MB; ++k) {
        if (k < mb) R[k] = v[k];
      }
    }
    __syncthreads();
    // rank-mb update of the block's trailing lower triangle: a warp per row
    for (int r = t / 32; r < below; r += kDiagThreads / 32) {
      T* R = S + (j0 + mb + r) * kLD + j0;
      T v[MB];
#pragma unroll
      for (int k = 0; k < MB; ++k) v[k] = k < mb ? R[k] : T(0);
      rank_update_row<T, MB>(R, S + (j0 + mb) * kLD + j0, v, mb, r + 1);
    }
    __syncthreads();
  }

  for (int e = t; e < kNB * kNB; e += kDiagThreads) {
    const int r = e / kNB, c = e % kNB;
    if (c <= r && r < w) A[static_cast<size_t>(r) * n + c] = S[r * kLD + c];
  }
  if (INV) {
    T* I = inv + static_cast<size_t>(lane) * kNB * kMaxMB;
    for (int e = t; e < w * kMaxMB; e += kDiagThreads) I[e] = Xi[e];
  }
}

// Step 2: L21 = A21 L11^-T for the 32 rows of this block below a full
// diagonal block (rows exist below a panel only when it is 128 wide).
template <typename T, int MB, bool INV>
__global__ void __launch_bounds__(kPanelThreads)
blk_rows_kernel(T* __restrict__ out, const int* __restrict__ status,
                const T* __restrict__ inv, int n, int base, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);  // kNB x kLD, L11
  T* Xs = Ls + kNB * kLD;                  // kRowTile x kLD, this block's rows
  T* dinv = Xs + kRowTile * kLD;           // kNB reciprocals of L11's diagonal
  T* Xi = dinv + kNB;                      // INV: kNB x kMaxMB
  const int lane = blockIdx.x / tiles;
  if (status[lane]) return;
  const int r0 = base + kNB + (blockIdx.x % tiles) * kRowTile;
  const int rows = min(kRowTile, n - r0);
  T* M = out + mat_offset(lane, n);
  const int t = threadIdx.x;
#pragma unroll 8
  for (int e = t; e < kNB * kNB; e += kPanelThreads) {  // upper triangle zero in out
    const int r = e / kNB, c = e % kNB;
    Ls[r * kLD + c] = M[static_cast<size_t>(base + r) * n + base + c];
  }
#pragma unroll 4
  for (int e = t; e < kRowTile * kNB; e += kPanelThreads) {
    const int r = e / kNB, c = e % kNB;
    if (r < rows) Xs[r * kLD + c] = M[static_cast<size_t>(r0 + r) * n + base + c];
  }
  if (t < kNB) dinv[t] = T(1) / M[static_cast<size_t>(base + t) * n + base + t];
  if (INV) {
    const T* I = inv + static_cast<size_t>(lane) * kNB * kMaxMB;
    for (int e = t; e < kNB * kMaxMB; e += kPanelThreads) Xi[e] = I[e];
  }
  __syncthreads();

  // Rows are independent: a warp owns each of its rows for the whole loop,
  // every lane solving the row's micro-panel (the same values) and then
  // applying it to its own columns, so only the warp synchronizes.
  const int l = t % 32;
  for (int j0 = 0; j0 < kNB; j0 += MB) {
    for (int r = t / 32; r < rows; r += kPanelThreads / 32) {
      T* R = Xs + r * kLD + j0;
      T v[MB];
      solve_vals<T, MB, INV>(R, Ls + j0 * kLD + j0, dinv + j0, Xi + j0 * kMaxMB, MB, v);
      __syncwarp();  // every lane has read the row before lane k overwrites R[k]
#pragma unroll
      for (int k = 0; k < MB; ++k) {
        if (l == k) R[k] = v[k];
      }
      rank_update_row<T, MB>(R, Ls + (j0 + MB) * kLD + j0, v, MB, kNB - j0 - MB);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int e = t; e < rows * kNB; e += kPanelThreads) {
    const int r = e / kNB, c = e % kNB;
    M[static_cast<size_t>(r0 + r) * n + base + c] = Xs[r * kLD + c];
  }
}

// Four consecutive elements of shared memory (16-byte aligned for float;
// two 16-byte loads for double).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
}

// Step 3: A22 -= L21 L21^T over the lower 128 x 128 tile pairs (I >= J) of
// the trailing matrix, which starts at row and column base + 128.  Thread
// (ty, tx) of 16 x 16 owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3} of the
// tile, and the same columns with tx: per step of the depth it loads 4 x 4
// consecutive values from shared memory and does 64 FMAs.
// float: two blocks per SM (registers capped at 128) with the next slice
// prefetched into registers; double: one block, no prefetch (its 8 x 8
// accumulators alone take 128 registers)
template <typename T>
struct UpdateCfg {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;
  static constexpr bool kPrefetch = sizeof(T) == 4;
};

template <typename T>
__global__ void __launch_bounds__(kUpdThreads, UpdateCfg<T>::kMinBlocks)
blk_update_kernel(T* __restrict__ out, const int* __restrict__ status, int n, int base,
                  int pairs) {
  constexpr int kPad = kBM + 4;  // keeps each row of the slices 16-byte aligned
  constexpr int kLoads = kBM * kKC / kUpdThreads;
  __shared__ __align__(16) T As[kKC][kPad];
  __shared__ __align__(16) T Bs[kKC][kPad];
  const int lane = blockIdx.x / pairs;
  if (status[lane]) return;
  const int p = blockIdx.x % pairs;
  int I = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (I * (I + 1) / 2 > p) --I;
  while ((I + 1) * (I + 2) / 2 <= p) ++I;
  const int J = p - I * (I + 1) / 2;
  const int t0 = base + kNB;
  const int I0 = t0 + I * kBM, J0 = t0 + J * kBM;
  const T* M = out + mat_offset(lane, n);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // this thread's share of each slice: depth kk = tid % kKC, rows m
  const int kk_ld = tid % kKC, m_ld = tid / kKC;
  constexpr int kRowStep = kUpdThreads / kKC;

  T ra[kLoads], rb[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int m = m_ld + i * kRowStep;
      const int ri = I0 + m, rj = J0 + m;
      ra[i] = ri < n ? M[static_cast<size_t>(ri) * n + base + k0 + kk_ld] : T(0);
      rb[i] = rj < n ? M[static_cast<size_t>(rj) * n + base + k0 + kk_ld] : T(0);
    }
  };

  T acc[kTM][kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTM; ++j) acc[i][j] = T(0);
  }
  if (UpdateCfg<T>::kPrefetch) fetch(0);
  for (int k0 = 0; k0 < kNB; k0 += kKC) {
    if (!UpdateCfg<T>::kPrefetch) fetch(k0);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      As[kk_ld][m_ld + i * kRowStep] = ra[i];
      Bs[kk_ld][m_ld + i * kRowStep] = rb[i];
    }
    __syncthreads();
    if (UpdateCfg<T>::kPrefetch && k0 + kKC < kNB) fetch(k0 + kKC);
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      T a[kTM], b[kTM];
      load4(&As[kk][ty * 4], a);
      load4(&As[kk][64 + ty * 4], a + 4);
      load4(&Bs[kk][tx * 4], b);
      load4(&Bs[kk][64 + tx * 4], b + 4);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTM; ++j) acc[i][j] = dev_fma(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  T* Mw = out + mat_offset(lane, n);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = I0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int c = J0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c <= r) Mw[static_cast<size_t>(r) * n + c] -= acc[i][j];
    }
  }
}

bool grid_ok(long long blocks) { return blocks >= 1 && blocks <= 0x7fffffffLL; }

template <typename T, int MB, bool INV>
int run(const T* a, T* out, int* status, T* inv, int batch, int n, cudaStream_t s) {
  const size_t diag_smem =
      (static_cast<size_t>(kNB) * kLD + kNB + (INV ? kNB * kMaxMB : 0)) * sizeof(T);
  const size_t rows_smem =
      (static_cast<size_t>(kNB + kRowTile) * kLD + kNB + (INV ? kNB * kMaxMB : 0)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(blk_diag_kernel<T, MB, INV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(diag_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(blk_rows_kernel<T, MB, INV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(rows_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows_per = max(1, kCopyElems / n);
  const int chunks = (n + rows_per - 1) / rows_per;
  if (!grid_ok(static_cast<long long>(batch) * chunks)) return cudaErrorInvalidConfiguration;
  blk_init_kernel<T><<<batch * chunks, kCopyThreads, 0, s>>>(a, out, n, rows_per, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int base = 0; base < n; base += kNB) {
    blk_diag_kernel<T, MB, INV><<<batch, kDiagThreads, diag_smem, s>>>(out, status, inv, n,
                                                                        base);
    const int rest = n - base - kNB;
    if (rest > 0) {
      const int tiles = (rest + kRowTile - 1) / kRowTile;
      const int nt = (rest + kBM - 1) / kBM;
      const int pairs = nt * (nt + 1) / 2;
      if (!grid_ok(static_cast<long long>(batch) * tiles) ||
          !grid_ok(static_cast<long long>(batch) * pairs)) {
        return cudaErrorInvalidConfiguration;
      }
      blk_rows_kernel<T, MB, INV><<<batch * tiles, kPanelThreads, rows_smem, s>>>(
          out, status, inv, n, base, tiles);
      blk_update_kernel<T><<<batch * pairs, kUpdThreads, 0, s>>>(out, status, n, base, pairs);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blk_finish_kernel<T><<<batch * chunks, kCopyThreads, 0, s>>>(out, status, n, rows_per, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_variant(const void* a, void* out, void* status, void* inv, int batch, int n,
                int variant, cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  T* ot = static_cast<T*>(out);
  int* st = static_cast<int*>(status);
  T* it = static_cast<T*>(inv);
  switch (variant) {
    case 1: return run<T, 1, false>(at, ot, st, it, batch, n, s);
    case 2: return run<T, 8, false>(at, ot, st, it, batch, n, s);
    case 3: return run<T, 16, true>(at, ot, st, it, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The whole panel loop on `stream`; returns the first launch error (0 on
// success).  status: `batch` ints, zeroed by the caller; on return 0, or
// the 1-based column of the pivot that failed.  inv: variant 3
// only, batch x 128 x 16 elements of scratch (may be null otherwise).
// is_double: 0 float, 1 double.  variant: 1, 2 or 3.  batch >= 1, n >= 1.
int mogp_cholesky_blocked(const void* a, void* out, void* status, void* inv, int batch, int n,
                          int is_double, int variant, void* stream) {
  if (batch < 1 || n < 1 || (variant == 3 && inv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) return run_variant<double>(a, out, status, inv, batch, n, variant, s);
  return run_variant<float>(a, out, status, inv, batch, n, variant, s);
}

}  // extern "C"
