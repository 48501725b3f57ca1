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
// * variant 1, K3 (chol_blocked, :111): the panel, its diagonal block and
//   the rows below together, is factored column by column with rank-1
//   steps;
// * variant 2, K4 (chol_blocked_v2, :269): the panel is factored in
//   micro-panels (rank-8 on the TPU; 32 columns here, see below);
// * variant 3, K5 (chol_blocked_v3, :411): 16-column micro-panels whose
//   16 x 16 diagonal tile is factored and then inverted by Newton
//   iteration, X <- X (2I - L X), 4 steps, so that the micro-panel's rows
//   come from the product with X, the rest of the panel takes a rank-16
//   product, and all O(n^3) work is products.
//
// On an H100 one block cannot hold a matrix of this size, so each panel is
// a few launches over the batch, and the panel loop runs on the host (n /
// 128 panels):
//
// 1. diag: the 128 x 128 diagonal block, in shared memory, factored by the
//    variant's micro-panel scheme.  A bad pivot sets the matrix's status
//    word.
// 2. rows: L21 = A21 L11^-T, the rows below the diagonal block.  Variant 2
//    launches 1 and 2 apart (one block per matrix, then blocks of rows x
//    matrices); variants 1 and 3 as one launch over blocks of rows x
//    matrices, each block factoring the diagonal block again (below).
// 3. update (lower tiles x matrices, flattened into blockIdx.x): A22 -=
//    L21 L21^T, shared by the variants.  Only tiles on or below the
//    diagonal; within a diagonal tile only the lower triangle is written.
//
// What bounds it, and what the design does about each bound.  The n^3 / 3
// flops are almost all in the update (3): at n = 4096 they take 0.34 ms at
// the card's 67 TFLOP/s (FP32 FMA; FP64 DMMA); the bytes, 0.03 ms, do not
// bound it.  But the diag step (1) runs on one SM per matrix and is a chain
// of barriers and dependent pivots, so on one large matrix its latency,
// not the flops, was what the factorization waited on (54% of K4's time
// at n = 4096 before this design).  So, for variant 2 (K4):
//
// * Latency of the diag step: blk_diag32_kernel factors the block in
//   32-column micro-panels, 3 barriers each (12 per panel, not 48): one
//   warp factors the 32 x 32 diagonal tile in registers (factor_tile: lane
//   r holds row r; a pivot chain of one shuffle and one rsqrt per column,
//   the column update off it), a thread per row solves the rows below it in
//   registers, and all warps apply the rank-32 update of the block's
//   trailing triangle on tensor cores.  The block comes in by cp.async.
// * Serial dependence between panels: a look-ahead.  Update k is two
//   launches, first the next panel's column block (in 32 x 128 tiles, many
//   small blocks: it is on the critical path), then the rest (128 x 128);
//   diag(k+1) and rows(k+1) run on a second, higher-priority stream as soon
//   as the first launch is done, and overlap the rest of update k.  Events
//   keep the order; the call returns on the caller's stream with everything
//   done.
// * Flops of the update: tensor cores.  blk_update_kernel stages operand
//   tiles in a double-buffered shared ring with cp.async and accumulates A
//   B^T with warp-level mma.sync (both operands K-major, as L21 L21^T
//   gives): in float32 three TF32 passes, in float64 DMMA (IEEE FP64 FMA at
//   twice the FP64 pipe's rate).
// * The rows step (blk_rows32_kernel): micro-tile substitution, the
//   products between micro-tiles on the same tensor-core path, the 32 x 32
//   substitutions in registers.  No explicit inverse: at K's condition
//   (~1e7) an inverse of L11 is not backward-stable.
//
// Why 3xTF32 keeps FP32 accuracy.  One TF32 pass rounds each operand to 10
// mantissa bits (relative error 2^-11), which destroys K's conditioning
// (config.py: TF32 stays off).  Here each float32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round to nearest, ties
// away); hi + lo equals x to 2^-22 relative.  Products of TF32 values are
// exact in the FP32 accumulator, and hi*hi' + hi*lo' + lo*hi' misses only
// lo*lo', ~2^-22 of the product: the error of an FP32 FMA.  The small terms
// are accumulated first.  chip_smoke.py holds the result to the float64
// factor of the ill-conditioned n = 4096 K, within 2x the error of
// cholesky_ex in float32; tests/test_torch_tf32_split.py rehearses the same
// arithmetic on the CPU, where one TF32 pass fails that rule.
//
// Variant 1 (K3) runs steps 1 and 2 as one launch, blk_panel1_kernel, the
// JAX kernel's own structure: 128 rank-1 steps over all of the panel's rows.
// Its grid covers the rows below the diagonal block in tiles of kRT rows;
// each block stages the diagonal block's lower triangle and its own rows
// through shared memory into registers (lane = row group, warp = column
// group, both cyclic, so every warp keeps work as the sweep moves right) and
// factors the diagonal block again, by the same operations as every other
// block, so all copies agree.  Step k is one barrier: every thread reads
// L[:, k] from a double-buffered shared column and applies a_ic -= L_ik
// L_ck, the products of tools/exp_chol.py:69-75 (each factor a_.k r_k,
// r_k = rsqrt(d_k)); the warp that holds column k + 1 updates it first,
// takes its pivot by a shuffle, checks it, scales the column and writes it
// to the other buffer, so the other warps never wait on an rsqrt.  The
// diagonal block is written by the block that loaded last (a per-matrix
// counter in the zero upper triangle of out, cleared again), so that no
// block can read it factored.  128 barriers a panel, against 384 in a
// separate diag step with rank-1 micro-panels and then a rows step that
// walks each row through 128 dependent warp steps.  What bounds it: the
// chain of 128 steps, each the shared-memory reads of the column (a
// broadcast per column slot, one read per row slot), the FMAs, and one
// warp's pivot, scaling and store before the barrier.
//
// Variant 3 (K5) runs steps 1 and 2 as one launch too, blk_panel3_kernel,
// on variant 1's pattern (the grid over tiles of rows, cp.async staging,
// the diagonal block factored again by every block, the last loader writing
// it), with the JAX kernel's arithmetic: per 16-column micro-panel, (a) the
// 16 x 16 tile is factored with rank-1 steps (factor_tile) and inverted by
// 4 Newton steps; (b) the micro-panel's columns of every row below the tile
// are the product M X^T; (c) the panel's columns right of it take the
// rank-16 update V V^T.  (b) and (c) are spread over all warps in 16 x 16
// tiles on tensor cores (the update's arithmetic, above).  Warp 0 takes the
// tiles the chain needs, (b) and (c) for the next tile, and goes straight
// on to (a) for it while the other warps finish (b) and (c): one block-wide
// barrier a micro-panel.  What bounds it is that chain, one warp's: per
// tile 16 dependent pivots (~180 cycles each) and the Newton steps, whose
// 6 small products (the first step, from a diagonal X0, is two scalings)
// run in FFMA across the warp: with mma.sync, whose fragments go through
// shared memory between products, they took 1.6 times as long on an H100
// (PERF.md).  Only 16 x 16 tiles are inverted, as in the JAX kernel, never
// L11 (see the rows step above).  Variants 1 and 3 share variant 2's update
// and the look-ahead loop.
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

#include <cstdint>
#include <mutex>

#include "chol_common.cuh"

namespace {

using mogp::dev_fma;
using mogp::dev_nan;
using mogp::dev_rsqrt;
using mogp::good_pivot;
using mogp::load4;

constexpr int kNB = 128;           // panel width
constexpr int kLD = kNB + 1;       // v1 row stride: column walks hit distinct banks
constexpr int kLDS = kNB + 4;      // v2, v3 row stride: fragment rows g, columns t hit banks 4g + t
constexpr int kRowTile2 = 64;      // v2: rows of L21 per block of the rows step
constexpr int kMP = 32;            // v2: micro-panel width
constexpr int kPanelThreads = 256;
constexpr int kBM = 128;           // update tile, 128 x 128 (equal to the panel width)
constexpr int kFirstBM = 32;       // rows of the update's tiles in the next panel's column block
constexpr int kUpdThreads = 256;   // 8 warps, 2 x 4 over an update tile
constexpr int kCopyThreads = 256;
constexpr int kCopyElems = 1 << 16;  // elements per block of the copy passes

__device__ __forceinline__ size_t mat_offset(int lane, int n) {
  return static_cast<size_t>(lane) * n * n;
}

// ---------------------------------------------------------------------------
// Tensor-core products: acc += A B^T for A and B in shared memory, row-major
// with the depth contiguous (K-major).  TC<T> is one mma tile:
// float: m16n8k8 TF32 in three passes; double: m8n8k4 DMMA.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

template <typename T>
struct TC;

template <>
struct TC<float> {
  static constexpr int kM = 16, kN = 8, kK = 8, kC = 4;  // kC: accumulators per thread
  struct FragA {
    uint32_t hi[4], lo[4];
  };
  struct FragB {
    uint32_t hi[2], lo[2];
  };
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
  // A's fragment: rows g and g + 8, columns t and t + 4 of the tile at A
  static __device__ __forceinline__ void load_a(FragA& f, const float* A, int ld) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    split(A[g * ld + t], f.hi[0], f.lo[0]);
    split(A[(g + 8) * ld + t], f.hi[1], f.lo[1]);
    split(A[g * ld + t + 4], f.hi[2], f.lo[2]);
    split(A[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  }
  // B's fragment (B^T's columns are B's rows): row g, columns t and t + 4
  static __device__ __forceinline__ void load_b(FragB& f, const float* B, int ld) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    split(B[g * ld + t], f.hi[0], f.lo[0]);
    split(B[g * ld + t + 4], f.hi[1], f.lo[1]);
  }
  static __device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const FragA& a, const FragB& b) {
    mma1(c, a.lo, b.hi);  // the small terms first
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
  // row and column, within the tile, of this thread's accumulator i
  static __device__ __forceinline__ int row(int i) {
    return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
  }
  static __device__ __forceinline__ int col(int i) { return 2 * (threadIdx.x & 3) + (i & 1); }
};

template <>
struct TC<double> {
  static constexpr int kM = 8, kN = 8, kK = 4, kC = 2;
  struct FragA {
    double v;
  };
  struct FragB {
    double v;
  };
  static __device__ __forceinline__ void load_a(FragA& f, const double* A, int ld) {
    f.v = A[((threadIdx.x & 31) >> 2) * ld + (threadIdx.x & 3)];
  }
  static __device__ __forceinline__ void load_b(FragB& f, const double* B, int ld) {
    f.v = B[((threadIdx.x & 31) >> 2) * ld + (threadIdx.x & 3)];
  }
  static __device__ __forceinline__ void mma(double (&c)[2], const FragA& a, const FragB& b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                 : "+d"(c[0]), "+d"(c[1])
                 : "d"(a.v), "d"(b.v));
  }
  static __device__ __forceinline__ int row(int) { return (threadIdx.x & 31) >> 2; }
  static __device__ __forceinline__ int col(int i) { return 2 * (threadIdx.x & 3) + i; }
};

// One warp: acc += A B^T over depth K (a multiple of TC<T>::kK) for a tile
// of MI x NI mma tiles; A's rows (MI kM of them) and B's (NI kN) at row
// strides lda and ldb.
template <typename T, int MI, int NI>
__device__ __forceinline__ void warp_mma(T (&acc)[MI][NI][TC<T>::kC], const T* A, int lda,
                                         const T* B, int ldb, int K) {
  using M = TC<T>;
  for (int k = 0; k < K; k += M::kK) {
    typename M::FragB fb[NI];
#pragma unroll
    for (int j = 0; j < NI; ++j) M::load_b(fb[j], B + j * M::kN * ldb + k, ldb);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      typename M::FragA fa;
      M::load_a(fa, A + i * M::kM * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NI; ++j) M::mma(acc[i][j], fa, fb[j]);
    }
  }
}

template <typename T, int MI, int NI>
__device__ __forceinline__ void zero_acc(T (&acc)[MI][NI][TC<T>::kC]) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int e = 0; e < TC<T>::kC; ++e) acc[i][j][e] = T(0);
    }
  }
}

// C -= acc for a warp tile whose corner is C (row stride ldc), on the
// elements (r, c) of the tile with r < rows and c <= r + diag
template <typename T, int MI, int NI>
__device__ __forceinline__ void sub_acc(T* C, int ldc, const T (&acc)[MI][NI][TC<T>::kC],
                                        int rows, int diag) {
  using M = TC<T>;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int e = 0; e < M::kC; ++e) {
        const int r = i * M::kM + M::row(e), c = j * M::kN + M::col(e);
        if (r < rows && c <= r + diag) C[r * ldc + c] -= acc[i][j][e];
      }
    }
  }
}

// C = acc for a warp tile whose corner is C (row stride ldc)
template <typename T, int MI, int NI>
__device__ __forceinline__ void store_acc(T* C, int ldc, const T (&acc)[MI][NI][TC<T>::kC]) {
  using M = TC<T>;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int e = 0; e < M::kC; ++e) {
        C[(i * M::kM + M::row(e)) * ldc + j * M::kN + M::col(e)] = acc[i][j][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared without registers; src_size 0 zero-fills
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copies src_bytes (0 to BYTES) and zero-fills the rest of the BYTES
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const int size = src_bytes;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(size)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(size)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x kNB elements of M (row stride n) into S (row stride kLDS) by
// cp.async, all in flight at once: 16 bytes a copy where M's rows are
// 16-byte aligned, else one element.  Elements outside valid_rows x kNB,
// and with LOWER those above the diagonal (zero in out), are zero-filled
// without being read.  The caller commits and waits.
template <typename T, int THREADS, bool LOWER>
__device__ __forceinline__ void stage_rows(T* S, const T* M, int n, int rows, int valid_rows) {
  constexpr int kE = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(M) % 16 == 0 && n % kE == 0;
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kNB / kE); e += THREADS) {
      const int r = e / (kNB / kE), c = e % (kNB / kE) * kE;
      int elems = r < valid_rows ? kE : 0;
      if (LOWER) elems = max(0, min(elems, r - c + 1));
      cp_async<16>(S + r * kLDS + c, elems ? M + static_cast<size_t>(r) * n + c : M,
                   elems * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = threadIdx.x; e < rows * kNB; e += THREADS) {
      const int r = e / kNB, c = e % kNB;
      const bool ok = r < valid_rows && (!LOWER || c <= r);
      cp_async<sizeof(T)>(S + r * kLDS + c, ok ? M + static_cast<size_t>(r) * n + c : M,
                          ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// Copy in and NaN out
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Micro-panel building blocks
// ---------------------------------------------------------------------------

// Factor the mb x mb diagonal tile D (row stride LD) in place with rank-1
// steps, by one warp: lane r holds row r in registers.  The pivots are a
// serial chain, so step k keeps the chain short: r = 1/sqrt(d) by rsqrt,
// column k scaled by r, and the next pivot d formed on lane k + 1 from its
// own row and shuffled out.  The other columns are updated off the chain:
// column k goes to the warp's 32-element scratch col and every lane reads
// it back in 16-byte broadcasts.  The update is not masked: the entries of
// a lane above its diagonal are never read back.  The reciprocals of the
// diagonal go to dinv.  On a pivot that is not positive and finite it sets
// *bad to the pivot's 1-based column in the tile and returns false; every
// lane reads the same pivot, so the warp returns together.
template <typename T, int MB, int LD>
__device__ __forceinline__ bool factor_tile(T* D, T* dinv, T* col, int mb, int* bad) {
  const int l = threadIdx.x % 32;
  T a[MB];
  T inv_d = T(0);  // lane l: 1 / L[l][l]
#pragma unroll
  for (int k = 0; k < MB; ++k) a[k] = (l < mb && k <= l) ? D[l * LD + k] : T(0);
  T d = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll
  for (int k = 0; k < MB; ++k) {
    if (k >= mb) break;
    if (!good_pivot(d)) {
      if (l == 0) *bad = k + 1;
      return false;
    }
    const T r = dev_rsqrt(d);
    if (l == k) inv_d = r;
    a[k] = l == k ? d * r : l > k ? a[k] * r : a[k];
    if (k + 1 < MB) {  // lane k + 1's next pivot: the FMA the update below gives it
      d = __shfl_sync(0xffffffffu, dev_fma(-a[k], a[k], a[k + 1 < MB ? k + 1 : k]), k + 1);
    }
    col[l] = a[k];  // L[l][k] for l > k
    __syncwarp();
#pragma unroll
    for (int c4 = 0; c4 < MB; c4 += 4) {
      if (c4 + 3 <= k) continue;
      T v[4];
      load4(col + c4, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c4 + q;
        if (c > k && c < MB) a[c] = dev_fma(-a[k], v[q], a[c]);
      }
    }
    __syncwarp();  // col is read before the next step writes it
  }
  if (l < mb) {
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      if (k <= l) D[l * LD + k] = a[k];
    }
    dinv[l] = inv_d;
  }
  return true;
}

// Variant 2: R[0..32) <- R L_D^-T by one thread, in registers: forward
// substitution against the factored 32 x 32 tile D (row stride kLDS), column
// by column, so that the 31 - k updates of step k are independent FMAs.
// Every thread of a warp reads the same D entry: broadcasts.
template <typename T>
__device__ __forceinline__ void subst_row32(T* R, const T* D, const T* dinv) {
  T v[kMP];
#pragma unroll
  for (int k = 0; k < kMP; ++k) v[k] = R[k];
#pragma unroll
  for (int k = 0; k < kMP; ++k) {
    v[k] *= dinv[k];
#pragma unroll
    for (int c = k + 1; c < kMP; ++c) v[c] = dev_fma(-v[k], D[c * kLDS + k], v[c]);
  }
#pragma unroll
  for (int k = 0; k < kMP; ++k) R[k] = v[k];
}

// ---------------------------------------------------------------------------
// Variant 2, step 1: the diagonal block
// ---------------------------------------------------------------------------

// The diagonal block in 32-column micro-panels, 3 barriers
// each: (a) warp 0 factors the 32 x 32 tile in registers; (b) a thread per
// row solves the rows of the block below it (up to 96); (c) all warps
// apply the rank-32 update of the block's trailing lower triangle on
// tensor cores, in 16 x 16 warp tiles.  Rows and columns past w are zero in
// shared memory and never written back.
// float: 512 threads; double: 256, so that the 32 doubles of a row of the
// tile stay in registers (255 a thread, against 128 at 512 threads)
template <typename T>
struct Diag32 {
  static constexpr int kThreads = sizeof(T) == 4 ? 512 : 256;
};

template <typename T>
__global__ void __launch_bounds__(Diag32<T>::kThreads)
blk_diag32_kernel(T* __restrict__ out, int* __restrict__ status, int n, int base) {
  using M = TC<T>;
  constexpr int kMI = 16 / M::kM, kNI = 16 / M::kN;
  constexpr int kThreads = Diag32<T>::kThreads;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // kNB x kLDS
  T* dinv = S + kNB * kLDS;               // kNB reciprocals of the diagonal
  __shared__ int bad;
  __shared__ __align__(16) T col[32];     // factor_tile's column scratch
  const int lane = blockIdx.x;
  if (status[lane]) return;
  const int w = min(kNB, n - base);
  T* A = out + mat_offset(lane, n) + static_cast<size_t>(base) * n + base;
  const int t = threadIdx.x;
  const int warp = t / 32;
  stage_rows<T, kThreads, true>(S, A, n, kNB, w);
  cp_async_commit();
  if (t == 0) bad = 0;
  cp_async_wait<0>();
  __syncthreads();

  for (int j0 = 0; j0 < w; j0 += kMP) {
    const int mb = min(kMP, w - j0);
    T* D = S + j0 * kLDS + j0;
    if (warp == 0) factor_tile<T, kMP, kLDS>(D, dinv + j0, col, mb, &bad);
    __syncthreads();
    if (bad) {  // read by every thread after the barrier: a uniform exit
      if (t == 0) status[lane] = base + j0 + bad;
      return;
    }
    const int below = w - j0 - mb;  // > 0 only when mb == 32
    if (below <= 0) break;
    for (int r = t; r < below; r += kThreads) {
      subst_row32<T>(S + (j0 + kMP + r) * kLDS + j0, D, dinv + j0);
    }
    __syncthreads();
    // C -= P P^T: C the trailing below x below block, P the rows just solved
    const T* P = S + (j0 + kMP) * kLDS + j0;
    T* C = S + (j0 + kMP) * kLDS + j0 + kMP;
    const int nt = (below + 15) / 16;
    for (int q = warp; q < nt * (nt + 1) / 2; q += kWarps) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= q) ++ti;
      const int tj = q - ti * (ti + 1) / 2;
      T acc[kMI][kNI][M::kC];
      zero_acc<T, kMI, kNI>(acc);
      warp_mma<T, kMI, kNI>(acc, P + ti * 16 * kLDS, kLDS, P + tj * 16 * kLDS, kLDS, kMP);
      sub_acc<T, kMI, kNI>(C + ti * 16 * kLDS + tj * 16, kLDS, acc, below - ti * 16,
                           (ti - tj) * 16);
    }
    __syncthreads();
  }

  for (int e = t; e < kNB * kNB; e += kThreads) {
    const int r = e / kNB, c = e % kNB;
    if (c <= r && r < w) A[static_cast<size_t>(r) * n + c] = S[r * kLDS + c];
  }
}

// ---------------------------------------------------------------------------
// Variant 2, step 2: the rows below the diagonal block
// ---------------------------------------------------------------------------

// L21 = A21 L11^-T for the 64 rows of this block, micro-panel by
// micro-panel: X[:, J] -= X[:, <J] L11[J, <J]^T on tensor cores (8 warps,
// 16 x 16 tiles of the 64 x 32 block), then X[:, J] <- X[:, J] L11[J, J]^-T
// by substitution, a thread per row.
template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
blk_rows32_kernel(T* __restrict__ out, const int* __restrict__ status, int n, int base,
                  int tiles) {
  using Mt = TC<T>;
  constexpr int kMI = 16 / Mt::kM, kNI = 16 / Mt::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);  // kNB x kLDS, L11
  T* Xs = Ls + kNB * kLDS;                 // kRowTile2 x kLDS, this block's rows
  T* dinv = Xs + kRowTile2 * kLDS;         // kNB reciprocals of L11's diagonal
  const int lane = blockIdx.x / tiles;
  if (status[lane]) return;
  const int r0 = base + kNB + (blockIdx.x % tiles) * kRowTile2;
  const int rows = min(kRowTile2, n - r0);
  T* M = out + mat_offset(lane, n);
  const int t = threadIdx.x;
  const int warp = t / 32;
  const T* L11 = M + static_cast<size_t>(base) * n + base;
  stage_rows<T, kPanelThreads, true>(Ls, L11, n, kNB, kNB);
  stage_rows<T, kPanelThreads, false>(Xs, M + static_cast<size_t>(r0) * n + base, n, kRowTile2,
                                      rows);
  cp_async_commit();
  if (t < kNB) dinv[t] = T(1) / L11[static_cast<size_t>(t) * n + t];
  cp_async_wait<0>();
  __syncthreads();

  const int tm = warp / 2, tn = warp % 2;  // this warp's 16 x 16 tile of the 64 x 32 block
  for (int j0 = 0; j0 < kNB; j0 += kMP) {
    if (j0 > 0) {
      T acc[kMI][kNI][Mt::kC];
      zero_acc<T, kMI, kNI>(acc);
      warp_mma<T, kMI, kNI>(acc, Xs + tm * 16 * kLDS, kLDS, Ls + (j0 + tn * 16) * kLDS, kLDS,
                            j0);
      sub_acc<T, kMI, kNI>(Xs + tm * 16 * kLDS + j0 + tn * 16, kLDS, acc, 16, 16);
      __syncthreads();
    }
    for (int r = t; r < rows; r += kPanelThreads) {
      subst_row32<T>(Xs + r * kLDS + j0, Ls + j0 * kLDS + j0, dinv + j0);
    }
    __syncthreads();
  }

  for (int e = t; e < rows * kNB; e += kPanelThreads) {
    const int r = e / kNB, c = e % kNB;
    M[static_cast<size_t>(r0 + r) * n + base + c] = Xs[r * kLDS + c];
  }
}

// ---------------------------------------------------------------------------
// Variant 1: steps 1 and 2 in one launch, rank-1 over the whole panel
// ---------------------------------------------------------------------------

// A block's panel: the 128 rows of the diagonal block and kRT rows below
// it, 128 columns.  Lane l holds the rows l + 32 m (m < kDS: the diagonal
// block, then this block's rows), warp wc the columns 32 q + 4 wc + f in
// slot j = 4 q + f: a column is written by one warp, every lane its own
// rows; a warp reads four of its columns' values in one 16-byte broadcast;
// and its column groups drop out as the sweep passes them, the warps never
// more than 4 columns apart.  kRT keeps the slots in registers: 6 x 16
// floats or 5 x 16 doubles a thread.
template <typename T>
struct Panel1 {
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRT = sizeof(T) == 4 ? 64 : 32;
  static constexpr int kRows = kNB + kRT;
  static constexpr int kRS = kRows / 32;     // row slots
  static constexpr int kDS = kNB / 32;       // of which in the diagonal block
  static constexpr int kCS = kNB / kWarps;   // column slots
  static constexpr size_t kSmem = static_cast<size_t>(kRows) * kLD * sizeof(T);  // the staging
};

// Column k of the panel, held by one warp in slot j of its registers (rows
// l + 32 m), becomes L[:, k]: r = rsqrt(d_k), d_k from the lane that holds
// row k (slot mk), every value times r, in the registers and in buf for the
// next step.  The first pivot that is not positive and finite sets *bad to
// its column k + 1; the sweep goes on (in NaNs) and the caller checks *bad
// once, at the end.  j and mk are constants after unrolling.
template <typename T, int RS, int CS>
__device__ __forceinline__ void publish_col(T (&a)[RS][CS], int j, int mk, int k, T* buf,
                                            int* bad) {
  const int l = threadIdx.x % 32;
  const T d = __shfl_sync(0xffffffffu, a[mk][j], k & 31);
  if (!good_pivot(d) && l == 0 && *bad == 0) *bad = k + 1;
  const T r = dev_rsqrt(d);
#pragma unroll
  for (int m = 0; m < RS; ++m) {
    a[m][j] *= r;
    buf[l + 32 * m] = a[m][j];
  }
}

// Rank-1 update of the column slot j of every row slot: a_ic -= u_i v_c,
// with u_i = L_ik for the rows and v_c = L_ck from the published column.
template <typename T, int RS, int CS>
__device__ __forceinline__ void rank1_slot(T (&a)[RS][CS], const T (&u)[RS], int j, T v) {
#pragma unroll
  for (int m = 0; m < RS; ++m) a[m][j] = dev_fma(-u[m], v, a[m][j]);
}

// Steps 1 and 2 of the panel at base for the kRT rows of tile blockIdx.x %
// tiles below it (none for the last panel): see the file header.  Slot
// (m, j) is the panel element (l + 32 m, 32 (j / 4) + 4 wc + j % 4).  The
// sweep updates every row at every step: the elements above the diagonal
// block's diagonal, and those past w or past n, are not the matrix's, start
// at zero, feed only each other and are never stored.  Step k reads L[:, k]
// from the column buffer; the warp that holds column k + 1 updates it
// first, then scales and publishes it (publish_col), so the other warps
// never wait on an rsqrt.  A bad pivot is acted on after the sweep: a
// failing matrix costs at most the rest of one panel, and the steps carry
// no exit test.
template <typename T>
__global__ void __launch_bounds__(Panel1<T>::kThreads, 1)
blk_panel1_kernel(T* __restrict__ out, int* __restrict__ status, int n, int base, int tiles) {
  using P = Panel1<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);        // kRows x kLD: the panel in and out
  __shared__ __align__(16) T col[2][P::kRows];  // L[:, k], by parity of k
  __shared__ int last, bad;
  const int lane = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  if (status[lane]) return;
  const int w = min(kNB, n - base);
  const int r0 = base + kNB + tile * P::kRT;  // first row of this block below the diagonal block
  const int rows = max(0, min(P::kRT, n - r0));
  T* M = out + mat_offset(lane, n);
  const int t = threadIdx.x, l = t % 32, wc = t / 32;

  // the panel into S by cp.async, one element a copy (S's rows are kLD
  // wide, so that the register slots read it without bank conflicts)
  for (int e = t; e < P::kRows * kNB; e += P::kThreads) {
    const int i = e / kNB, c = e % kNB;
    const bool ok = i < kNB ? i < w && c <= i : i - kNB < rows;
    const T* src = M + static_cast<size_t>(i < kNB ? base + i : r0 + i - kNB) * n + base + c;
    cp_async<sizeof(T)>(S + i * kLD + c, ok ? src : M, ok ? static_cast<int>(sizeof(T)) : 0);
  }
  cp_async_commit();
  if (t == 0) bad = 0;
  cp_async_wait<0>();
  __syncthreads();
  // The diagonal block goes back to out from the block that loaded last:
  // every other block has its copy by then.  The counter is the block's
  // top-right corner, zero in out (upper triangle); the last block clears it.
  if (t == 0) {
    int* counter = reinterpret_cast<int*>(M + static_cast<size_t>(base) * n + base + kNB - 1);
    if (tiles > 1) __threadfence();  // the block's loads before the count
    last = tiles == 1 || atomicAdd(counter, 1) == tiles - 1;
    if (last && tiles > 1) {
      __threadfence();
      *counter = 0;
    }
  }
  T a[P::kRS][P::kCS];
#pragma unroll
  for (int m = 0; m < P::kRS; ++m) {
#pragma unroll
    for (int j = 0; j < P::kCS; ++j) {
      a[m][j] = S[(l + 32 * m) * kLD + 32 * (j / 4) + 4 * wc + j % 4];
    }
  }
  if (wc == 0) publish_col(a, 0, 0, 0, col[0], &bad);
  __syncthreads();

  // step k = 32 q + 4 ow + e: column k is slot 4 q + e of warp ow, so every
  // slot index is a constant.  A warp's groups below q are done; group q is
  // live for wc > ow, and for wc == ow past e.
#pragma unroll
  for (int q = 0; q < kNB / 32; ++q) {
#pragma unroll 1
    for (int ow = 0; ow < P::kWarps; ++ow) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 32 * q + 4 * ow + e;
        if (k >= w) goto swept;
        const T* cur = col[k & 1];
        T* nxt = col[(k + 1) & 1];
        const bool more = k + 1 < w;
        T u[P::kRS], v[4];
#pragma unroll
        for (int m = 0; m < P::kRS; ++m) u[m] = cur[l + 32 * m];
        if (wc >= ow) {  // uniform in the warp
          load4(cur + 32 * q + 4 * wc, v);
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            if (f > e || wc > ow) rank1_slot(a, u, 4 * q + f, v[f]);
          }
        }
        // column k + 1 in group q: warp ow's next slot, or warp ow + 1's first
        if (more && wc == (e < 3 ? ow : ow + 1)) {
          publish_col(a, e < 3 ? 4 * q + e + 1 : 4 * q, q, k + 1, nxt, &bad);
        }
#pragma unroll
        for (int q2 = q + 1; q2 < kNB / 32; ++q2) {
          load4(cur + 32 * q2 + 4 * wc, v);
#pragma unroll
          for (int f = 0; f < 4; ++f) rank1_slot(a, u, 4 * q2 + f, v[f]);
          // column k + 1 opens group q + 1: warp 0's first slot
          if (q2 == q + 1 && e == 3 && ow == P::kWarps - 1 && wc == 0 && more) {
            publish_col(a, 4 * q2, q2, k + 1, nxt, &bad);
          }
        }
        __syncthreads();
      }
    }
  }
swept:
  if (bad) {  // read by every thread after the last barrier: a uniform exit
    if (last && t == 0) status[lane] = base + bad;
    return;
  }

  // through S for whole-row stores
#pragma unroll
  for (int m = 0; m < P::kRS; ++m) {
#pragma unroll
    for (int j = 0; j < P::kCS; ++j) {
      S[(l + 32 * m) * kLD + 32 * (j / 4) + 4 * wc + j % 4] = a[m][j];
    }
  }
  __syncthreads();
  for (int e = t; e < P::kRows * kNB; e += P::kThreads) {
    const int i = e / kNB, c = e % kNB;
    const bool ok = i < kNB ? last && i < w && c <= i : i - kNB < rows;
    if (ok) M[static_cast<size_t>(i < kNB ? base + i : r0 + i - kNB) * n + base + c] = S[i * kLD + c];
  }
}

// ---------------------------------------------------------------------------
// Variant 3: steps 1 and 2 in one launch, 16-column micro-panels through the
// Newton inverse of their diagonal tile, the products on tensor cores
// ---------------------------------------------------------------------------

// A block's panel, as variant 1's: the 128 rows of the diagonal block and
// kRT rows below it, in shared memory at row stride kLDS.  Eight warps; the
// micro-panel's 16 x 16 tiles of products are one warp each.
template <typename T>
struct Panel3 {
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRT = sizeof(T) == 4 ? 64 : 32;
  static constexpr int kRows = kNB + kRT;
  static constexpr int kMB = 16;   // micro-panel width
  static constexpr int kXLD = 20;  // row stride of X and E: (b)'s fragments of X hit distinct banks
  static constexpr size_t kSmem = static_cast<size_t>(kRows) * kLDS * sizeof(T);  // the staging
};

// One warp: X = L^-1 for the factored 16 x 16 tile D (row stride kLDS; its
// mb x mb lower triangle, the rest taken as zero) by 4 Newton steps X <- X
// (2I - L X) from X0 = diag(dinv), the iteration of tools/exp_chol.py:313-327.
// The error I - L X is strictly lower triangular and squares each step, so
// ceil(log2 16) = 4 steps are exact in exact arithmetic; X stays lower
// triangular (its zeros are exact).  Step 1 is two scalings, X0 being
// diagonal; steps 2-4 are two 16 x 16 x 16 products each, in FMA: lane l
// holds row r = l % 16 of L in registers and forms columns 8h..8h+8 (h = l /
// 16) of row r of each product, reading the other factor's rows from
// shared memory in broadcasts.  E = 2I - L X goes through the scratch E
// (16 x kXLD); X comes out in Xs (16 x kXLD).
template <typename T>
__device__ __forceinline__ void newton_inverse(const T* D, const T* dinv, T* E, T* Xs, int mb) {
  constexpr int kLd = Panel3<T>::kXLD;
  const int l = threadIdx.x % 32, r = l % 16, h = l / 16;
  T* Xr = Xs + r * kLd + 8 * h;  // this lane's part of X and E
  T* Er = E + r * kLd + 8 * h;
  __syncwarp();  // the factored tile and dinv, written by other lanes
  T Lr[16], x[8];
#pragma unroll
  for (int k = 0; k < 16; ++k) Lr[k] = r < mb && k <= r ? D[r * kLDS + k] : T(0);
  const T dr = r < mb ? dinv[r] : T(0);
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // step 1: X1 = X0 (2I - L X0)
    const int j = 8 * h + c;
    const T dj = j < mb ? dinv[j] : T(0);
    x[c] = dr * ((r == j ? T(2) : T(0)) - (h ? Lr[8 + c] : Lr[c]) * dj);
    Xr[c] = x[c];
  }
  __syncwarp();
#pragma unroll 1
  for (int it = 1; it < 4; ++it) {
    T p[8], v[2][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) p[c] = T(0);
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // L X
      load4(Xs + k * kLd + 8 * h, v[0]);
      load4(Xs + k * kLd + 8 * h + 4, v[1]);
#pragma unroll
      for (int c = 0; c < 8; ++c) p[c] = dev_fma(Lr[k], v[c / 4][c % 4], p[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) Er[c] = (r == 8 * h + c ? T(2) : T(0)) - p[c];
    __syncwarp();
    T xr[4][4];  // row r of X
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(Xs + r * kLd + 4 * q, xr[q]);
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] = T(0);
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // X (2I - L X)
      load4(E + k * kLd + 8 * h, v[0]);
      load4(E + k * kLd + 8 * h + 4, v[1]);
#pragma unroll
      for (int c = 0; c < 8; ++c) x[c] = dev_fma(xr[k / 4][k % 4], v[c / 4][c % 4], x[c]);
    }
    __syncwarp();  // every lane has read X and E
#pragma unroll
    for (int c = 0; c < 8; ++c) Xr[c] = x[c];
    __syncwarp();
  }
}

// Steps 1 and 2 of the panel at base for the kRT rows of tile blockIdx.x %
// tiles below it (none for the last panel): see the file header.  Rows of
// S: the diagonal block (its lower triangle; zero above it and past w),
// then this block's rows (zero past n).  Micro-panel j0 (columns j0..j0+16),
// with the inverse X of its tile already in Xb:
//
// (b) V = M[r, j0:j0+16] X^T, in place, for the 16-row tiles of the rows
//     below the tile: warp 0 the tile of the next micro-panel's rows, the
//     other warps the rest;
// (c) the rank-16 update M[r, j0+16:] -= V[r] V[c]^T of the columns right of
//     the micro-panel, in 16 x 16 tiles (the lower ones in the diagonal
//     block): warp 0 the next micro-panel's diagonal tile, which it then
//     factors (factor_tile) and inverts (newton_inverse) into the other X
//     buffer; the other warps, once every row of V is in (a named barrier
//     that warp 0 only arrives at), the rest.
//
// So warp 0 runs the chain of tiles without waiting on the other warps'
// products, and a micro-panel has one block-wide barrier.  Every block runs
// the same operations on the diagonal block in the same order, so all
// copies agree, and the block that loaded last writes it.  A bad pivot
// stops the block after the barrier that follows it.
template <typename T>
__global__ void __launch_bounds__(Panel3<T>::kThreads, 1)
blk_panel3_kernel(T* __restrict__ out, int* __restrict__ status, int n, int base, int tiles) {
  using P = Panel3<T>;
  using Mt = TC<T>;
  constexpr int kMI = 16 / Mt::kM, kNI = 16 / Mt::kN;
  constexpr int kE = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);           // kRows x kLDS: the panel in and out
  __shared__ __align__(16) T Xb[2][16 * P::kXLD];  // X of the micro-panels of even and odd index
  __shared__ __align__(16) T E[16 * P::kXLD];      // newton_inverse's scratch
  __shared__ __align__(16) T col[32];              // factor_tile's column scratch
  __shared__ T dinv[P::kMB];
  __shared__ int last, bad;
  const int lane = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  if (status[lane]) return;
  const int w = min(kNB, n - base);
  const int r0 = base + kNB + tile * P::kRT;  // first row of this block below the diagonal block
  const int rows = max(0, min(P::kRT, n - r0));
  T* M = out + mat_offset(lane, n);
  const int t = threadIdx.x, warp = t / 32;
  stage_rows<T, P::kThreads, true>(S, M + static_cast<size_t>(base) * n + base, n, kNB, w);
  if (rows > 0) {
    stage_rows<T, P::kThreads, false>(S + kNB * kLDS, M + static_cast<size_t>(r0) * n + base, n,
                                      P::kRT, rows);
  }
  cp_async_commit();
  if (t == 0) bad = 0;
  cp_async_wait<0>();
  __syncthreads();
  // The diagonal block goes back to out from the block that loaded last:
  // every other block has its copy by then.  The counter is the block's
  // top-right corner, zero in out (upper triangle); the last block clears it.
  if (t == 0) {
    int* counter = reinterpret_cast<int*>(M + static_cast<size_t>(base) * n + base + kNB - 1);
    if (tiles > 1) __threadfence();  // the block's loads before the count
    last = tiles == 1 || atomicAdd(counter, 1) == tiles - 1;
    if (last && tiles > 1) {
      __threadfence();
      *counter = 0;
    }
  }
  if (warp == 0 && factor_tile<T, P::kMB, kLDS>(S, dinv, col, min(P::kMB, w), &bad)) {
    newton_inverse<T>(S, dinv, E, Xb[0], min(P::kMB, w));
  }
  __syncthreads();

  const int rtiles = (rows + 15) / 16;  // 16-row tiles of this block's rows
  for (int j0 = 0;; j0 += P::kMB) {
    if (bad) {  // the tile at j0 failed; read by every thread after a barrier
      if (last && t == 0) status[lane] = base + j0 + bad;
      return;
    }
    const int c0 = j0 + P::kMB;                 // the next micro-panel
    const int nd = max(0, (w - c0 + 15) / 16);  // 16-row tiles of the diagonal block below the tile
    const T* X = Xb[(j0 / P::kMB) & 1];
    const T* V = S + j0;                        // the micro-panel's columns
    if (warp == 0) {
      if (nd > 0) {  // (b) for rows c0..c0+16
        T* R = S + c0 * kLDS + j0;
        T acc[kMI][kNI][Mt::kC];
        zero_acc<T, kMI, kNI>(acc);
        warp_mma<T, kMI, kNI>(acc, R, kLDS, X, P::kXLD, P::kMB);
        __syncwarp();  // the tile is read before it is overwritten
        store_acc<T, kMI, kNI>(R, kLDS, acc);
        __syncwarp();
      }
      asm volatile("bar.arrive 1, %0;" ::"n"(P::kThreads) : "memory");
      if (c0 < w) {  // (c) for the next tile, then its factorization and inverse
        T* D = S + c0 * kLDS + c0;
        T acc[kMI][kNI][Mt::kC];
        zero_acc<T, kMI, kNI>(acc);
        warp_mma<T, kMI, kNI>(acc, V + c0 * kLDS, kLDS, V + c0 * kLDS, kLDS, P::kMB);
        sub_acc<T, kMI, kNI>(D, kLDS, acc, 16, 0);
        __syncwarp();
        const int mb = min(P::kMB, w - c0);
        if (factor_tile<T, P::kMB, kLDS>(D, dinv, col, mb, &bad)) {
          newton_inverse<T>(D, dinv, E, Xb[(j0 / P::kMB + 1) & 1], mb);
        }
      }
    } else {
      // (b): row tiles q < nd of the diagonal block (the first is warp 0's),
      // then this block's
      for (int q = (nd > 0) + warp - 1; q < nd + rtiles; q += P::kWarps - 1) {
        T* R = S + (q < nd ? c0 + 16 * q : kNB + 16 * (q - nd)) * kLDS + j0;
        T acc[kMI][kNI][Mt::kC];
        zero_acc<T, kMI, kNI>(acc);
        warp_mma<T, kMI, kNI>(acc, R, kLDS, X, P::kXLD, P::kMB);
        __syncwarp();
        store_acc<T, kMI, kNI>(R, kLDS, acc);
      }
      asm volatile("bar.sync 1, %0;" ::"n"(P::kThreads) : "memory");
      // (c): the tiles (ti, tj) of the diagonal block's trailing lower
      // triangle but (0, 0), row tiles ti < nd, then those of this block's
      // rows, ti >= nd
      const int ntri = nd * (nd + 1) / 2;
      for (int q = warp - 1; c0 < w && q < ntri - 1 + rtiles * nd; q += P::kWarps - 1) {
        int ti = 0, tj;
        if (q < ntri - 1) {
          const int p = q + 1;
          while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
          tj = p - ti * (ti + 1) / 2;
        } else {
          ti = nd + (q - ntri + 1) / nd;
          tj = (q - ntri + 1) % nd;
        }
        const int r = ti < nd ? c0 + 16 * ti : kNB + 16 * (ti - nd);
        T acc[kMI][kNI][Mt::kC];
        zero_acc<T, kMI, kNI>(acc);
        warp_mma<T, kMI, kNI>(acc, V + r * kLDS, kLDS, V + (c0 + 16 * tj) * kLDS, kLDS, P::kMB);
        sub_acc<T, kMI, kNI>(S + r * kLDS + c0 + 16 * tj, kLDS, acc, 16,
                             ti < nd ? 16 * (ti - tj) : 16);
      }
    }
    __syncthreads();
    if (c0 >= w) break;
  }

  // this block's rows, and the diagonal block's lower triangle from the
  // last loader: 16 bytes a store where out's rows are 16-byte aligned
  const bool vec = reinterpret_cast<uintptr_t>(M) % 16 == 0 && n % kE == 0;
  for (int e = t; e < P::kRows * (kNB / kE); e += P::kThreads) {
    const int i = e / (kNB / kE), c = e % (kNB / kE) * kE;
    if (i < kNB ? !(last && i < w && c <= i) : i - kNB >= rows) continue;
    T* dst = M + static_cast<size_t>(i < kNB ? base + i : r0 + i - kNB) * n + base + c;
    const T* src = S + i * kLDS + c;
    if (vec && (i >= kNB || c + kE - 1 <= i)) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int q = 0; q < kE; ++q) {
        if (i >= kNB || c + q <= i) dst[q] = src[q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Step 3: the trailing update on tensor cores
// ---------------------------------------------------------------------------

// float: a 32-deep stage (4 per panel); double: 16 deep (8 per panel).  The
// stage row stride is 4 past the depth: fragment loads hit distinct banks.
// BM rows of L21 against 128: BM = 128 for the bulk of the update, two
// blocks per SM in float and one in double (its 64 accumulators take 128
// registers); BM = 32 for the first column block, which is on the panel
// loop's critical path: four times the blocks, each a quarter of the work.
template <typename T, int BM>
struct UpdCfg {
  static constexpr int kKC = sizeof(T) == 4 ? 32 : 16;
  static constexpr int kLd = kKC + 4;
  static constexpr int kWM = BM / 2;  // 2 x 4 warps of kWM x 32
  static constexpr int kMI = kWM / TC<T>::kM;
  static constexpr int kNI = 32 / TC<T>::kN;
  static constexpr int kMinBlocks = sizeof(T) == 4 || BM < kBM ? 2 : 1;
  static constexpr int kStageA = BM * kLd;   // one stage of each operand
  static constexpr int kStageB = kBM * kLd;
  static constexpr size_t kSmem = 2 * (kStageA + kStageB) * sizeof(T);  // 2 stages
};

// Stage ROWS rows x kKC columns of the matrix M (rows row0.., columns k0..)
// into S (row stride kLd) with cp.async; rows past n are zero-filled.  VEC:
// 16-byte copies (rows 16-byte aligned, n a multiple of 16 / sizeof(T));
// otherwise one copy per element.
template <typename T, int ROWS, bool VEC>
__device__ __forceinline__ void upd_stage(T* S, const T* M, int n, int row0, int k0) {
  using C = UpdCfg<T, kBM>;
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kPerRow = C::kKC / kE;
  constexpr int kChunks = ROWS * kPerRow / kUpdThreads;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = threadIdx.x + i * kUpdThreads;
    const int r = ch / kPerRow, q = (ch % kPerRow) * kE;
    const bool ok = row0 + r < n;
    const T* src = ok ? M + static_cast<size_t>(row0 + r) * n + k0 + q : M;
    T* dst = S + r * C::kLd + q;
    if constexpr (VEC) {
      cp_async<16>(dst, src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        cp_async<sizeof(T)>(dst + e, ok ? src + e : M, ok ? static_cast<int>(sizeof(T)) : 0);
      }
    }
  }
}

// A22 -= L21 L21^T over the lower tile pairs (I >= J) of the trailing
// matrix, which starts at row and column base + 128; tiles are BM rows by
// 128 columns.  BM = kFirstBM: the tiles (I, 0), the next panel's column
// block; BM = 128: the tiles with J >= 1.  Eight warps of BM / 2 x 32;
// a warp tile above the diagonal only takes part in the staging, and a
// 128 x 128 diagonal tile stages one operand for both.
template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(kUpdThreads, UpdCfg<T, BM>::kMinBlocks)
blk_update_kernel(T* __restrict__ out, const int* __restrict__ status, int n, int base,
                  int tiles) {
  using C = UpdCfg<T, BM>;
  using Mt = TC<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [2][BM][kLd]
  T* Bs = As + 2 * C::kStageA;             // [2][kBM][kLd]
  const int lane = blockIdx.x / tiles;
  if (status[lane]) return;
  const int p = blockIdx.x % tiles;
  int I, J;
  if (BM == kFirstBM) {
    I = p;
    J = 0;
  } else {  // p-th lower pair of the trailing tiles without the first column block
    int i = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
    while (i * (i + 1) / 2 > p) --i;
    while ((i + 1) * (i + 2) / 2 <= p) ++i;
    I = i + 1;
    J = p - i * (i + 1) / 2 + 1;
  }
  const int t0 = base + kNB;
  const int I0 = t0 + I * BM, J0 = t0 + J * kBM;
  T* M = out + mat_offset(lane, n);
  const bool same = BM == kBM && I == J;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  const bool idle = J0 + wn * 32 > I0 + wm * C::kWM + C::kWM - 1;  // above the diagonal

  T acc[C::kMI][C::kNI][Mt::kC];
  zero_acc<T, C::kMI, C::kNI>(acc);
  constexpr int kStages = kNB / C::kKC;
  upd_stage<T, BM, VEC>(As, M, n, I0, base);
  if (!same) upd_stage<T, kBM, VEC>(Bs, M, n, J0, base);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    if (s + 1 < kStages) {
      const int nxt = (s + 1) & 1;
      upd_stage<T, BM, VEC>(As + nxt * C::kStageA, M, n, I0, base + (s + 1) * C::kKC);
      if (!same) {
        upd_stage<T, kBM, VEC>(Bs + nxt * C::kStageB, M, n, J0, base + (s + 1) * C::kKC);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* a = As + (s & 1) * C::kStageA;
    const T* b = same ? a : Bs + (s & 1) * C::kStageB;
    if (!idle) {
      warp_mma<T, C::kMI, C::kNI>(acc, a + wm * C::kWM * C::kLd, C::kLd, b + wn * 32 * C::kLd,
                                  C::kLd, C::kKC);
    }
    __syncthreads();
  }
  if (idle) return;
  // A22 -= acc: every load first, then every store (interleaved, each load
  // would wait for the store before it, which the compiler cannot prove apart)
#pragma unroll
  for (int i = 0; i < C::kMI; ++i) {
#pragma unroll
    for (int j = 0; j < C::kNI; ++j) {
#pragma unroll
      for (int e = 0; e < Mt::kC; ++e) {
        const int r = I0 + wm * C::kWM + i * Mt::kM + Mt::row(e);
        const int c = J0 + wn * 32 + j * Mt::kN + Mt::col(e);
        if (r < n && c <= r) acc[i][j][e] = M[static_cast<size_t>(r) * n + c] - acc[i][j][e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < C::kMI; ++i) {
#pragma unroll
    for (int j = 0; j < C::kNI; ++j) {
#pragma unroll
      for (int e = 0; e < Mt::kC; ++e) {
        const int r = I0 + wm * C::kWM + i * Mt::kM + Mt::row(e);
        const int c = J0 + wn * 32 + j * Mt::kN + Mt::col(e);
        if (r < n && c <= r) M[static_cast<size_t>(r) * n + c] = acc[i][j][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The panel loop with look-ahead
// ---------------------------------------------------------------------------

bool grid_ok(long long blocks) { return blocks >= 1 && blocks <= 0x7fffffffLL; }

// The side stream of the look-ahead and its two events, one set per device,
// made at first use and kept for the process.  The lock also keeps the
// enqueue of one factorization from interleaving with another's.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t ready = nullptr;  // main -> side: the next panel's column block is updated
  cudaEvent_t done = nullptr;   // side -> main: its diag and rows steps are done
};
constexpr int kMaxDevices = 64;
Side g_side[kMaxDevices];
std::mutex g_mutex;

cudaError_t side_of_current_device(Side** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Side& sd = g_side[dev];
  if (sd.stream == nullptr) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err != cudaSuccess) return err;
    cudaStream_t s = nullptr;
    err = cudaStreamCreateWithPriority(&s, cudaStreamNonBlocking, greatest);
    if (err != cudaSuccess) return err;
    err = cudaEventCreateWithFlags(&sd.ready, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    err = cudaEventCreateWithFlags(&sd.done, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    sd.stream = s;
  }
  *out = &sd;
  return cudaSuccess;
}

template <typename T, int V>
struct Steps {
  // variant 2's diag and rows steps
  static constexpr size_t kDiagSmem = (static_cast<size_t>(kNB) * kLDS + kNB) * sizeof(T);
  static constexpr size_t kRowsSmem =
      (static_cast<size_t>(kNB + kRowTile2) * kLDS + kNB) * sizeof(T);

  static cudaError_t prepare() {
    cudaError_t err = cudaSuccess;
    if constexpr (V == 1) {
      err = cudaFuncSetAttribute(blk_panel1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Panel1<T>::kSmem));
    } else if constexpr (V == 2) {
      err = cudaFuncSetAttribute(blk_diag32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kDiagSmem));
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(blk_rows32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kRowsSmem));
    } else {
      err = cudaFuncSetAttribute(blk_panel3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Panel3<T>::kSmem));
    }
    if (err != cudaSuccess) return err;
    using UpdateFn = void (*)(T*, const int*, int, int, int);
    const UpdateFn updates[4] = {blk_update_kernel<T, kBM, true>, blk_update_kernel<T, kBM, false>,
                                 blk_update_kernel<T, kFirstBM, true>,
                                 blk_update_kernel<T, kFirstBM, false>};
    const size_t smem[4] = {UpdCfg<T, kBM>::kSmem, UpdCfg<T, kBM>::kSmem,
                            UpdCfg<T, kFirstBM>::kSmem, UpdCfg<T, kFirstBM>::kSmem};
    for (int i = 0; i < 4; ++i) {
      err = cudaFuncSetAttribute(updates[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem[i]));
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }

  // steps 1 and 2 of the panel at base, on stream s
  static cudaError_t panel(T* out, int* status, int batch, int n, int base, cudaStream_t s) {
    const int rest = n - base - kNB;
    if constexpr (V == 2) {
      const int tiles = rest > 0 ? (rest + kRowTile2 - 1) / kRowTile2 : 0;
      if (tiles > 0 && !grid_ok(static_cast<long long>(batch) * tiles)) {
        return cudaErrorInvalidConfiguration;
      }
      blk_diag32_kernel<T><<<batch, Diag32<T>::kThreads, kDiagSmem, s>>>(out, status, n, base);
      if (tiles > 0) {
        blk_rows32_kernel<T><<<batch * tiles, kPanelThreads, kRowsSmem, s>>>(out, status, n,
                                                                              base, tiles);
      }
    } else {  // one launch; the last panel is one block per matrix
      constexpr int kRT = V == 1 ? Panel1<T>::kRT : Panel3<T>::kRT;
      const int tiles = rest > 0 ? (rest + kRT - 1) / kRT : 1;
      if (!grid_ok(static_cast<long long>(batch) * tiles)) return cudaErrorInvalidConfiguration;
      if constexpr (V == 1) {
        blk_panel1_kernel<T><<<batch * tiles, Panel1<T>::kThreads, Panel1<T>::kSmem, s>>>(
            out, status, n, base, tiles);
      } else {
        blk_panel3_kernel<T><<<batch * tiles, Panel3<T>::kThreads, Panel3<T>::kSmem, s>>>(
            out, status, n, base, tiles);
      }
    }
    return cudaGetLastError();
  }
};

// step 3 of the panel at base: the first column block (kFirstBM-row
// tiles), or the rest (128-row tiles)
template <typename T, int BM, bool VEC>
void launch_update(T* out, const int* status, int blocks, int n, int base, int tiles,
                   cudaStream_t s) {
  blk_update_kernel<T, BM, VEC><<<blocks, kUpdThreads, UpdCfg<T, BM>::kSmem, s>>>(
      out, status, n, base, tiles);
}

template <typename T>
cudaError_t update(T* out, const int* status, int batch, int n, int base, bool first,
                   cudaStream_t s) {
  const int rest = n - base - kNB;
  const int nt = (rest + kBM - 1) / kBM;
  const int tiles = first ? (rest + kFirstBM - 1) / kFirstBM : nt * (nt - 1) / 2;
  if (tiles == 0) return cudaSuccess;
  if (!grid_ok(static_cast<long long>(batch) * tiles)) return cudaErrorInvalidConfiguration;
  const int blocks = batch * tiles;
  // 16-byte copies need every row 16-byte aligned (out comes from the allocator)
  const bool vec = (static_cast<size_t>(n) * sizeof(T)) % 16 == 0;
  if (first) {
    if (vec) launch_update<T, kFirstBM, true>(out, status, blocks, n, base, tiles, s);
    else launch_update<T, kFirstBM, false>(out, status, blocks, n, base, tiles, s);
  } else {
    if (vec) launch_update<T, kBM, true>(out, status, blocks, n, base, tiles, s);
    else launch_update<T, kBM, false>(out, status, blocks, n, base, tiles, s);
  }
  return cudaGetLastError();
}

#define MOGP_TRY(expr)                              \
  do {                                              \
    const cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <typename T, int V>
int run(const T* a, T* out, int* status, int batch, int n, cudaStream_t s) {
  using St = Steps<T, V>;
  MOGP_TRY(St::prepare());
  const int rows_per = max(1, kCopyElems / n);
  const int chunks = (n + rows_per - 1) / rows_per;
  if (!grid_ok(static_cast<long long>(batch) * chunks)) return cudaErrorInvalidConfiguration;

  std::lock_guard<std::mutex> lock(g_mutex);
  Side* sd = nullptr;
  MOGP_TRY(side_of_current_device(&sd));
  blk_init_kernel<T><<<batch * chunks, kCopyThreads, 0, s>>>(a, out, n, rows_per, chunks);
  MOGP_TRY(cudaGetLastError());
  MOGP_TRY(St::panel(out, status, batch, n, 0, s));
  // Panel p has a successor only when it is full: its update's first launch
  // gives the next panel its column block, whose diag and rows steps then run
  // on the side stream while the rest of the update runs here.
  for (int base = 0; base + kNB < n; base += kNB) {
    MOGP_TRY(update<T>(out, status, batch, n, base, true, s));
    MOGP_TRY(cudaEventRecord(sd->ready, s));
    MOGP_TRY(cudaStreamWaitEvent(sd->stream, sd->ready, 0));
    MOGP_TRY(St::panel(out, status, batch, n, base + kNB, sd->stream));
    MOGP_TRY(cudaEventRecord(sd->done, sd->stream));
    MOGP_TRY(update<T>(out, status, batch, n, base, false, s));
    MOGP_TRY(cudaStreamWaitEvent(s, sd->done, 0));
  }
  blk_finish_kernel<T><<<batch * chunks, kCopyThreads, 0, s>>>(out, status, n, rows_per, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_variant(const void* a, void* out, void* status, int batch, int n, int variant,
                cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  T* ot = static_cast<T*>(out);
  int* st = static_cast<int*>(status);
  switch (variant) {
    case 1: return run<T, 1>(at, ot, st, batch, n, s);
    case 2: return run<T, 2>(at, ot, st, batch, n, s);
    case 3: return run<T, 3>(at, ot, st, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The whole panel loop, enqueued on `stream` (with a side stream of its own
// for the look-ahead, joined back before the last launch); returns the
// first launch error (0 on success).  status: `batch` ints, zeroed by the
// caller; on return 0, or the 1-based column of the pivot that failed.
// is_double: 0 float, 1 double.  variant: 1, 2 or 3.  batch >= 1, n >= 1.
int mogp_cholesky_blocked(const void* a, void* out, void* status, int batch, int n,
                          int is_double, int variant, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) return run_variant<double>(a, out, status, batch, n, variant, s);
  return run_variant<float>(a, out, status, batch, n, variant, s);
}

}  // extern "C"
