// The cross-covariance K* of Gaussian-process prediction, batched over output
// lanes, and the fused prediction that consumes it on chip.  One device
// function builds a tile of
//
//     K*[l, i, j] = sigma2[l] * k(r2),
//     r2 = sum_d exp_theta[l, d] * (x1[l, i, d] - x2[j, d])^2,
//
// in shared memory, with k(r2) = exp(-r2 / 2) (squared exponential) or
// (1 + sqrt(5 r2) + 5 r2 / 3) exp(-sqrt(5 r2)) (Matern 5/2, exactly 1 where
// r2 == 0).  Two kernels use it:
//
// * mogp_kernel_matrix (K1): writes K* (L, n, m) to device memory.  The
//   unfused prediction path (full covariance, the product form, n or M above
//   the fused kernel's bounds) and get_cov_matrix-style callers take it.
// * mogp_predict_fused: for every lane and query column j, with k = K*[:, j]
//   built in shared memory,
//
//       mu_j  = dmtest_j . beta + k . alpha
//       r     = dmtest_j - Kinv_dm^T k,   u = LA^-1 r
//       v     = Lk^-1 k
//       var_j = max(var_shift - |v|^2 + |u|^2, 0)
//
//   the formulas of mogp_tpu_torch/models/gp.py::_gp_predict_impl.  K* and v
//   never reach device memory.
//
// Replaces mogp_tpu/ops/pallas_kernels.py::pallas_kernel_matrix, which the
// JAX package vmaps over outputs and whose output XLA then feeds to a
// triangular solve and the reductions.
//
// What bounds them on an H100:
//
// * K1 writes L n m elements and does about 3 D + 20 operations for each.
//   Its byte bound is the write, but on an H100 at D = 14 the build alone
//   (about 50 instructions an element) takes twice as long as the stores
//   alone.  Its design: blocks of up to 112 training rows in float32 (n =
//   210 is 2 blocks of 105, not 13 of 16 and one of 2) by 128 queries, each
//   input scaled once per block, so that the queries are staged as few
//   times as 3 blocks an SM allow; two query columns a thread; the pass
//   over the dimensions stops at D rounded up to even; the epilogue stores
//   whole rows of the tile with 16-byte streaming stores (st.global.cs),
//   since nothing reads K* again soon.
// * The fused kernel does n (3 D + 2) + n^2 + 4 n + 2 n M + M^2 flops per
//   lane and query (the forward substitution n^2 dominates) and moves only
//   its inputs and two (L, m) outputs: it is bound by FP32 FFMA.  One block
//   takes one lane and 64 queries; the n x 64 tile stays in shared memory.
//   The substitution runs over panels of 16 rows with a look-ahead: while
//   warps 2-7 apply panel p to the rows below panel p + 1 (a register-tiled
//   FFMA product, 4 query columns a thread in float32, 2 in float64), warps
//   0-1 (one query column a thread) apply it to panel p + 1's own rows and
//   solve that panel's 16 x 16 diagonal block, a serial chain per column
//   that so runs beside the bulk; one barrier a panel.  The pivots'
//   reciprocals leave the chain.  The lane's factor is read from L2 one
//   16-column strip per panel by 16-byte cp.async (its rows padded to 16
//   bytes by the wrapper), three buffers deep, so strip p + 2 lands while p
//   and p + 1 are used.  There is no explicit inverse of Lk: at the jittered
//   long-lengthscale lanes K's condition is 1e7-1e8 and var is a difference
//   of nearly equal terms.
// * The mean-term stage (M > 0: k . alpha, r, the mean and |u|^2; a template
//   parameter taken from M > 0, so that M = 0 keeps its own code) adds 2 n M
//   + M^2 flops, 12% of the rest at n = 210, M = 15.  Read a scalar at a time
//   from device memory (Kinv_dm at stride M, dmtest, LA), with the M x M
//   substitution on 64 threads through global loads, it was bound by load
//   latency: on an H100 the kernel took 1.66 times as long as at M = 0 (1.81
//   against 1.09 ms at (64, 210, 4864, 14), float32).  Its design: the M + 1
//   vectors [alpha | Kinv_dm] go 16 at a time into the third strip buffer
//   (free until the substitution's first panel) by cp.async, element by
//   element and coalesced (Kinv_dm's rows are M contiguous elements), the
//   tile's design rows, beta and LA's packed lower triangle beside them in
//   the same group; the product runs on all 256
//   threads as a 4 x 4 register tile (16 FFMA to two 16-byte loads), each
//   thread over a quarter of the rows in two chains, the quarters reduced by
//   warp shuffles in a fixed order (the same with and without unc); the
//   substitution u = LA^-1 r runs in registers, one query column a thread,
//   reading shared memory only.  Then 1.31 ms against 1.06 at M = 0.
//
// The distance uses the direct-difference form: with D this small it costs
// the same as the matmul form |z1|^2 + |z2|^2 - 2 z1.z2 and has no
// cancellation; the max(r2, 0) of the TPU kernel is kept all the same.
// Ragged edges are masked here; nothing is padded on the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast-math: exp, sqrt and the division stay IEEE).
// C interface, loaded with ctypes by mogp_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDimChunk = 16;  // input dimensions staged per pass

constexpr int kSqExp = 0;
constexpr int kMat52 = 1;

// K1: query columns per block, and the most training rows per block (the
// tile and staging, 69 KB at 105 rows of float, leave room for 3 blocks an
// SM; 56 rows of double the same)
constexpr int kK1Cols = 128;
template <typename T>
constexpr int kK1MaxRows = sizeof(T) == 4 ? 112 : 56;

// the fused kernel: queries per block, rows per substitution panel; the
// mean-term stage's vectors per chunk, and the most mean terms (M_FUSED)
constexpr int kQ = 64;
constexpr int kPanel = 16;
constexpr int kVecs = 16;
constexpr int kMaxMean = 32;
static_assert(kVecs == kPanel, "a chunk of vectors fills one strip buffer");

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) { return fma(a, b, c); }

// 16 bytes from 16-byte-aligned shared memory into registers, and back
__device__ __forceinline__ void lds16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds16(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void sts16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void sts16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
// 16 bytes from shared memory to device memory, streaming (evict first)
__device__ __forceinline__ void stg16_cs(float* dst, const float* src) {
  __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ void stg16_cs(double* dst, const double* src) {
  __stcs(reinterpret_cast<double2*>(dst), *reinterpret_cast<const double2*>(src));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared by cp.async, of which src_bytes are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// one element global -> shared by cp.async, zero-filled where !valid
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(static_cast<int>(sizeof(T))), "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// elements of shared scratch build_tile needs for `rows` training rows
__host__ __device__ constexpr int stage_elems(int rows, int cols) {
  return rows * kDimChunk + cols * (kDimChunk + 1);
}

// build_tile's compute for one pass: kDims (even, <= kDimChunk) staged
// dimensions, the rest of the chunk being zero padding that is skipped
template <typename T, int Base, int kCols, int kDims>
__device__ __forceinline__ void build_rows(const T* x1s, const T* x2s, T s2, int rows, T* tile,
                                           int ld, bool first, bool last) {
  constexpr int kHalf = kCols / 2;
  constexpr int kGroups = kThreads / kHalf;
  constexpr int kLd2 = kDimChunk + 1;
  const int c = threadIdx.x % kHalf;
  T za[kDims], zb[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    za[d] = x2s[c * kLd2 + d];
    zb[d] = x2s[(c + kHalf) * kLd2 + d];
  }
  for (int r = threadIdx.x / kHalf; r < rows; r += kGroups) {
    T z1[kDimChunk];
#pragma unroll
    for (int d = 0; d < kDims; d += 16 / sizeof(T)) lds16(x1s + r * kDimChunk + d, z1 + d);
    T* out = tile + r * ld + c;
    T acca = first ? T(0) : out[0];
    T accb = first ? T(0) : out[kHalf];
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      const T da = z1[d] - za[d];
      const T db = z1[d] - zb[d];
      acca = dev_fma(da, da, acca);
      accb = dev_fma(db, db, accb);
    }
    if (last) {
      acca = s2 * kernel_of_r2<T, Base>(acca > T(0) ? acca : T(0));
      accb = s2 * kernel_of_r2<T, Base>(accb > T(0) ? accb : T(0));
    }
    out[0] = acca;
    out[kHalf] = accb;
  }
}

// ---------------------------------------------------------------------------
// The K* tile builder.  tile[r * ld + c] = sigma2 * k(r2) for training rows
// row0 + r (r < rows) and queries col0 + c (c < kCols) of one lane.  Each
// pass stages kDimChunk dimensions of the rows and of the queries, scaled by
// sqrt(exp_theta) once: thread t stages dimension t % kDimChunk only, so it
// scales by its own square root, with no barrier, and it issues its loads
// of the queries before those of the rows.  Zero-padded dimensions and
// queries at or beyond m stage as zeros and add exactly nothing to r2; such
// queries give finite values that no epilogue stores.  r2 accumulates over
// passes in the tile (in registers when D <= kDimChunk), over the pass's
// dimensions rounded up to even.  Thread t computes columns c = t % (kCols
// / 2) and c + kCols / 2, two independent chains, for rows t / (kCols / 2),
// + 2 kThreads / kCols, ...; a warp shares one row, so the staged row is a
// broadcast read for both.  Called by all threads after a barrier; ends
// with one.
// ---------------------------------------------------------------------------
template <typename T, int Base, int kCols>
__device__ void build_tile(const T* __restrict__ x1_lane, const T* __restrict__ x2,
                           const T* __restrict__ theta_lane, T s2, int row0, int rows,
                           int col0, int m, int D, T* tile, int ld, T* stage) {
  constexpr int kLoads = kCols * kDimChunk / kThreads;  // query values a thread stages
  constexpr int kLd2 = kDimChunk + 1;
  static_assert(kThreads % (kCols / 2) == 0 && (kCols / 2) % 32 == 0,
                "a warp shares one row");
  static_assert(kThreads % kDimChunk == 0 && kLoads * kThreads == kCols * kDimChunk,
                "a thread stages one dimension");
  T* x1s = stage;                        // [rows][kDimChunk]
  T* x2s = stage + rows * kDimChunk;     // [kCols][kDimChunk + 1]
  const int t = threadIdx.x;
  const int dd = t % kDimChunk;
  const int passes = D > kDimChunk ? (D + kDimChunk - 1) / kDimChunk : 1;
  for (int p = 0; p < passes; ++p) {
    const int d0 = p * kDimChunk;
    const int dc = min(kDimChunk, D - d0);
    T q[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int j = col0 + (t + i * kThreads) / kDimChunk;
      q[i] = (j < m && dd < dc) ? x2[static_cast<size_t>(j) * D + d0 + dd] : T(0);
    }
    const T sc = dd < dc ? dev_sqrt(theta_lane[d0 + dd]) : T(0);
    for (int k = t; k < rows * kDimChunk; k += kThreads) {
      const int r = k / kDimChunk;
      x1s[k] = dd < dc ? x1_lane[static_cast<size_t>(row0 + r) * D + d0 + dd] * sc : T(0);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) x2s[(t + i * kThreads) / kDimChunk * kLd2 + dd] = q[i] * sc;
    __syncthreads();
    const bool first = p == 0, last = p == passes - 1;
    switch ((dc + 1) / 2) {
#define MOGP_BUILD_ROWS(K)                                                             \
  case K / 2:                                                                          \
    build_rows<T, Base, kCols, K>(x1s, x2s, s2, rows, tile, ld, first, last);          \
    break;
      MOGP_BUILD_ROWS(2)
      MOGP_BUILD_ROWS(4)
      MOGP_BUILD_ROWS(6)
      MOGP_BUILD_ROWS(8)
      MOGP_BUILD_ROWS(10)
      MOGP_BUILD_ROWS(12)
      MOGP_BUILD_ROWS(14)
#undef MOGP_BUILD_ROWS
      default:
        build_rows<T, Base, kCols, kDimChunk>(x1s, x2s, s2, rows, tile, ld, first, last);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K1: K* to device memory.  Block (query tile, row block, lane).
// ---------------------------------------------------------------------------
template <typename T, int Base, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
kernel_matrix_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ exp_theta, const T* __restrict__ sigma2,
                     T* __restrict__ out, int n, int m, int D, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [rows_per_block][kK1Cols]
  T* stage = tile + rows_per_block * kK1Cols;

  const int lane = blockIdx.z;
  const int j0 = blockIdx.x * kK1Cols;
  const int i0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n - i0);
  build_tile<T, Base, kK1Cols>(x1 + static_cast<size_t>(lane) * n * D, x2,
                               exp_theta + static_cast<size_t>(lane) * D, sigma2[lane], i0,
                               rows, j0, m, D, tile, kK1Cols, stage);

  // whole rows of the tile, 16 bytes a thread, consecutive threads on
  // consecutive addresses, streaming; scalar stores only at a ragged end
  // (or where m leaves rows unaligned, kVec false)
  constexpr int kVecElems = 16 / sizeof(T);
  constexpr int kChunks = kK1Cols / kVecElems;
  const int cols = min(kK1Cols, m - j0);
  T* out_block = out + (static_cast<size_t>(lane) * n + i0) * m + j0;
  for (int k = threadIdx.x; k < rows * kChunks; k += kThreads) {
    const int r = k / kChunks;
    const int col = (k - r * kChunks) * kVecElems;
    T* dst = out_block + static_cast<size_t>(r) * m + col;
    const T* src = tile + r * kK1Cols + col;
    if (kVec && col + kVecElems <= cols) {
      stg16_cs(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < kVecElems; ++e) {
        if (col + e < cols) __stcs(dst + e, src[e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fused prediction.  Block (query tile of kQ, lane).
// ---------------------------------------------------------------------------

// elements of a strip buffer, and of the region that holds build_tile's
// stage, then three strips
__host__ __device__ constexpr int strip_elems(int n) {
  return (n > kPanel ? n : kPanel) * kPanel;
}
__host__ __device__ constexpr int fused_region_elems(int n) {
  return 3 * strip_elems(n) > stage_elems(n, kQ) ? 3 * strip_elems(n) : stage_elems(n, kQ);
}

// dynamic shared memory of the fused kernel, in elements: the n x kQ tile,
// the region, the design rows and r (M x kQ), and nine rows of kQ: eight of
// partial sums at M = 0; LA packed and beta (at most 560 elements) at M > 0
static_assert(kMaxMean * (kMaxMean + 1) / 2 + kMaxMean <= 9 * kQ, "LA and beta fit");
__host__ __device__ constexpr int fused_smem_elems(int n, int M) {
  return n * kQ + fused_region_elems(n) + ((M > 0 ? M : 1) + 9) * kQ;
}

// rows p0 .. n - 1 of columns p0 .. p0 + kPanel - 1 of the lane's factor
// (row stride ldl, a multiple of 16 bytes) into strip[(i - p0) * kPanel +
// k], 16 bytes a copy; columns at or beyond n are zero-filled
template <typename T>
__device__ __forceinline__ void load_strip(const T* __restrict__ Lk_lane, int n, int ldl, int p0,
                                           T* strip) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kPieces = kPanel / kV;
  const int count = (n - p0) * kPieces;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int r = k / kPieces;
    const int col = p0 + (k - r * kPieces) * kV;
    const int valid = max(0, min(kV, n - col));
    const T* src = Lk_lane + static_cast<size_t>(p0 + r) * ldl + (valid > 0 ? col : p0);
    cp_async16(strip + r * kPanel + (col - p0), src, valid * static_cast<int>(sizeof(T)));
  }
}

__device__ __forceinline__ float dev_rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double dev_rcp(double x) { return __drcp_rn(x); }

// One query column's diagonal solve of a panel: v (the panel's bw rows, in
// registers) = D^-1 v with D the panel's diagonal block (row stride kPanel
// in dblk); adds the squares of the solved values to ss.  The reciprocals
// of the pivots do not depend on v, so they leave the dependent chain.
// The block's columns go kV at a time: the kV x kV sub-block on the
// diagonal column by column, then each row below it with one 16-byte load of
// its kV entries; every v[i] takes its terms in the order of a
// column-by-column substitution.
template <typename T>
__device__ __forceinline__ void diag_solve(T (&v)[kPanel], const T* dblk, int bw, T (&ss)[4]) {
  constexpr int kV = 16 / sizeof(T);
  T rinv[kPanel];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) rinv[k] = k < bw ? dev_rcp(dblk[k * kPanel + k]) : T(0);
#pragma unroll
  for (int k0 = 0; k0 < kPanel; k0 += kV) {
#pragma unroll
    for (int k = k0; k < k0 + kV; ++k) {
      if (k < bw) {
        const T x = v[k] * rinv[k];
        v[k] = x;
        ss[k % 4] = dev_fma(x, x, ss[k % 4]);
#pragma unroll
        for (int i = k + 1; i < k0 + kV; ++i) {
          if (i < bw) v[i] = dev_fma(-dblk[i * kPanel + k], x, v[i]);
        }
      }
    }
#pragma unroll
    for (int i = k0 + kV; i < kPanel; ++i) {
      if (i < bw) {
        T d[kV];
        lds16(dblk + i * kPanel + k0, d);
#pragma unroll
        for (int e = 0; e < kV; ++e) v[i] = dev_fma(-d[e], v[k0 + e], v[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The mean-term stage (M > 0).  The products with the M + 1 vectors [alpha |
// Kinv_dm] go a chunk of kVecs vectors at a time through shared memory
// (load_vectors).  Thread t holds a 4 x 4 micro-tile, vectors 4 vg .. 4 vg +
// 3 of the chunk (vg = t / 64) by four query columns (mean_col), over the
// rows s, s + 4, ... (slice s = lane / 8 of 4); the four slices of a tile
// are lanes 8 apart in one warp.
// ---------------------------------------------------------------------------

// query column of element e of micro-tile column group g (0 .. 15): one
// 16-byte piece in float32, two 32 columns apart in float64, so that a
// quarter-warp reads 128 contiguous bytes of a tile row
template <typename T>
__device__ __forceinline__ int mean_col(int g, int e) {
  constexpr int kV = 16 / sizeof(T);
  return (e / kV) * (kQ * kV / 4) + g * kV + e % kV;
}

// the four elements of a micro-tile row: 16-byte pieces at p, p + step
template <typename T>
__device__ __forceinline__ void lds4(const T* p, int step, T (&v)[4]) {
  constexpr int kV = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < 4; k += kV) lds16(p + (k / kV) * step, v + k);
}
template <typename T>
__device__ __forceinline__ void sts4(T* p, int step, const T (&v)[4]) {
  constexpr int kV = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < 4; k += kV) sts16(p + (k / kV) * step, v + k);
}

// v[s], by selects, so that v stays in registers
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[4], int s) {
  T x = v[0];
#pragma unroll
  for (int e = 1; e < 4; ++e) x = e == s ? v[e] : x;
  return x;
}

// the tile's design rows transposed, dm[a * kQ + c] = dmtest[j0 + c, a]
// (zero at or beyond m), beta, and, with unc, LA's lower triangle packed by
// rows (row a at a (a + 1) / 2); element by element, consecutive threads on
// consecutive addresses
template <typename T>
__device__ __forceinline__ void load_mean_terms(const T* __restrict__ dmtest,
                                                const T* __restrict__ beta_lane,
                                                const T* __restrict__ LA_lane, int j0, int m,
                                                int M, int unc, T* dm, T* lap, T* betas) {
  for (int k = threadIdx.x; k < kQ * M; k += kThreads) {
    const int c = k / M;
    const bool valid = j0 + c < m;
    cp_async_elem(dm + (k - c * M) * kQ + c,
                  dmtest + (valid ? static_cast<size_t>(j0) * M + k : 0), valid);
  }
  for (int k = threadIdx.x; k < M; k += kThreads) cp_async_elem(betas + k, beta_lane + k, true);
  if (unc) {
    for (int k = threadIdx.x; k < M * M; k += kThreads) {
      const int a = k / M;
      const int b = k - a * M;
      if (b <= a) cp_async_elem(lap + a * (a + 1) / 2 + b, LA_lane + k, true);
    }
  }
}

// chunk ch of the vectors, w[i * kVecs + c] = vector ch kVecs + c at row i
// (vector 0: alpha, vector a + 1: column a of Kinv_dm; zero beyond M),
// element by element, consecutive threads on consecutive vectors of a row
template <typename T>
__device__ __forceinline__ void load_vectors(const T* __restrict__ alpha_lane,
                                             const T* __restrict__ Kinv_lane, int n, int M,
                                             int ch, T* w) {
  for (int k = threadIdx.x; k < n * kVecs; k += kThreads) {
    const int i = k / kVecs;
    const int c = ch * kVecs + k % kVecs;
    const T* src = c == 0 ? alpha_lane + i : Kinv_lane + static_cast<size_t>(i) * M + c - 1;
    cp_async_elem(w + k, c <= M ? src : alpha_lane, c <= M);
  }
}

// thread t's micro-tile of W^T V over its slice, as two chains (rows s +
// 8 k and s + 4 + 8 k) summed, the four slices then summed by two butterfly
// shuffles, ((s0 + s1) + (s2 + s3)) in every lane of the four: the order
// depends on n alone
template <typename T>
__device__ __forceinline__ void mean_product(const T* V, const T* wbuf, int n, T (&acc)[4][4]) {
  constexpr int kV = 16 / sizeof(T);
  const int t = threadIdx.x;
  const int g = ((t / 32) % 2) * 8 + t % 8;
  const T* w_t = wbuf + (t / 64) * 4;
  const T* v_t = V + g * kV;
  T chain[2][4][4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int e = 0; e < 4; ++e) chain[c][v][e] = T(0);
    }
  }
#pragma unroll 2
  for (int i = (t % 32) / 8; i < n; i += 8) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = i + 4 * c;
      if (r < n) {
        T w[4], k[4];
        lds4(w_t + r * kVecs, kV, w);
        lds4(v_t + r * kQ, kQ * kV / 4, k);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
#pragma unroll
          for (int e = 0; e < 4; ++e) chain[c][v][e] = dev_fma(w[v], k[e], chain[c][v][e]);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[v][e] = chain[0][v][e] + chain[1][v][e];
  }
#pragma unroll
  for (int lanes = 8; lanes < 32; lanes *= 2) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[v][e] += __shfl_xor_sync(0xffffffffu, acc[v][e], lanes);
    }
  }
}

// |u|^2 of query column t, u = LA^-1 r by forward substitution in
// registers (column by column; each u[a] takes its terms in the order b =
// 0 .. a - 1, as a row-by-row substitution does), LA packed in shared
template <typename T>
__device__ __forceinline__ T mean_solve(const T* r, const T* lap, int M) {
  const int t = threadIdx.x;
  T x[kMaxMean];
#pragma unroll
  for (int a = 0; a < kMaxMean; ++a) x[a] = a < M ? r[a * kQ + t] : T(0);
  T u2 = T(0);
#pragma unroll
  for (int a = 0; a < kMaxMean; ++a) {
    if (a < M) {
      const T u = x[a] / lap[a * (a + 1) / 2 + a];
      u2 = dev_fma(u, u, u2);
#pragma unroll
      for (int b = a + 1; b < kMaxMean; ++b) {
        if (b < M) x[b] = dev_fma(-lap[b * (b + 1) / 2 + a], u, x[b]);
      }
    }
  }
  return u2;
}

template <typename T, int Base, bool kMean>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
predict_fused_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ exp_theta, const T* __restrict__ sigma2,
                     const T* __restrict__ Lk, const T* __restrict__ alpha,
                     const T* __restrict__ Kinv_dm, const T* __restrict__ dmtest,
                     const T* __restrict__ beta, const T* __restrict__ LA,
                     const T* __restrict__ var_shift, T* __restrict__ mu,
                     T* __restrict__ var, int n, int ldl, int m, int D, int M, int unc) {
  // the bulk of the trailing update: threads kQ .. kThreads - 1, kTN query
  // columns a thread, kRG row groups
  constexpr int kTN = 16 / sizeof(T);
  constexpr int kCG = kQ / kTN;
  constexpr int kRG = (kThreads - kQ) / kCG;
  constexpr int kWarps = kThreads / 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* V = reinterpret_cast<T*>(smem_raw);  // [n][kQ]: K*, then v in place
  T* region = V + n * kQ;                 // the build's stage, then 3 strips
  T* rs = region + fused_region_elems(n); // [M][kQ]: the design rows, then r
  T* part = rs + (M > 0 ? M : 1) * kQ;    // M = 0: [kWarps][kQ] partial sums;
                                          // M > 0: LA packed, then beta

  const int lane = blockIdx.y;
  const int j0 = blockIdx.x * kQ;
  const int t = threadIdx.x;
  const T* Lk_lane = Lk + static_cast<size_t>(lane) * n * ldl;
  const int sz = strip_elems(n);
  const T* alpha_lane = alpha + static_cast<size_t>(lane) * n;
  const T* Kinv_lane = Kinv_dm + static_cast<size_t>(lane) * n * M;

  // 1. K* for this lane and query tile
  build_tile<T, Base, kQ>(x1 + static_cast<size_t>(lane) * n * D, x2,
                          exp_theta + static_cast<size_t>(lane) * D, sigma2[lane], 0, n, j0, m,
                          D, V, kQ, region);

  // the mean stage's operands (the first chunk of vectors into the third
  // strip buffer, free until the substitution's first panel), then the
  // factor's first two strips, land while the mean and r are formed
  T* wbuf = region + 2 * sz;
  T* betas = part + M * (M + 1) / 2;
  if constexpr (kMean) {
    load_vectors(alpha_lane, Kinv_lane, n, M, 0, wbuf);
    load_mean_terms(dmtest, beta + static_cast<size_t>(lane) * M,
                    LA + static_cast<size_t>(lane) * M * M, j0, m, M, unc, rs, part, betas);
    cp_async_commit();
  }
  if (unc) {
    load_strip(Lk_lane, n, ldl, 0, region);
    cp_async_commit();
    if (kPanel < n) {
      load_strip(Lk_lane, n, ldl, kPanel, region + sz);
      cp_async_commit();
    }
  }

  T u2 = T(0);
  if constexpr (kMean) {
    // 2. the mean, r = dmtest_j - Kinv_dm^T k and k . alpha, chunk by chunk
    // (mean_product); vector 16 ch + 4 vg + s of the micro-tile goes out by
    // lane s, and k . alpha with the mean of column mean_col(g, s) by lane s
    // of the warps with vg = 0 (threads 0 .. kQ - 1)
    if (!unc) {
      cp_async_wait<0>();
    } else if (kPanel < n) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    const int g = ((t / 32) % 2) * 8 + t % 8;
    const int s = (t % 32) / 8;
    const int mc = mean_col<T>(g, s);
    T mt = T(0);
    if (t < kQ) {
#pragma unroll 4
      for (int a = 0; a < M; ++a) mt = dev_fma(rs[a * kQ + mc], betas[a], mt);
    }
    __syncthreads();  // every design row read before r overwrites it
    const int nch = unc ? (M + kVecs) / kVecs : 1;
    for (int ch = 0; ch < nch; ++ch) {
      if (ch > 0) {
        __syncthreads();
        load_vectors(alpha_lane, Kinv_lane, n, M, ch, wbuf);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      T acc[4][4];
      mean_product(V, wbuf, n, acc);
      // k . alpha of column mc is acc[0][s]
      if (ch == 0 && t < kQ && j0 + mc < m) {
        mu[static_cast<size_t>(lane) * m + j0 + mc] = mt + pick(acc[0], s);
      }
      const int a = ch * kVecs + (t / 64) * 4 + s - 1;  // this lane's column of Kinv_dm
      if (unc && a >= 0 && a < M) {
        constexpr int kV = 16 / sizeof(T);
        T d[4];
        lds4(rs + a * kQ + g * kV, kQ * kV / 4, d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T col[4] = {acc[0][e], acc[1][e], acc[2][e], acc[3][e]};
          d[e] = d[e] - pick(col, s);
        }
        sts4(rs + a * kQ + g * kV, kQ * kV / 4, d);
      }
    }
    if (!unc) return;
    __syncthreads();
    // 3. |u|^2 of column t, u = LA^-1 r
    if (t < kQ) u2 = mean_solve(rs, part, M);
  } else {
    // 2. k . alpha before the substitution overwrites k: row slice w of 8 by
    // warp w, each thread taking columns ln and ln + 32
    {
      const int warp = t / 32;
      const int ln = t % 32;
      const T* src = alpha_lane;
      T a0[2] = {T(0), T(0)};
      T a1[2] = {T(0), T(0)};
      for (int i = warp; i < n; i += 2 * kWarps) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ii = i + q * kWarps;
          if (ii < n) {
            const T wi = __ldg(src + ii);
            a0[q] = dev_fma(wi, V[ii * kQ + ln], a0[q]);
            a1[q] = dev_fma(wi, V[ii * kQ + ln + 32], a1[q]);
          }
        }
      }
      part[warp * kQ + ln] = a0[0] + a0[1];
      part[warp * kQ + ln + 32] = a1[0] + a1[1];
    }
    __syncthreads();

    // 3. one thread per query column: the slices' sums, and the (zero) mean
    if (t < kQ) {
      const int j = j0 + t;
      T sum = T(0);
      for (int sl = 0; sl < kWarps; ++sl) sum += part[sl * kQ + t];
      const T mt = T(0);
      if (j < m) mu[static_cast<size_t>(lane) * m + j] = mt + sum;
    }
    if (!unc) return;
  }

  // 4. v = Lk^-1 k in place, over panels of kPanel rows, with a look-ahead:
  // while threads kQ.. apply panel p to the rows below panel p + 1, threads
  // 0 .. kQ - 1 (one query column each) apply it to panel p + 1's own rows
  // and solve that panel's diagonal block, so the serial chain of the
  // diagonal solves runs beside the bulk of the update.  Strip p + 2 of the
  // factor lands meanwhile (three buffers: p, p + 1, p + 2).
  T ss[4] = {T(0), T(0), T(0), T(0)};  // |v|^2 of column t, four partial sums
  if (kPanel < n) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  if (t < kQ) {
    const int bw = min(kPanel, n);
    T v[kPanel];
#pragma unroll
    for (int r = 0; r < kPanel; ++r) v[r] = r < bw ? V[r * kQ + t] : T(0);
    diag_solve(v, region, bw, ss);
#pragma unroll
    for (int r = 0; r < kPanel; ++r) {
      if (r < bw) V[r * kQ + t] = v[r];
    }
  }
  for (int p0 = 0, it = 0; p0 + kPanel < n; p0 += kPanel, ++it) {
    const int q0 = p0 + kPanel;  // panel p + 1
    // strip p + 1 complete for every thread; panel p solved; the buffer of
    // strip p - 1 free
    cp_async_wait<0>();
    __syncthreads();
    if (q0 + kPanel < n) {
      load_strip(Lk_lane, n, ldl, q0 + kPanel, region + ((it + 2) % 3) * sz);
      cp_async_commit();
    }
    const T* strip = region + (it % 3) * sz;
    if (t < kQ) {
      const T* next = region + ((it + 1) % 3) * sz;
      const int bw = min(kPanel, n - q0);
      T b[kPanel], v[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) b[k] = V[(p0 + k) * kQ + t];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) v[r] = r < bw ? V[(q0 + r) * kQ + t] : T(0);
      // panel p + 1's rows by panel p, kTN of panel p's columns at a time,
      // so that the rows' sixteen chains run side by side
#pragma unroll
      for (int k0 = 0; k0 < kPanel; k0 += kTN) {
#pragma unroll
        for (int r = 0; r < kPanel; ++r) {
          if (r < bw) {
            T l[kTN];
            lds16(strip + (kPanel + r) * kPanel + k0, l);
#pragma unroll
            for (int e = 0; e < kTN; ++e) v[r] = dev_fma(-l[e], b[k0 + e], v[r]);
          }
        }
      }
      diag_solve(v, next, bw, ss);
#pragma unroll
      for (int r = 0; r < kPanel; ++r) {
        if (r < bw) V[(q0 + r) * kQ + t] = v[r];
      }
    } else if (q0 + kPanel < n) {
      // V[rows below panel p + 1] -= Lk[those rows, panel p] V[panel p]
      const int tb = t - kQ;
      const int rg = tb / kCG;
      const int c0 = (tb % kCG) * kTN;
      T b[kPanel][kTN];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) lds16(V + (p0 + k) * kQ + c0, b[k]);
      for (int i = q0 + kPanel + rg; i < n; i += kRG) {
        T acc[kTN];
        lds16(V + i * kQ + c0, acc);
        T l[kPanel];
#pragma unroll
        for (int k = 0; k < kPanel; k += kTN) lds16(strip + (i - p0) * kPanel + k, l + k);
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
#pragma unroll
          for (int e = 0; e < kTN; ++e) acc[e] = dev_fma(-l[k], b[k][e], acc[e]);
        }
        sts16(V + i * kQ + c0, acc);
      }
    }
  }

  // 5. the variance: column t's |v|^2 is in thread t's registers
  if (t < kQ) {
    const int j = j0 + t;
    if (j < m) {
      const T s = (ss[0] + ss[1]) + (ss[2] + ss[3]);
      const T vj = var_shift[lane] - s + u2;
      var[static_cast<size_t>(lane) * m + j] = vj > T(0) ? vj : T(0);
    }
  }
}

// opt in to more than 48 KB of dynamic shared memory once per instantiation
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int Base>
int launch_kernel_matrix(const void* x1, const void* x2, const void* exp_theta,
                         const void* sigma2, void* out, int L, int n, int m, int D,
                         cudaStream_t stream) {
  const int row_blocks = (n + kK1MaxRows<T> - 1) / kK1MaxRows<T>;
  const int rows = (n + row_blocks - 1) / row_blocks;
  const dim3 grid((m + kK1Cols - 1) / kK1Cols, row_blocks, L);
  const size_t smem = sizeof(T) * (rows * kK1Cols + stage_elems(rows, kK1Cols));
  const bool vec = (static_cast<size_t>(m) * sizeof(T)) % 16 == 0;
  auto k = vec ? kernel_matrix_kernel<T, Base, true> : kernel_matrix_kernel<T, Base, false>;
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x1), static_cast<const T*>(x2),
                                      static_cast<const T*>(exp_theta),
                                      static_cast<const T*>(sigma2), static_cast<T*>(out), n, m,
                                      D, rows);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for M: the mean-term stage where M > 0
template <typename T, int Base>
auto fused_instance(int M) {
  return M > 0 ? predict_fused_kernel<T, Base, true> : predict_fused_kernel<T, Base, false>;
}

template <typename T, int Base>
int launch_predict_fused(const void* const* p, void* mu, void* var, int L, int n, int ldl, int m,
                         int D, int M, int unc, cudaStream_t stream) {
  if (ldl < n || (ldl * sizeof(T)) % 16 != 0 || M < 0 || M > kMaxMean) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(T) * static_cast<size_t>(fused_smem_elems(n, M));
  auto k = fused_instance<T, Base>(M);
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kQ - 1) / kQ, L);
  const T* const* q = reinterpret_cast<const T* const*>(p);
  k<<<grid, kThreads, smem, stream>>>(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9],
                                      q[10], static_cast<T*>(mu), static_cast<T*>(var), n, ldl, m,
                                      D, M, unc);
  return static_cast<int>(cudaGetLastError());
}

// blocks of the instantiation for (n, M) that one SM holds
template <typename T, int Base>
int predict_fused_occupancy(int n, int M, int* blocks) {
  const size_t smem = sizeof(T) * static_cast<size_t>(fused_smem_elems(n, M));
  auto k = fused_instance<T, Base>(M);
  cudaError_t err = allow_smem(k, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, smem);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a cudaError_t (0 on success).
// base: 0 squared exponential, 1 Matern 5/2; is_double: 0 float, 1 double.
int mogp_kernel_matrix(const void* x1, const void* x2, const void* exp_theta,
                       const void* sigma2, void* out, int L, int n, int m, int D, int base,
                       int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (base == kSqExp) {
    return is_double ? launch_kernel_matrix<double, kSqExp>(x1, x2, exp_theta, sigma2, out, L, n, m, D, s)
                     : launch_kernel_matrix<float, kSqExp>(x1, x2, exp_theta, sigma2, out, L, n, m, D, s);
  }
  if (base == kMat52) {
    return is_double ? launch_kernel_matrix<double, kMat52>(x1, x2, exp_theta, sigma2, out, L, n, m, D, s)
                     : launch_kernel_matrix<float, kMat52>(x1, x2, exp_theta, sigma2, out, L, n, m, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the fused kernel in bytes, for the wrapper's
// bounds: n training points, M mean terms, element size 4 or 8.
long long mogp_predict_fused_smem(int n, int M, int elem_bytes) {
  return static_cast<long long>(elem_bytes) * fused_smem_elems(n, M);
}

// The fused prediction.  ptrs: x1 (L, n, D), x2 (m, D), exp_theta (L, D),
// sigma2 (L), Lk (L, n, ldl) lower, its rows padded to ldl >= n elements (a
// multiple of 16 bytes), alpha (L, n), Kinv_dm (L, n, M), dmtest (m, M),
// beta (L, M), LA (L, M, M) lower, var_shift (L); all contiguous, one
// floating type; M <= 32.  Writes mu (L, m) and, if unc, var (L, m).
int mogp_predict_fused(const void* const* ptrs, void* mu, void* var, int L, int n, int ldl, int m,
                       int D, int M, int unc, int base, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (base == kSqExp) {
    return is_double
               ? launch_predict_fused<double, kSqExp>(ptrs, mu, var, L, n, ldl, m, D, M, unc, s)
               : launch_predict_fused<float, kSqExp>(ptrs, mu, var, L, n, ldl, m, D, M, unc, s);
  }
  if (base == kMat52) {
    return is_double
               ? launch_predict_fused<double, kMat52>(ptrs, mu, var, L, n, ldl, m, D, M, unc, s)
               : launch_predict_fused<float, kMat52>(ptrs, mu, var, L, n, ldl, m, D, M, unc, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the fused kernel resident on one SM at n training points and M
// mean terms (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative
// cudaError_t.
int mogp_predict_fused_occupancy(int n, int M, int base, int is_double) {
  int blocks = 0;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (base == kSqExp) {
    err = is_double ? predict_fused_occupancy<double, kSqExp>(n, M, &blocks)
                    : predict_fused_occupancy<float, kSqExp>(n, M, &blocks);
  } else if (base == kMat52) {
    err = is_double ? predict_fused_occupancy<double, kMat52>(n, M, &blocks)
                    : predict_fused_occupancy<float, kMat52>(n, M, &blocks);
  }
  return err ? -err : blocks;
}

const char* mogp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
