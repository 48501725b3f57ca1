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

// the fused kernel: queries per block, rows per substitution panel
constexpr int kQ = 64;
constexpr int kPanel = 16;

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
// the region, r / u (M x kQ), eight rows of partial sums and k . alpha
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

template <typename T, int Base>
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
  T* rs = region + fused_region_elems(n); // [M][kQ]: r, then u in place
  T* part = rs + (M > 0 ? M : 1) * kQ;    // [kWarps][kQ]: partial sums
  T* kalpha = part + kWarps * kQ;         // [kQ]: k . alpha

  const int lane = blockIdx.y;
  const int j0 = blockIdx.x * kQ;
  const int t = threadIdx.x;
  const T* Lk_lane = Lk + static_cast<size_t>(lane) * n * ldl;
  const int sz = strip_elems(n);

  // 1. K* for this lane and query tile
  build_tile<T, Base, kQ>(x1 + static_cast<size_t>(lane) * n * D, x2,
                          exp_theta + static_cast<size_t>(lane) * D, sigma2[lane], 0, n, j0, m,
                          D, V, kQ, region);

  // the factor's first two strips land while the mean and r are formed
  if (unc) {
    load_strip(Lk_lane, n, ldl, 0, region);
    cp_async_commit();
    if (kPanel < n) {
      load_strip(Lk_lane, n, ldl, kPanel, region + sz);
      cp_async_commit();
    }
  }

  // 2. k . alpha and, with unc, Kinv_dm^T k, before the substitution
  // overwrites k.  Vector w (0: alpha, a + 1: column a of Kinv_dm) is split
  // into S row slices when there are fewer vectors than warps; item w S + s
  // is warp (w S + s) % 8's, each thread taking columns ln and ln + 32.
  // S depends on M alone, so that k . alpha sums in one order with and
  // without unc
  const int nvec = unc ? M + 1 : 1;
  const int S = M + 1 >= kWarps ? 1 : kWarps / (M + 1);
  {
    const int warp = t / 32;
    const int ln = t % 32;
    for (int item = warp; item < nvec * S; item += kWarps) {
      const int w = item / S;
      const int sl = item - w * S;
      const T* src = w == 0 ? alpha + static_cast<size_t>(lane) * n
                            : Kinv_dm + static_cast<size_t>(lane) * n * M + (w - 1);
      const int stride = w == 0 ? 1 : M;
      T a0[2] = {T(0), T(0)};
      T a1[2] = {T(0), T(0)};
      for (int i = sl; i < n; i += 2 * S) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ii = i + q * S;
          if (ii < n) {
            const T wi = __ldg(src + static_cast<size_t>(ii) * stride);
            a0[q] = dev_fma(wi, V[ii * kQ + ln], a0[q]);
            a1[q] = dev_fma(wi, V[ii * kQ + ln + 32], a1[q]);
          }
        }
      }
      const T s0 = a0[0] + a0[1];
      const T s1 = a1[0] + a1[1];
      if (S > 1) {
        part[item * kQ + ln] = s0;
        part[item * kQ + ln + 32] = s1;
      } else if (w == 0) {
        kalpha[ln] = s0;
        kalpha[ln + 32] = s1;
      } else {
        const int a = w - 1;
        const int ja = j0 + ln, jb = j0 + ln + 32;
        rs[a * kQ + ln] = (ja < m ? dmtest[static_cast<size_t>(ja) * M + a] : T(0)) - s0;
        rs[a * kQ + ln + 32] = (jb < m ? dmtest[static_cast<size_t>(jb) * M + a] : T(0)) - s1;
      }
    }
  }
  __syncthreads();

  // 3. one thread per query column: the slices' sums, the mean, and |u|^2
  // from the M x M forward substitution u = LA^-1 r in place
  T u2 = T(0);
  if (t < kQ) {
    const int j = j0 + t;
    if (S > 1) {
      for (int w = 0; w < nvec; ++w) {
        T sum = T(0);
        for (int sl = 0; sl < S; ++sl) sum += part[(w * S + sl) * kQ + t];
        if (w == 0) {
          kalpha[t] = sum;
        } else {
          rs[(w - 1) * kQ + t] = (j < m ? dmtest[static_cast<size_t>(j) * M + w - 1] : T(0)) - sum;
        }
      }
    }
    T mt = T(0);
    if (j < m) {
      for (int a = 0; a < M; ++a) {
        mt = dev_fma(dmtest[static_cast<size_t>(j) * M + a],
                     beta[static_cast<size_t>(lane) * M + a], mt);
      }
      mu[static_cast<size_t>(lane) * m + j] = mt + kalpha[t];
    }
    if (unc) {
      const T* LA_lane = LA + static_cast<size_t>(lane) * M * M;
      for (int a = 0; a < M; ++a) {
        T s = rs[a * kQ + t];
        for (int b = 0; b < a; ++b) s = dev_fma(-__ldg(LA_lane + a * M + b), rs[b * kQ + t], s);
        const T u = s / __ldg(LA_lane + a * M + a);
        rs[a * kQ + t] = u;
        u2 = dev_fma(u, u, u2);
      }
    }
  }
  if (!unc) return;

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

template <typename T, int Base>
int launch_predict_fused(const void* const* p, void* mu, void* var, int L, int n, int ldl, int m,
                         int D, int M, int unc, cudaStream_t stream) {
  if (ldl < n || (ldl * sizeof(T)) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * static_cast<size_t>(fused_smem_elems(n, M));
  auto k = predict_fused_kernel<T, Base>;
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kQ - 1) / kQ, L);
  const T* const* q = reinterpret_cast<const T* const*>(p);
  k<<<grid, kThreads, smem, stream>>>(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9],
                                      q[10], static_cast<T*>(mu), static_cast<T*>(var), n, ldl, m,
                                      D, M, unc);
  return static_cast<int>(cudaGetLastError());
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
// floating type.  Writes mu (L, m) and, if unc, var (L, m).
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

const char* mogp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
