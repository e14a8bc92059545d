// Batched blocked Cholesky of a stack of SPD matrices, every lane in
// lockstep.
//
// Replaces no TPU kernel: the JAX package leaves the dense factor to
// cho_factor (XLA's potrf), and the port called cuSOLVER's potrf once a
// lane (linear.cholesky_each).  A single-matrix potrf leaves most of the
// H100's 132 SMs idle in its panel steps, one lane after another: eight
// 5217^2 factors (the dense joint systems of eight INTEL+50 lanes) took
// ~21.7 ms of getrf panels plus syrk updates an LM iteration, about a
// quarter of the float32 bound (PERF.md).  Here one launch serves every
// lane of a step.
//
// Bound: n^3 / 3 flops a lane (8 x 5217^3 / 3 = 3.79e11, 5.65 ms at 67
// TFLOP/s of float32 FFMA) and the trailing lower triangle read and
// written once a wide update (~n^3 / (6 g nb) elements a lane at block
// width nb and g steps a wide update: 11.8 GB at nb = 128 and g = 1, 3.5
// ms at 3.35 TB/s), besides the n^2 matrix read and the factor written
// once.  So the trailing products bound it; the chain of diagonal blocks
// (41 at 5217) bounds it from below by its latency.  The design:
//   - stage_kernel: one pass reads the lower triangle of A (row-major,
//     any row stride), multiplies by the Jacobi scale as the plain
//     version does, ((A_ij d_i) d_j), transposes through shared memory and
//     writes the factor's column-major buffer (lane b's (i, j) at
//     b n^2 + j n + i, the layout cholesky_ex returns) with zeros above
//     the diagonal; diag_kernel then factors block (0, 0) of every lane;
//   - update_kernel: A_IJ -= sum_K L_IK L_JK^T over a range of panels K
//     and a set of lower tiles, a CTA a (lane, tile): a register-tiled
//     product (8 x 8 accumulators a thread at nb = 128, its k-panels staged
//     through shared memory by cp.async in three stages, C prefetched into
//     L2 and copied into shared memory during the last stages), two CTAs
//     an SM; a diagonal tile writes its lower triangle only;
//   - panel_kernel: L_IK = A_IK L_KK^-T, a CTA a (lane, I), by blocked
//     substitution (no explicit inverse);
//   - the schedule (factor() below) is right-looking with a lookahead:
//     the steps go in groups; the next group's block columns are brought
//     up to date by the group's panels in one launch, then each of them by
//     its own group's panels before it in a column update, whose CTA of the
//     diagonal tile factors it (B5's register-tiled right-looking loop,
//     csrc/chol.cu: one barrier a column, the column divided by
//     sqrt(d_jj)), then its panel follows; that chain runs on a second,
//     high-priority stream beside the far update of the tiles further
//     right by the group's panels together (depth g nb: fewer passes over
//     the trailing triangle, longer products between two epilogues); all
//     launches are issued by one C call;
//   - the last ragged block (5217 = 40 x 128 + 97) is masked, never
//     padded; no tensor cores (TF32 fails the check; FFMA / DFMA on the
//     CUDA cores, contracted to FMAs);
//   - a CTA's arithmetic and order of summation depend only on its lane's
//     data, its tile's coordinates, n and the dtype, never on the number
//     of lanes, so a lane's factor is its matrix's factor alone to the bit;
//   - info[b] is the first non-positive (or NaN) pivot of lane b, 1-based,
//     as LAPACK reports it, 0 when the lane factored; a failed lane goes on
//     in NaN, and only that lane.
// On the H100 (PERF.md), eight 5217^2 float32 factors take 15.1-15.2 ms,
// 37% of the bound, against 28.1-28.3 ms for the cuSOLVER loop; the
// products run at ~60% of the FFMA peak between epilogues, which cost
// about a quarter of a 128-deep product each.

#include <initializer_list>

#include "common.cuh"

namespace slam {
namespace stack_chol {

// The thread grid: R x R = kThreads threads a CTA in every kernel.
constexpr int R = 16;
static_assert(R * R == kThreads, "the kernels use a 16 x 16 thread grid");
// The products: k-panel depth and cp.async stages.
constexpr int BK = 8;
constexpr int STAGES = 3;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// a / b rounded to nearest from y = RN(1 / b), as csrc/chol.cu's div_rcp:
// q = RN(a y), r = a - b q exact in one FMA, RN(q + r y) the quotient.
template <typename T>
__device__ __forceinline__ T div_rcp(T a, T b, T y) {
  const T q = a * y;
  return fma_(fma_(-b, q, a), y, q);
}

// One element from global to shared memory, asynchronously; zeros where
// !valid (src must still be a mapped address).
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? static_cast<int>(sizeof(T)) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows (or columns) of the block that starts at start, of at most nb.
__device__ __forceinline__ int extent(int64_t n, int64_t start, int nb) {
  const int64_t r = n - start;
  return r < nb ? static_cast<int>(r) : nb;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Four consecutive elements of shared memory (16-byte aligned).
__device__ __forceinline__ void load4(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void load4(double* d, const double* s) {
  const double2 a = *reinterpret_cast<const double2*>(s);
  const double2 b = *reinterpret_cast<const double2*>(s + 2);
  d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
}
__device__ __forceinline__ void store4(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void store4(double* d, const double* s) {
  *reinterpret_cast<double2*>(d) = make_double2(s[0], s[1]);
  *reinterpret_cast<double2*>(d + 2) = make_double2(s[2], s[3]);
}

// Factors the leading p x p block (p <= NB) of the tile S in shared memory
// (column-major: S[j * ld + i] holds (i, j); the lower triangle is read) in
// place into its lower Cholesky factor, right-looking.  Thread (tr, tc)
// holds elements (ta R + tr, tb R + tc), ta >= tb, in registers and its own
// copy of its columns' diagonals; step j: one barrier after column j is in
// shared memory, then every thread reads the column at its rows and
// columns and updates its elements, block column a0 first, so that the
// threads of column j + 1 divide it by sqrt(d), correctly rounded as
// LAPACK's potrf does, and store it while the rest of the update goes on
// (B5's loop, csrc/chol.cu, with FMAs and a square root for its rsqrt).
// Rows and columns past p are clamped or held at zero; entries above the
// diagonal of S are left with values nothing reads.  Returns the first
// column whose pivot was not positive, or p; every column is visible on
// return.
template <typename T, int NB>
__device__ int factor_tile(T* S, int ld, int p, int* fail) {
  constexpr int TR = NB / R;
  const int tid = threadIdx.x;
  const int tr = tid / R;
  const int tc = tid - tr * R;
  if (tid == 0) *fail = p;
  T t[TR][TR];
  T dg[TR];
#pragma unroll
  for (int ta = 0; ta < TR; ++ta) {
    const int i = ta * R + tr;
#pragma unroll
    for (int tb = 0; tb <= ta; ++tb) {
      const int k = tb * R + tc;
      t[ta][tb] = (i < p && k <= i) ? S[k * ld + i] : T(0);
    }
  }
#pragma unroll
  for (int tb = 0; tb < TR; ++tb) {
    const int k = tb * R + tc;
    dg[tb] = k < p ? S[k * ld + k] : T(1);
  }
  __syncthreads();  // column 0 of L overwrites the tile

  const int last = p - 1;
#pragma unroll
  for (int a0 = 0; a0 < TR; ++a0) {
    auto store_column = [&](int col) {
      const T d = dg[a0];
      if (tr == 0 && !(d > T(0))) atomicMin(fail, col);
      const T ljj = d_sqrt(d);
      const T y = T(1) / ljj;
#pragma unroll
      for (int ta = a0; ta < TR; ++ta) {
        const int i = ta * R + tr;
        if (i < p) S[col * ld + i] = i == col ? ljj
                                              : div_rcp(t[ta][a0], ljj, y);
      }
    };
#pragma unroll 1
    for (int jj = 0; jj < R; ++jj) {
      const int j = a0 * R + jj;
      if (j >= p) break;
      if (jj == 0 && tc == 0) store_column(j);
      __syncthreads();
      T ci[TR], ck[TR];
#pragma unroll
      for (int ta = a0; ta < TR; ++ta) {
        ci[ta] = S[j * ld + min(ta * R + tr, last)];
        ck[ta] = S[j * ld + min(ta * R + tc, last)];
      }
#pragma unroll
      for (int ta = a0; ta < TR; ++ta) {
        t[ta][a0] = fma_(-ci[ta], ck[a0], t[ta][a0]);
      }
      dg[a0] = fma_(-ck[a0], ck[a0], dg[a0]);
      if (tc == jj + 1 && j + 1 < p) store_column(j + 1);
#pragma unroll
      for (int ta = a0 + 1; ta < TR; ++ta) {
#pragma unroll
        for (int tb = a0 + 1; tb <= ta; ++tb) {
          t[ta][tb] = fma_(-ci[ta], ck[tb], t[ta][tb]);
        }
        dg[ta] = fma_(-ck[ta], ck[ta], dg[ta]);
      }
    }
  }
  // The last step's barrier made every column visible, and fail final.
  return *fail;
}

// Pass 1: A (lanes x n x n, row stride lda, lane stride sa, the lower
// triangle read) times the Jacobi scale, ((A_ij d_i) d_j) where dscale is
// given, into the column-major factor buffer l, zeros above the diagonal;
// a CTA an (nb x nb block, lane), lanes fastest.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* __restrict__ a, int64_t lda, int64_t sa,
             const T* __restrict__ dscale, T* __restrict__ l, int64_t n,
             int lanes, int nblocks) {
  constexpr int LDS = NB + 1;  // odd: the transposing writes miss no bank
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x % lanes;
  const int t = blockIdx.x / lanes;
  const int I = t / nblocks;
  const int J = t - I * nblocks;
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(I) * NB;
  const int64_t col0 = static_cast<int64_t>(J) * NB;
  const int rows = extent(n, row0, NB);
  const int cols = extent(n, col0, NB);
  T* out = l + b * n * n + col0 * n + row0;  // (i, j) at out[j n + i]
  if (I < J) {
    for (int idx = tid; idx < NB * NB; idx += kThreads) {
      const int j = idx / NB;
      const int i = idx - j * NB;
      if (i < rows && j < cols) out[j * n + i] = T(0);
    }
    return;
  }
  const T* src = a + b * sa + row0 * lda + col0;  // (i, j) at src[i lda + j]
  for (int idx = tid; idx < NB * NB; idx += kThreads) {
    const int i = idx / NB;
    const int j = idx - i * NB;
    cp_async(S + j * LDS + i, src + min(i, rows - 1) * lda + min(j, cols - 1),
             i < rows && j < cols);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const T* d = dscale == nullptr ? nullptr : dscale + b * n;
  for (int idx = tid; idx < NB * NB; idx += kThreads) {
    const int j = idx / NB;
    const int i = idx - j * NB;
    if (i < rows && j < cols) {
      T v = S[j * LDS + i];
      if (d != nullptr) v = (v * d[row0 + i]) * d[col0 + j];
      out[j * n + i] = (I > J || i >= j) ? v : T(0);
    }
  }
}

// The first diagonal block of every lane (a CTA a lane): staged lower
// triangle into shared memory, factored, written back; sets info.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
diag_kernel(T* __restrict__ l, int* __restrict__ info, int64_t n) {
  constexpr int LDS = NB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  __shared__ int fail;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int p = extent(n, 0, NB);
  T* lb = l + b * n * n;
  for (int idx = tid; idx < NB * NB; idx += kThreads) {
    const int j = idx / NB;
    const int i = idx - j * NB;
    if (i < p && j <= i) cp_async(S + j * LDS + i, lb + j * n + i, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int f = factor_tile<T, NB>(S, LDS, p, &fail);
  if (tid == 0) info[b] = f < p ? f + 1 : 0;
  for (int idx = tid; idx < NB * NB; idx += kThreads) {
    const int j = idx / NB;
    const int i = idx - j * NB;
    if (i < p && j <= i) lb[j * n + i] = S[j * LDS + i];
  }
}

// Step K's panel: L_IK = A_IK L_KK^-T for the block row I = K + 1 + q of
// lane b (a CTA a (lane, q), lanes fastest), in blocks of SB columns, with
// the tile X and L_KK in shared memory.  Block c0: a thread a row solves
// its row's SB unknowns against L_KK's SB x SB diagonal block by
// substitution (no barrier between columns; the division is div_rcp,
// correctly rounded, from L_KK's diagonal reciprocals taken once); then
// the columns right of the block take their products from it, each
// thread four rows and a share of the columns; two barriers a block.
constexpr int SB = 16;

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
panel_kernel(T* __restrict__ l, int64_t n, int lanes, int K) {
  constexpr int LDX = NB + 4;          // the tile, column-major
  constexpr int RG = NB / 4;           // groups of four rows
  constexpr int CL = kThreads / RG;    // columns updated side by side
  static_assert(NB <= kThreads && NB % SB == 0, "a thread a row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);  // NB x LDX
  T* Ls = X + NB * LDX;                    // L_KK, column-major, ld NB
  T* rd = Ls + NB * NB;                    // 1 / L_jj
  const int b = blockIdx.x % lanes;
  const int q = blockIdx.x / lanes;
  const int tid = threadIdx.x;
  const int64_t k0 = static_cast<int64_t>(K) * NB;
  const int64_t row0 = k0 + static_cast<int64_t>(q + 1) * NB;
  const int rows = extent(n, row0, NB);
  T* lb = l + b * n * n;
  const T* lkk = lb + k0 * n + k0;  // L_KK (r, c) at lkk[c n + r]
  T* x = lb + k0 * n + row0;        // the tile's (i, c) at x[c n + i]

  for (int idx = tid; idx < NB * NB; idx += kThreads) {
    const int c = idx / NB;
    const int r = idx - c * NB;
    if (r >= c) cp_async(Ls + c * NB + r, lkk + c * n + r, true);
    cp_async(X + c * LDX + r, x + c * n + min(r, rows - 1), r < rows);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid < NB) rd[tid] = T(1) / Ls[tid * NB + tid];
  __syncthreads();

  const int rg = tid % RG;
  const int cg = tid / RG;
#pragma unroll 1
  for (int c0 = 0; c0 < NB; c0 += SB) {
    if (tid < NB) {
      T v[SB];
#pragma unroll
      for (int k = 0; k < SB; ++k) v[k] = X[(c0 + k) * LDX + tid];
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        const T* lk = Ls + (c0 + k) * NB + c0;  // column c0 + k of L_KK
        v[k] = div_rcp(v[k], lk[k], rd[c0 + k]);
#pragma unroll
        for (int k2 = k + 1; k2 < SB; ++k2) v[k2] = fma_(-v[k], lk[k2], v[k2]);
      }
#pragma unroll
      for (int k = 0; k < SB; ++k) X[(c0 + k) * LDX + tid] = v[k];
    }
    __syncthreads();
    if (c0 + SB < NB) {
      T xr[SB][4];
#pragma unroll
      for (int k = 0; k < SB; ++k) load4(xr[k], X + (c0 + k) * LDX + 4 * rg);
#pragma unroll 1
      for (int c = c0 + SB + cg; c < NB; c += CL) {
        T acc[4];
        load4(acc, X + c * LDX + 4 * rg);
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          const T lck = Ls[(c0 + k) * NB + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r] = fma_(-xr[k][r], lck, acc[r]);
        }
        store4(X + c * LDX + 4 * rg, acc);
      }
      __syncthreads();
    }
  }
  for (int idx = tid; idx < NB * NB; idx += kThreads) {
    const int c = idx / NB;
    const int r = idx - c * NB;
    if (r < rows) x[c * n + r] = X[c * LDX + r];
  }
}

// A_IJ -= sum over the panels K0 .. K0 + depth - 1 of L_IK L_JK^T, a CTA a
// (lane, tile), lanes fastest, over the lower tiles I >= J >= F of the
// grid's first block columns from F, in column-major order from tile 0,
// (F, F).  Thread (ty, tx) accumulates
// rows 64 g + 4 tx + r and columns 64 h + 4 ty + c (TM = NB / R of each)
// over the k-panels, staged STAGES deep by cp.async; C is prefetched into
// L2 at the start and copied into shared memory (column-major, ld NB + 4:
// the thread's four rows are one aligned vector) during the last
// iterations, so that both its read and its write are whole columns.  A
// diagonal tile writes its lower triangle only; with diag, tile 0 then
// factors itself (the next panel's diagonal block).
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 2)
update_kernel(T* __restrict__ l, int* __restrict__ info, int64_t n,
              int lanes, int K0, int depth, int F, int diag, int nblocks) {
  constexpr int TM = NB / R;
  constexpr int G = TM / 4;
  constexpr int LDC = NB + 4;
  static_assert(TM % 4 == 0, "a thread's rows come in vectors of four");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // STAGES x BK x NB
  T* Bs = As + STAGES * BK * NB;
  T* Cs = Bs + STAGES * BK * NB;           // NB x LDC
  __shared__ int fail;

  const int b = blockIdx.x % lanes;
  int t = blockIdx.x / lanes;
  const int m = nblocks - F;  // block rows from F
  int jj = 0;
  while (t >= m - jj) {
    t -= m - jj;
    ++jj;
  }
  const int ii = jj + t;
  const int tid = threadIdx.x;
  const int r0 = 4 * (tid % R);  // the thread's first row
  const int c0 = 4 * (tid / R);  // and column
  constexpr int RS = 64, CS = 64;  // between its groups of four
  const int64_t k0 = static_cast<int64_t>(K0) * NB;
  const int64_t row0 = static_cast<int64_t>(F + ii) * NB;
  const int64_t col0 = static_cast<int64_t>(F + jj) * NB;
  const int rows = extent(n, row0, NB);
  const int cols = extent(n, col0, NB);
  const int KT = depth * (NB / BK);
  T* lb = l + b * n * n;
  const T* pa = lb + k0 * n + row0;  // L_IK (i, k) at pa[k n + i]
  const T* pb = lb + k0 * n + col0;  // L_JK (j, k) at pb[k n + j]
  T* c = lb + col0 * n + row0;       // A_IJ (i, j) at c[j n + i]

  {  // C into L2 while the product runs
    constexpr int SEG = 128 / sizeof(T);
    constexpr int LINES = NB / SEG + 1;
    for (int idx = tid; idx < cols * LINES; idx += kThreads) {
      const int j = idx / LINES;
      const int s = idx - j * LINES;
      prefetch_l2(c + j * n + min(s * SEG, rows - 1));
    }
  }

  auto load_stage = [&](int kt, int s) {
    T* as = As + s * BK * NB;
    T* bs = Bs + s * BK * NB;
#pragma unroll
    for (int e = 0; e < BK * NB / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int k = idx / NB;
      const int i = idx - k * NB;
      const int64_t kk = static_cast<int64_t>(kt * BK + k) * n;
      cp_async(as + k * NB + i, pa + kk + min(i, rows - 1), i < rows);
      cp_async(bs + k * NB + i, pb + kk + min(i, cols - 1), i < cols);
    }
  };

  T acc[TM][TM];
#pragma unroll
  for (int x = 0; x < TM; ++x) {
#pragma unroll
    for (int y = 0; y < TM; ++y) acc[x][y] = T(0);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) {
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    }
    if (kt == KT - STAGES + 1) {  // waited for only after the last stage
      for (int idx = tid; idx < NB * NB; idx += kThreads) {
        const int j = idx / NB;
        const int i = idx - j * NB;
        cp_async(Cs + j * LDC + i, c + min(j, cols - 1) * n + min(i, rows - 1),
                 i < rows && j < cols);
      }
    }
    cp_async_commit();
    const T* as = As + (kt % STAGES) * BK * NB;
    const T* bs = Bs + (kt % STAGES) * BK * NB;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T av[TM], bv[TM];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        load4(av + 4 * g, as + k * NB + RS * g + r0);
        load4(bv + 4 * g, bs + k * NB + CS * g + c0);
      }
#pragma unroll
      for (int x = 0; x < TM; ++x) {
#pragma unroll
        for (int y = 0; y < TM; ++y) acc[x][y] = fma_(av[x], bv[y], acc[x][y]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = CS * h + c0 + cc;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        T v[4];
        T* p = Cs + j * LDC + RS * g + r0;
        load4(v, p);
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] -= acc[4 * g + r][4 * h + cc];
        store4(p, v);
      }
    }
  }
  __syncthreads();

  if (diag && ii == 0) {  // (F, F): the next panel's diagonal block
    const int f = factor_tile<T, NB>(Cs, LDC, rows, &fail);
    if (tid == 0 && f < rows && info[b] == 0) {
      info[b] = static_cast<int>(row0 + f + 1);
    }
  }
  const bool diagonal = ii == jj;
  for (int idx = tid; idx < NB * NB; idx += kThreads) {
    const int j = idx / NB;
    const int i = idx - j * NB;
    if (i < rows && j < cols && (!diagonal || i >= j)) {
      c[j * n + i] = Cs[j * LDC + i];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The lookahead's second stream (the device's highest priority, so that
// its CTAs take the SMs first as the wide update's CTAs retire) and its
// events, made at a host thread's first call on a device: calls from one
// thread are issued one after another and may share them, calls from two
// threads never do.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork, panels, wide[2];
};

inline int side_stream(Side** out) {
  static thread_local Side sides[64];
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  Side& s = sides[dev];
  if (s.stream == nullptr) {
    int least = 0, greatest = 0;
    cudaStream_t made = nullptr;
    err = static_cast<int>(cudaDeviceGetStreamPriorityRange(&least,
                                                            &greatest));
    for (cudaEvent_t* e : {&s.fork, &s.panels, &s.wide[0], &s.wide[1]}) {
      if (err == 0) {
        err = static_cast<int>(
            cudaEventCreateWithFlags(e, cudaEventDisableTiming));
      }
    }
    if (err == 0) {
      err = static_cast<int>(cudaStreamCreateWithPriority(
          &made, cudaStreamNonBlocking, greatest));
    }
    if (err != 0) return err;
    s.stream = made;
  }
  *out = &s;
  return 0;
}

// Every launch of one factorisation: the staging pass, the factor of block
// 0, then the blocks in groups of `group`; group j starts at block s_j =
// j group.  On the side stream, group j's chain: for each block c of the
// group, the update of block column c by the group's panels before c,
// whose CTA of (c, c) factors that block, then the panel of c; then the
// near update: group j + 1's block columns by group j's panels at once
// (depth group nb), whose first CTA factors block s_{j+1}.  On the
// caller's stream, once group j's panels are out, the far update of the
// lower tiles from block s_{j+2} by the same panels.  So the next group's
// columns are brought up to date in one launch, and the chain of group
// j + 1 runs beside group j's far update; group j + 1's near update waits
// for it.  2 nblocks launches, and a far update for each group but the
// last two.
template <typename T, int NB>
int factor(const T* a, int64_t lda, int64_t sa, const T* dscale, T* l,
           int* info, int64_t lanes, int64_t n, int group, int* kernels,
           cudaStream_t stream) {
  const int nblocks = static_cast<int>((n + NB - 1) / NB);
  const size_t stage_smem = sizeof(T) * NB * (NB + 1);
  const size_t panel_smem = sizeof(T) * (NB * (NB + 4) + NB * NB + NB);
  const size_t update_smem =
      sizeof(T) * (2 * STAGES * BK * NB + NB * (NB + 4));
  int err = set_smem(stage_kernel<T, NB>, stage_smem);
  if (err == 0) err = set_smem(diag_kernel<T, NB>, stage_smem);
  if (err == 0) err = set_smem(panel_kernel<T, NB>, panel_smem);
  if (err == 0) err = set_smem(update_kernel<T, NB>, update_smem);
  Side* side = nullptr;
  if (err == 0) err = side_stream(&side);
  if (err != 0) return err;
  cudaStream_t chain = side->stream;
  const int nl = static_cast<int>(lanes);
  auto grid = [&](int64_t ctas) {
    return static_cast<unsigned int>(lanes * ctas);
  };
  auto start = [&](int j) {
    return j * group < nblocks ? j * group : nblocks;
  };
  auto launched = [&]() {
    const int e = static_cast<int>(cudaGetLastError());
    *kernels += e == 0;
    return e;
  };
  stage_kernel<T, NB><<<grid(int64_t(nblocks) * nblocks), kThreads,
                        stage_smem, stream>>>(a, lda, sa, dscale, l, n, nl,
                                              nblocks);
  err = launched();
  if (err == 0) {
    diag_kernel<T, NB><<<grid(1), kThreads, stage_smem, stream>>>(l, info,
                                                                  n);
    err = launched();
  }
  if (err == 0) err = static_cast<int>(cudaEventRecord(side->fork, stream));
  if (err == 0) {
    err = static_cast<int>(cudaStreamWaitEvent(chain, side->fork, 0));
  }
  for (int j = 0; err == 0 && start(j) < nblocks; ++j) {
    const int s0 = start(j), s1 = start(j + 1), s2 = start(j + 2);
    for (int c = s0; err == 0 && c < s1; ++c) {
      if (c > s0) {
        update_kernel<T, NB><<<grid(nblocks - c), kThreads, update_smem,
                               chain>>>(l, info, n, nl, s0, c - s0, c, 1,
                                        nblocks);
        err = launched();
      }
      if (err == 0 && c + 1 < nblocks) {
        panel_kernel<T, NB><<<grid(nblocks - 1 - c), kThreads, panel_smem,
                              chain>>>(l, n, nl, c);
        err = launched();
      }
    }
    if (err == 0) err = static_cast<int>(cudaEventRecord(side->panels, chain));
    if (err == 0) {
      err = static_cast<int>(cudaStreamWaitEvent(stream, side->panels, 0));
    }
    if (err == 0 && s1 < nblocks) {
      if (j >= 1) {  // the previous far update reached these columns
        err = static_cast<int>(
            cudaStreamWaitEvent(chain, side->wide[(j - 1) % 2], 0));
      }
      const int64_t m = nblocks - s1, w = s2 - s1;
      if (err == 0) {
        update_kernel<T, NB><<<grid(w * m - w * (w - 1) / 2), kThreads,
                               update_smem, chain>>>(l, info, n, nl, s0,
                                                     s1 - s0, s1, 1,
                                                     nblocks);
        err = launched();
      }
    }
    if (err == 0 && s2 < nblocks) {
      const int64_t m = nblocks - s2;
      update_kernel<T, NB><<<grid(m * (m + 1) / 2), kThreads, update_smem,
                             stream>>>(l, info, n, nl, s0, s1 - s0, s2, 0,
                                       nblocks);
      err = launched();
    }
    if (err == 0) {
      err = static_cast<int>(cudaEventRecord(side->wide[j % 2], stream));
    }
  }
  // The caller's stream waits for the chain's last work (the fork event,
  // waited on above, is recorded again).
  if (err == 0) err = static_cast<int>(cudaEventRecord(side->fork, chain));
  if (err == 0) {
    err = static_cast<int>(cudaStreamWaitEvent(stream, side->fork, 0));
  }
  return err;
}

// Block widths: 128 and 64 in float32, 64 in float64 (a thread's register
// tile of 8 x 8 doubles would not leave the product two CTAs an SM).
// *kernels is set to the number of device kernels launched.
template <typename T>
int stack_cholesky(const void* a, int64_t lda, int64_t sa,
                   const void* dscale, void* l, void* info, int64_t lanes,
                   int64_t n, int nb, int group, int* kernels,
                   void* stream) {
  *kernels = 0;
  if (lanes < 0 || n < 0 || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lanes == 0 || n == 0) return 0;
  const T* at = static_cast<const T*>(a);
  const T* dt = static_cast<const T*>(dscale);
  T* lt = static_cast<T*>(l);
  int* it = static_cast<int*>(info);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb == 64) {
    return factor<T, 64>(at, lda, sa, dt, lt, it, lanes, n, group, kernels,
                          s);
  }
  if constexpr (sizeof(T) == 4) {
    if (nb == 128) {
      return factor<T, 128>(at, lda, sa, dt, lt, it, lanes, n, group,
                             kernels, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace stack_chol
}  // namespace slam

extern "C" {

int slam_stack_cholesky_f32(const void* a, int64_t lda, int64_t sa,
                            const void* dscale, void* l, void* info,
                            int64_t lanes, int64_t n, int nb, int group,
                            int* kernels, void* stream) {
  return slam::stack_chol::stack_cholesky<float>(a, lda, sa, dscale, l, info,
                                                 lanes, n, nb, group, kernels,
                                                 stream);
}

int slam_stack_cholesky_f64(const void* a, int64_t lda, int64_t sa,
                            const void* dscale, void* l, void* info,
                            int64_t lanes, int64_t n, int nb, int group,
                            int* kernels, void* stream) {
  return slam::stack_chol::stack_cholesky<double>(a, lda, sa, dscale, l,
                                                  info, lanes, n, nb, group,
                                                  kernels, stream);
}

}  // extern "C"
