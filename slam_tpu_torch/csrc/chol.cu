// Batched micro-panel Cholesky plus the explicit inverse of the factor.
//
// Replaces slam_tpu/ops/pallas_chol.py: micro_chol_inv (_kernel).  The TPU
// kernel puts the batch on the 128 lanes and walks the p columns of every
// matrix at once, as masked whole-tile reductions.  Here a matrix goes to
// one or a few CTAs on their own SMs.  The arithmetic is the TPU kernel's
// (and the plain PyTorch version's), with no fused multiply-add:
//   - column j of L is rsqrt(d_jj) times the column of the trailing matrix,
//     the diagonal included (so a non-SPD panel gives NaN, never a finite
//     value), followed by the right-looking update of rows and columns > j,
//     each a rounded product subtracted; element (i, k) takes its updates
//     in the order j = 0..k-1, so L is bitwise the plain version's;
//   - the inverse X = L^-1 by forward substitution,
//     X[i, c] = (delta_ic - sum_{c<=k<i} L[i, k] X[k, c]) / L[i, i], each
//     sum four partial sums, the one of residue r taking every k = r mod 4
//     in increasing k, added as ((s0 + s1) + s2) + s3: the order of
//     PyTorch's CUDA reduction of the plain version.
// The update is kept unfused on purpose: contracted to FMAs it gives another
// L, whose inverse's residual max|X L - I| on the trailing M10000 Schur
// panels was over twice the plain version's.  No tensor cores either: a
// float32 mma runs in TF32, which the port forbids and whose three digits
// the residual gate could not take; a float64 DMMA fuses multiply and add.
// Only the lower triangle of A is read, and the strict upper triangles of
// both outputs are written as zeros.
//
// Schedule.  The first version spent 2p barrier-separated steps on the
// factor, each a read-modify-write of the whole trailing triangle in shared
// memory, and 2p more on a row-by-row inverse.  Here:
//   - the panel is staged into shared memory with cp.async, then each of the
//     R x R = 256 threads of the factor holds its elements of the lower
//     triangle in registers, rows i = a R + tr and columns k = b R + tc
//     (a >= b, a register tile of TR x TR blocks, p <= TR R); the tile's
//     block rows and columns < a0 are left out at compile time once j passes
//     a0 R, so the work per step shrinks with the trailing triangle;
//   - step j: one barrier after column j of L is in shared memory; every
//     thread reads the column at its rows and columns and updates its
//     elements in registers, block column a0 first, so that the threads of
//     column j + 1 (each keeps its own copy of its columns' diagonals) scale
//     and store it while the rest of the update goes on.  One barrier per
//     column, no shared-memory read-modify-write, and the next column's
//     rsqrt and stores off the barrier-to-barrier path;
//   - the inverse is right-looking and column-parallel with no CTA-wide
//     barrier: a warp per column, a lane per row (and the next rows 32
//     apart); each step finishes one row on its lane, hands X to the warp
//     with one shuffle and adds the products into the rows below, so the
//     chain from row to row is a product, the four-way sum, the division
//     and the shuffle (inverse_column).  Columns c and p - 1 - c go to one
//     warp, so each warp walks p + 1 rows;
//   - the launch shape comes from the caller (ops/chol.py::schedule, from
//     the batch m, p, the dtype and the SM count).  While 4 m is at most
//     the SM count (B4's 16 and 32 panels on the H100), one launch: several
//     CTAs per matrix (blockIdx.y), each factoring the whole matrix, then
//     writing its share of the rows of L and inverting its share of the
//     column pairs; 512 threads where their registers hold the tile (p <=
//     128 in float32, 64 in float64; 16 warps for the inverse while the
//     factor runs on the first 256), else 256; 4 CTAs per matrix while
//     4 m fits the SMs, else 2 or 1, so that the grid runs in one wave: a
//     second wave would repeat the whole factor.  On the H100 at m = 16
//     and 32 and p = 128, 512 threads x 4 CTAs were the fastest of 256 or
//     512 threads x 1, 2 or 4 CTAs (PERF.md).  A thread-block cluster of 2
//     or 4 CTAs sharing one factor (each CTA a band of rows, column j
//     broadcast through distributed shared memory, a cluster barrier per
//     column) gave the same bits but took 2.0-2.7 times as long;
//   - the folded batches (m = 96 and 128 panels of 128: the rescue's six
//     chains and the seed batch's eight seeds, 16 interiors each) leave one
//     CTA per matrix, whose 16 warps (8 in float64) walked 4 (8) column
//     pairs each, one after another, while the factor cost what it costs
//     at 16 panels.  A second CTA per matrix cannot share the SM (512
//     threads x 128 registers fill it).  So past 4 m > SMs (p <= 128) the
//     schedule splits: the factor runs on one CTA of 256 threads per
//     matrix (INV false) and writes L; a second launch,
//     micro_chol_inverse_kernel, stages L's lower triangle back from L2
//     into shared memory and inverts on 1024-thread CTAs (at most 64
//     registers a thread, one CTA an SM), as many per matrix as one wave
//     holds and the pairs can use: each warp walks at most 2 pairs (1 at
//     m <= SMs / 2), 8 warps a scheduler, each column on the fewest
//     register rows that cover it and with no predicate on its updates.
//     Each step's division, which every lane of the warp issues, is
//     div_rcp: the reciprocal of each row's diagonal once, then a product
//     and two FMAs, the same quotient to the bit.  On the H100 the
//     division was the largest part of the inverse (and its slow-path
//     check made real panels twice as slow as SPD ones), the shuffle and
//     the loads each a tenth or so; spreading the SM's 64 pair chains over
//     8 warps a scheduler instead of 4 gained little by itself: the
//     inverse is bound by the SM's issue (PERF.md).  Tried and not kept:
//     a left-looking inverse, a warp per block of 8 columns (a lane per
//     column and residue, each of the four partial sums of X[i, c] summed
//     in a lane), in one launch with the factor: the same bits, but each
//     row of column 0's block is a chain of loads, sums, shuffles and a
//     division, 128 rows in a row, as slow as the pairs in float32.  Not
//     tried: one launch whose warps interleave two column chains, since
//     the pairs are short of issue, not of warps to hide latency.  The
//     arithmetic is the same, so L and the inverse are bitwise the single
//     launch's.
// Shared memory: the p x (p + 1) tile (odd row stride: column reads are free
// of bank conflicts) and a p-vector, 66,560 bytes at p = 128 in float32, so
// p reaches 240 (float32) or 169 (float64) within the 232,448 bytes a block
// may opt into, as before; the register tile covers those p with 256
// threads, and p <= 128 (float32) or 64 (float64) in the 128 registers a
// thread has with 512.
//
// Bound: a matrix needs about 2/3 p^3 flops and p (p + 1) / 2 + 2 p^2
// elements of traffic; at the Schur panels (p = 128, 16 to 128 matrices)
// the card could finish in a few microseconds.  The kernel is
// latency-bound: p barrier steps in the factor, whose issue the 256
// threads of one SM share, and, in the inverse, column 0's chain of p
// dependent rows; in the split inverse, each SM's issue of 64 pair chains
// of ~30 instructions a step.

#include "common.cuh"

namespace slam {

__device__ __forceinline__ float d_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double d_rsqrt(double x) { return rsqrt(x); }
// Rounded product and sum, never contracted into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
// 1 / x rounded to nearest.
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

// a / b rounded to nearest, from y = rcp_rn(b): q = RN(a y) is within an
// ulp of a / b, r = a - b q is exact in one FMA, and RN(q + r y) is the
// correctly rounded quotient (Markstein's theorem; no underflow or
// overflow on these panels: b is a Cholesky diagonal, a a sum of
// products of L and X).  So it equals a / b to the bit, with y computed
// once per row instead of a division per step.
template <typename T>
__device__ __forceinline__ T div_rcp(T a, T b, T y) {
  const T q = mul_rn(a, y);
  return fma_rn(fma_rn(-b, q, a), y, q);
}

// One element from global to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Column c of X = L^-1 by one warp, right-looking: rows i = c + j, the
// lane l owning j = l + 32 t.  At step j the lane of row j sums its four
// partial sums in residue order (residue of the absolute k, hence ROT = c
// mod 4) and divides; one shuffle hands X[c + j, c] to the warp, and every
// lane adds its product into the partial sum of residue (c + j) mod 4 of
// each of its rows below.  So each partial sum takes its terms in
// increasing k, and the chain from one row to the next is one product, the
// four-way sum, the division and the shuffle; the other rows' products are
// off it.  X[i, c] goes to the free upper triangle, transposed, the
// diagonal of X to xdiag.  With ALL, every lane adds its products into all
// its rows of blocks >= t, with no predicate: a row at or above step j, or
// past the column's end, takes products that nothing reads again (its sum
// was taken, or is never taken), so the rows below take exactly the same
// terms, in fewer instructions; and the division is div_rcp, the same
// quotient with the reciprocal of each row's diagonal taken once.
template <typename T, int RL, int ROT, bool ALL = false>
__device__ __forceinline__ void inverse_column(T* s, int ld, int p, int c,
                                               T* xdiag, int lane) {
  const int n = p - c;
  T acc[RL][4];
  T lii[RL];
  T rii[RL];    // ALL: rcp_rn(lii)
  int row[RL];  // offset of L[c + lane + 32 t, c] in the tile
#pragma unroll
  for (int t = 0; t < RL; ++t) {
    const int i = min(c + lane + 32 * t, p - 1);
    lii[t] = s[i * ld + i];
    if constexpr (ALL) rii[t] = rcp_rn(lii[t]);
    row[t] = i * ld + c;
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = T(0);
  }
#pragma unroll
  for (int t = 0; t < RL; ++t) {
    if (32 * t >= n) break;
    for (int m = 0; m < 8 && 32 * t + 4 * m < n; ++m) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int jj = 4 * m + rr;  // the lane of row j
        const int j = 32 * t + jj;
        const bool own = lane == jj;
        const T sum = add_rn(add_rn(add_rn(acc[t][(4 - ROT) & 3],
                                           acc[t][(5 - ROT) & 3]),
                                    acc[t][(6 - ROT) & 3]),
                             acc[t][(7 - ROT) & 3]);
        // Other lanes divide 1 by 1, so only the owner's division can take
        // the slow path.
        const T num = own ? (j == 0 ? T(1) : T(0)) - sum : T(1);
        const T den = own ? lii[t] : T(1);
        const T x = __shfl_sync(
            0xffffffffu,
            ALL ? div_rcp(num, den, own ? rii[t] : T(1)) : num / den, jj);
        if (own && j < n) {
          if (j == 0) {
            xdiag[c] = x;
          } else {
            s[c * ld + c + j] = x;
          }
        }
#pragma unroll
        for (int t2 = t; t2 < RL; ++t2) {
          const int j2 = lane + 32 * t2;
          if (ALL || ((t2 > t || lane > jj) && j2 < n)) {
            acc[t2][rr] = add_rn(acc[t2][rr], mul_rn(s[row[t2] + j], x));
          }
        }
      }
    }
  }
}

template <typename T, int RL>
__device__ __forceinline__ void invert_column(T* s, int ld, int p, int c,
                                              T* xdiag, int lane) {
  switch (c & 3) {
    case 0: inverse_column<T, RL, 0>(s, ld, p, c, xdiag, lane); break;
    case 1: inverse_column<T, RL, 1>(s, ld, p, c, xdiag, lane); break;
    case 2: inverse_column<T, RL, 2>(s, ld, p, c, xdiag, lane); break;
    default: inverse_column<T, RL, 3>(s, ld, p, c, xdiag, lane); break;
  }
}

// The factor's thread grid: kR x kR threads, the first kR^2 of the CTA.
constexpr int kR = 16;

// With INV false the kernel stops after writing L (the split schedule's
// first launch; micro_chol_inverse_kernel below inverts).
template <typename T, int TR, int NW, bool INV>
__global__ void __launch_bounds__(NW * 32)
micro_chol_inv_kernel(const T* __restrict__ a, T* __restrict__ l_out,
                      T* __restrict__ inv_out, int p) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // p rows of stride ld
  const int ld = p + 1;
  T* xdiag = s + p * ld;                  // the diagonal of X
  const int64_t base = static_cast<int64_t>(blockIdx.x) * p * p;
  const int slice = blockIdx.y;    // the CTA's share of the outputs
  const int slices = gridDim.y;
  constexpr int R = kR;
  const int tid = threadIdx.x;
  const bool fac = tid < R * R;    // a thread of the factor's grid
  const int tr = tid / R;
  const int tc = tid - tr * R;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = warp; i < p; i += NW) {
    const T* src = a + base + static_cast<int64_t>(i) * p;
    for (int c = lane; c <= i; c += 32) cp_async(s + i * ld + c, src + c);
  }
  cp_async_wait_all();
  __syncthreads();

  T t[TR][TR];  // t[a][b] = element (a R + tr, b R + tc), used for a >= b
  T dg[TR];     // dg[b] = diagonal element (b R + tc, b R + tc)
  if (fac) {
#pragma unroll
    for (int ta = 0; ta < TR; ++ta) {
      const int i = ta * R + tr;
#pragma unroll
      for (int tb = 0; tb <= ta; ++tb) {
        const int k = tb * R + tc;
        t[ta][tb] = (i < p && k <= i) ? s[i * ld + k] : T(0);
      }
    }
#pragma unroll
    for (int tb = 0; tb < TR; ++tb) {
      const int k = tb * R + tc;
      dg[tb] = k < p ? s[k * ld + k] : T(1);
    }
  }
  __syncthreads();  // column 0 of L overwrites the staged panel

  // A thread reads the column at all its rows and columns, clamped to row
  // p - 1: the values at rows and columns <= j (or beyond p) only reach
  // elements that are not live (above the diagonal, beyond p, or already
  // in L), which are never read again.  No predicate, so every load of a
  // step issues before the first use.
  const int last = (p - 1) * ld;
#pragma unroll
  for (int a0 = 0; a0 < TR; ++a0) {
    // The thread's elements of column col (in block column a0) times
    // rsqrt of its copy of the diagonal, stored as column col of L.
    auto store_column = [&](int col) {
      const T r = d_rsqrt(dg[a0]);
#pragma unroll
      for (int ta = a0; ta < TR; ++ta) {
        const int i = ta * R + tr;
        // Rows < col land in the upper triangle, unused until the inverse.
        if (i < p) s[i * ld + col] = t[ta][a0] * r;
      }
    };
    for (int jj = 0; jj < R; ++jj) {
      const int j = a0 * R + jj;
      if (j >= p) break;
      if (jj == 0 && fac && tc == 0) store_column(j);
      __syncthreads();
      if (fac) {
        T ci[TR], ck[TR];
#pragma unroll
        for (int ta = a0; ta < TR; ++ta) {
          ci[ta] = s[min((ta * R + tr) * ld, last) + j];
          ck[ta] = s[min((ta * R + tc) * ld, last) + j];
        }
        // Block column a0 first: it holds column j + 1, which its threads
        // then scale and store while the rest of the update goes on.
#pragma unroll
        for (int ta = a0; ta < TR; ++ta) {
          t[ta][a0] = add_rn(t[ta][a0], -mul_rn(ci[ta], ck[a0]));
        }
        dg[a0] = add_rn(dg[a0], -mul_rn(ck[a0], ck[a0]));
        if (tc == jj + 1 && j + 1 < p) store_column(j + 1);
#pragma unroll
        for (int ta = a0 + 1; ta < TR; ++ta) {
#pragma unroll
          for (int tb = a0 + 1; tb <= ta; ++tb) {
            t[ta][tb] = add_rn(t[ta][tb], -mul_rn(ci[ta], ck[tb]));
          }
          dg[ta] = add_rn(dg[ta], -mul_rn(ck[ta], ck[ta]));
        }
      }
    }
  }
  // The last step's barrier made every column of L visible.
  for (int i = warp * slices + slice; i < p; i += NW * slices) {
    T* dst = l_out + base + static_cast<int64_t>(i) * p;
    for (int c = lane; c < p; c += 32) dst[c] = c <= i ? s[i * ld + c] : T(0);
  }
  if constexpr (!INV) return;

  // The inverse: a warp per column pair (q, p - 1 - q), the pairs q of
  // this CTA's residue mod slices.  No barrier until the write-out.
  constexpr int RL = (TR * R + 31) / 32;
  for (int q = slice + slices * warp; 2 * q < p; q += slices * NW) {
    invert_column<T, RL>(s, ld, p, q, xdiag, lane);
    if (p - 1 - q != q) invert_column<T, RL>(s, ld, p, p - 1 - q, xdiag, lane);
  }
  __syncthreads();
  // The CTA writes the columns of its pairs (slices is a power of two).
  for (int i = warp; i < p; i += NW) {
    T* dst = inv_out + base + static_cast<int64_t>(i) * p;
    for (int c = lane; c < p; c += 32) {
      if (((c < p - 1 - c ? c : p - 1 - c) & (slices - 1)) != slice) continue;
      dst[c] = c < i ? s[c * ld + i] : (c == i ? xdiag[c] : T(0));
    }
  }
}

// The split schedule's inverse: the CTA stages L's lower triangle, written
// by the factor launch, back into shared memory, and its warps invert the
// column pairs q = slice + slices w + slices NW k, as the single launch's
// do, each column on the fewest register rows that cover it and with no
// predicate on its updates (the arithmetic, and so the bits, are the
// same).
template <typename T, int RL>
__device__ __forceinline__ void invert_column_fit(T* s, int ld, int p, int c,
                                                  T* xdiag, int lane) {
  const int need = (p - c + 31) / 32;
#define SLAM_FIT(R)                                                       \
  switch (c & 3) {                                                        \
    case 0: return inverse_column<T, R, 0, true>(s, ld, p, c, xdiag, lane); \
    case 1: return inverse_column<T, R, 1, true>(s, ld, p, c, xdiag, lane); \
    case 2: return inverse_column<T, R, 2, true>(s, ld, p, c, xdiag, lane); \
    default:                                                              \
      return inverse_column<T, R, 3, true>(s, ld, p, c, xdiag, lane);     \
  }
  if constexpr (RL >= 4) {
    if (need > 3) SLAM_FIT(4)
  }
  if constexpr (RL >= 3) {
    if (need > 2) SLAM_FIT(3)
  }
  if constexpr (RL >= 2) {
    if (need > 1) SLAM_FIT(2)
  }
  SLAM_FIT(1)
#undef SLAM_FIT
}

template <typename T, int RL, int NW>
__global__ void __launch_bounds__(NW * 32)
micro_chol_inverse_kernel(const T* __restrict__ l, T* __restrict__ inv_out,
                          int p) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ld = p + 1;
  T* xdiag = s + p * ld;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * p * p;
  const int slice = blockIdx.y;
  const int slices = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Column q's inverse reads rows and columns >= q of L; the CTA's first
  // column is its slice.
  for (int i = slice + warp; i < p; i += NW) {
    const T* src = l + base + static_cast<int64_t>(i) * p;
    for (int c = slice + lane; c <= i; c += 32) {
      cp_async(s + i * ld + c, src + c);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int q = slice + slices * warp; 2 * q < p; q += slices * NW) {
    invert_column_fit<T, RL>(s, ld, p, q, xdiag, lane);
    if (p - 1 - q != q) {
      invert_column_fit<T, RL>(s, ld, p, p - 1 - q, xdiag, lane);
    }
  }
  __syncthreads();
  for (int i = warp; i < p; i += NW) {
    T* dst = inv_out + base + static_cast<int64_t>(i) * p;
    for (int c = lane; c < p; c += 32) {
      if ((c < p - 1 - c ? c : p - 1 - c) % slices != slice) continue;
      dst[c] = c < i ? s[c * ld + i] : (c == i ? xdiag[c] : T(0));
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int TR, int NW, bool INV>
int launch_chol(const void* a, void* l_out, void* inv_out, int64_t m,
                int64_t p, int ctas, cudaStream_t stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(p * (p + 2));
  const int err = set_smem(micro_chol_inv_kernel<T, TR, NW, INV>, smem);
  if (err != 0) return err;
  micro_chol_inv_kernel<T, TR, NW, INV>
      <<<dim3(static_cast<unsigned int>(m), ctas), NW * 32, smem, stream>>>(
          static_cast<const T*>(a), static_cast<T*>(l_out),
          static_cast<T*>(inv_out), static_cast<int>(p));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RL, int NW>
int launch_inverse(const void* l, void* inv_out, int64_t m, int64_t p,
                   int ctas, cudaStream_t stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(p * (p + 2));
  const int err = set_smem(micro_chol_inverse_kernel<T, RL, NW>, smem);
  if (err != 0) return err;
  micro_chol_inverse_kernel<T, RL, NW>
      <<<dim3(static_cast<unsigned int>(m), ctas), NW * 32, smem, stream>>>(
          static_cast<const T*>(l), static_cast<T*>(inv_out),
          static_cast<int>(p));
  return static_cast<int>(cudaGetLastError());
}

// Largest register tile per type, with 256 threads: TR kR >= max_panel
// (240 in float32, 169 in float64).
template <typename T>
struct MaxTile {
  static constexpr int value = sizeof(T) == 4 ? 15 : 11;
};

// The launch shape comes from the caller (ops/chol.py::schedule), which
// knows the SM count; a shape with no compiled kernel is refused.
//   single: one launch of ctas CTAs a matrix (a power of two) of threads
//     threads, 512 where a thread's 128 registers hold the tile (p <= 128
//     in float32, 64 in float64), else 256;
//   split (p <= 128): the factor, ctas CTAs a matrix of 256 threads, then
//     the inverse, inverse_ctas CTAs a matrix of 1024 threads.
template <typename T>
int micro_chol_inv(const void* a, void* l_out, void* inv_out, int64_t m,
                   int64_t p, int ctas, int threads, int split,
                   int inverse_ctas, int inverse_threads, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (m < 0 || p < 0 || ctas < 1 || (ctas & (ctas - 1)) != 0) return invalid;
  if (m == 0 || p == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split) {
#define SLAM_CHOL(TR, NW)                                                 \
  return threads == NW * 32                                               \
             ? launch_chol<T, TR, NW, true>(a, l_out, inv_out, m, p, ctas, \
                                            s)                            \
             : invalid
    if (p <= 32) SLAM_CHOL(2, 16);
    if (p <= 64) SLAM_CHOL(4, 16);
    if (p <= 128) {
      if constexpr (sizeof(T) == 4) {
        SLAM_CHOL(8, 16);
      } else {
        SLAM_CHOL(8, 8);
      }
    }
    if (p <= kR * MaxTile<T>::value) SLAM_CHOL(MaxTile<T>::value, 8);
#undef SLAM_CHOL
    return invalid;
  }
  if (p > 128 || threads != 256 || inverse_threads != 1024 ||
      inverse_ctas < 1) {
    return invalid;
  }
  const int err =
      p <= 32   ? launch_chol<T, 2, 8, false>(a, l_out, inv_out, m, p, ctas, s)
      : p <= 64 ? launch_chol<T, 4, 8, false>(a, l_out, inv_out, m, p, ctas, s)
                : launch_chol<T, 8, 8, false>(a, l_out, inv_out, m, p, ctas,
                                              s);
  if (err != 0) return err;
  if (p <= 32) return launch_inverse<T, 1, 32>(l_out, inv_out, m, p,
                                                inverse_ctas, s);
  if (p <= 64) return launch_inverse<T, 2, 32>(l_out, inv_out, m, p,
                                                inverse_ctas, s);
  return launch_inverse<T, 4, 32>(l_out, inv_out, m, p, inverse_ctas, s);
}

}  // namespace slam

extern "C" {

int slam_micro_chol_inv_f32(const void* a, void* l_out, void* inv_out,
                            int64_t m, int64_t p, int ctas, int threads,
                            int split, int inverse_ctas, int inverse_threads,
                            void* stream) {
  return slam::micro_chol_inv<float>(a, l_out, inv_out, m, p, ctas, threads,
                                     split, inverse_ctas, inverse_threads,
                                     stream);
}

int slam_micro_chol_inv_f64(const void* a, void* l_out, void* inv_out,
                            int64_t m, int64_t p, int ctas, int threads,
                            int split, int inverse_ctas, int inverse_threads,
                            void* stream) {
  return slam::micro_chol_inv<double>(a, l_out, inv_out, m, p, ctas, threads,
                                      split, inverse_ctas, inverse_threads,
                                      stream);
}

}  // extern "C"
