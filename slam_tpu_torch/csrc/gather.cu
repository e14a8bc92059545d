// Row gather and deterministic, grouped segment sum.
//
// Replaces slam_tpu/ops/pallas_gather.py: gather_rows (_gather_kernel) and
// scatter_add_rows (_scatter_kernel).  The TPU kernels walk their rows in a
// sequential grid, the scatter carrying one output block in VMEM from step
// to step.  Blocks on this card run in no order, so the scatter is turned
// around: the host sorts the static topology once (segment_plan: a stable
// permutation, and the bounds of the non-empty segments in it), and each
// output element owns its segment and sums it in that fixed order.  No
// float atomics and no tree, so the result is the same bit for bit from
// run to run -- the rescue's psi cuts downstream are thresholds.
//
// Bound: both are pure data movement, a few bytes per element; at
// pose-graph sizes a launch is a few microseconds of device work, so the
// design cuts launches and threads rather than chasing bandwidth:
// - one launch sums up to kMaxGroups (values, plan, output) groups, their
//   descriptors passed by value as a kernel parameter (no copy to the
//   device per call); the C entry zero-fills the outputs with one
//   cudaMemsetAsync on the same stream first, when a work list leaves
//   some segment out;
// - threads go to (listed segment, column) only, the column fastest so a
//   warp reads neighbouring bytes of a source row.  A plan lists its
//   non-empty segments, so an empty one costs nothing but its share of
//   the memset (the Schur block grids are 98% empty at M10000); a plan
//   whose segments are at least half non-empty lists them all, each
//   empty one writing its zeros, and needs no memset;
// - each segment's output lands where its caller wants it: segment s of a
//   grid of `cols` block columns is block (s / cols, s % cols), column k of
//   the segment entry (k / w, k % w) of that block, row stride `ld`; a
//   flat plan is cols = 1, w = K.  So the blocks land straight in the
//   row-major matrices and no permuting copy follows.  Offsets are int64;
//   all other index arithmetic is int32 (no 64-bit division).

#include "common.cuh"

namespace slam {

constexpr int kMaxGroups = 8;
constexpr int kDescWords = 10;  // int64 words of one group's descriptor

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, int32_t rows,
                                   int32_t cols) {
  int32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * cols) return;
  int32_t r = t / cols;
  int32_t c = t - r * cols;
  out[t] = x[static_cast<int64_t>(idx[r]) * cols + c];
}

template <typename T>
struct ScatterGroup {
  const T* v;              // source rows of K columns
  const int32_t* rows;     // the plan's source rows, segment by segment
  const int32_t* starts;   // (m+1) bounds in rows of the non-empty segments
  const int32_t* seg;      // (m) their segment ids
  T* out;
  int64_t ld;              // row stride of the output
  int32_t m, K, cols, w, h;
  int32_t first_block;     // first CTA of this group
};

template <typename T>
struct ScatterGroups {
  ScatterGroup<T> g[kMaxGroups];
  int32_t count;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(const __grid_constant__ ScatterGroups<T> p) {
  int gi = 0;
  while (gi + 1 < p.count && static_cast<int32_t>(blockIdx.x) >=
                                 p.g[gi + 1].first_block) {
    ++gi;
  }
  const ScatterGroup<T>& g = p.g[gi];
  int32_t t = (static_cast<int32_t>(blockIdx.x) - g.first_block) * kThreads +
              threadIdx.x;
  int32_t q = t / g.K;
  if (q >= g.m) return;
  int32_t k = t - q * g.K;
  T acc = T(0);
  for (int32_t r = g.starts[q]; r < g.starts[q + 1]; ++r) {
    acc += g.v[static_cast<int64_t>(g.rows[r]) * g.K + k];
  }
  int32_t s = g.seg[q];
  int32_t br = s / g.cols;
  int32_t bc = s - br * g.cols;
  int32_t i = k / g.w;
  int32_t j = k - i * g.w;
  g.out[(static_cast<int64_t>(br) * g.h + i) * g.ld +
        static_cast<int64_t>(bc) * g.w + j] = acc;
}

template <typename T>
int gather_rows(const void* x, const void* idx, void* out, int64_t rows,
                int64_t cols, void* stream) {
  int64_t work = rows * cols;
  if (work >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (work > 0) {
    gather_rows_kernel<T><<<grid_for(work), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(idx),
        static_cast<T*>(out), static_cast<int32_t>(rows),
        static_cast<int32_t>(cols));
  }
  return static_cast<int>(cudaGetLastError());
}

// desc: count groups of kDescWords int64 -- v, rows, starts, seg, out
// (addresses), m, K, cols, w, ld.  zero/zero_bytes: the range to clear
// before the sums (zero_bytes 0: none).
template <typename T>
int scatter_add_rows(const int64_t* desc, int32_t count, void* zero,
                     int64_t zero_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count < 0 || count > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (zero_bytes > 0) {
    cudaError_t rc = cudaMemsetAsync(zero, 0, zero_bytes, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  ScatterGroups<T> p{};
  int64_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t* d = desc + i * kDescWords;
    int64_t m = d[5], K = d[6], cols = d[7], w = d[8];
    if (m <= 0) continue;  // nothing to sum; the memset did the rest
    if (K <= 0 || w <= 0 || K % w != 0 || cols <= 0 ||
        m * K >= INT32_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ScatterGroup<T>& g = p.g[p.count++];
    g.v = reinterpret_cast<const T*>(d[0]);
    g.rows = reinterpret_cast<const int32_t*>(d[1]);
    g.starts = reinterpret_cast<const int32_t*>(d[2]);
    g.seg = reinterpret_cast<const int32_t*>(d[3]);
    g.out = reinterpret_cast<T*>(d[4]);
    g.m = static_cast<int32_t>(m);
    g.K = static_cast<int32_t>(K);
    g.cols = static_cast<int32_t>(cols);
    g.w = static_cast<int32_t>(w);
    g.h = static_cast<int32_t>(K / w);
    g.ld = d[9];
    g.first_block = static_cast<int32_t>(blocks);
    blocks += grid_for(m * K);
  }
  if (blocks >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    scatter_add_rows_kernel<T>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

extern "C" {

int slam_gather_rows_f32(const void* x, const void* idx, void* out,
                         int64_t rows, int64_t cols, void* stream) {
  return slam::gather_rows<float>(x, idx, out, rows, cols, stream);
}

int slam_gather_rows_f64(const void* x, const void* idx, void* out,
                         int64_t rows, int64_t cols, void* stream) {
  return slam::gather_rows<double>(x, idx, out, rows, cols, stream);
}

int slam_scatter_add_rows_f32(const int64_t* desc, int32_t count, void* zero,
                              int64_t zero_bytes, void* stream) {
  return slam::scatter_add_rows<float>(desc, count, zero, zero_bytes, stream);
}

int slam_scatter_add_rows_f64(const int64_t* desc, int32_t count, void* zero,
                              int64_t zero_bytes, void* stream) {
  return slam::scatter_add_rows<double>(desc, count, zero, zero_bytes,
                                        stream);
}

}  // extern "C"
