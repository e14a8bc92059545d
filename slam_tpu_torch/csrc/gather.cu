// Row gather and deterministic CSR segment sum.
//
// Replaces slam_tpu/ops/pallas_gather.py: gather_rows (_gather_kernel) and
// scatter_add_rows (_scatter_kernel).  The TPU kernels walk their rows in a
// sequential grid, the scatter carrying one output block in VMEM from step
// to step.  Blocks on this card run in no order, so the scatter is turned
// around: the host sorts the static topology once (segment_plan: a stable
// permutation plus n+1 offsets), and each output element owns its segment
// and sums it in that fixed order.  No float atomics, so the result is the
// same bit for bit from run to run -- the rescue's psi cuts downstream are
// thresholds.
//
// Bound: both are pure data movement, a few bytes per element (index plus
// value reads, one write), far below the card's bandwidth at pose-graph
// sizes; at INTEL scale they are launch-bound.  One thread per output
// element with the column fastest keeps neighbouring threads on
// neighbouring addresses.

#include "common.cuh"

namespace slam {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t rows,
                                   int64_t cols) {
  int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= rows * cols) return;
  int64_t r = t / cols;
  int64_t c = t - r * cols;
  out[t] = x[static_cast<int64_t>(idx[r]) * cols + c];
}

template <typename T>
__global__ void scatter_add_rows_kernel(const T* __restrict__ v,
                                        const int32_t* __restrict__ perm,
                                        const int32_t* __restrict__ offsets,
                                        T* __restrict__ out, int64_t n,
                                        int64_t cols) {
  int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n * cols) return;
  int64_t s = t / cols;
  int64_t c = t - s * cols;
  T acc = T(0);
  for (int32_t p = offsets[s]; p < offsets[s + 1]; ++p) {
    acc += v[static_cast<int64_t>(perm[p]) * cols + c];
  }
  out[t] = acc;
}

template <typename T>
int gather_rows(const void* x, const void* idx, void* out, int64_t rows,
                int64_t cols, void* stream) {
  int64_t work = rows * cols;
  if (work > 0) {
    gather_rows_kernel<T><<<grid_for(work), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(idx),
        static_cast<T*>(out), rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter_add_rows(const void* v, const void* perm, const void* offsets,
                     void* out, int64_t n, int64_t cols, void* stream) {
  int64_t work = n * cols;
  if (work > 0) {
    scatter_add_rows_kernel<T><<<grid_for(work), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(offsets), static_cast<T*>(out), n, cols);
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

int slam_scatter_add_rows_f32(const void* v, const void* perm,
                              const void* offsets, void* out, int64_t n,
                              int64_t cols, void* stream) {
  return slam::scatter_add_rows<float>(v, perm, offsets, out, n, cols, stream);
}

int slam_scatter_add_rows_f64(const void* v, const void* perm,
                              const void* offsets, void* out, int64_t n,
                              int64_t cols, void* stream) {
  return slam::scatter_add_rows<double>(v, perm, offsets, out, n, cols,
                                        stream);
}

}  // extern "C"
