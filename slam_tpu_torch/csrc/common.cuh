// Shared helpers for the slam_tpu_torch kernels: dtype-overloaded device
// math and the launch geometry.  Every C entry point returns
// cudaGetLastError() right after its launch, so a refused launch reaches
// the Python wrapper as a nonzero code.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slam {

constexpr int kThreads = 256;

inline unsigned int grid_for(int64_t work) {
  return static_cast<unsigned int>((work + kThreads - 1) / kThreads);
}

__device__ __forceinline__ float d_sin(float x) { return sinf(x); }
__device__ __forceinline__ double d_sin(double x) { return sin(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_asin(float x) { return asinf(x); }
__device__ __forceinline__ double d_asin(double x) { return asin(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }

}  // namespace slam
