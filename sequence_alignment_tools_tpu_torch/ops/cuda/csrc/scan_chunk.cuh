// Code shared by the scan kernels: the per-device launch configuration
// of every kernel that sizes a persistent grid.

#pragma once

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace sat {

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Per-device launch state of one kernel, so a launch costs no attribute or
// occupancy query once its shared-memory size has been seen on that device.
constexpr int kMaxDevices = 64;
struct LaunchState {
  int smem_attr = 0;      // the largest dynamic smem size set on the kernel
  int smem = -1;          // the size that `grid_full` was computed for
  int64_t grid_full = 0;  // SMs x resident blocks per SM at `smem`
};
struct LaunchCache {
  LaunchState dev[kMaxDevices];
  std::mutex mu;
};

// Grid size (before clamping to the tile count) of `kernel` with `threads`
// threads and `smem` bytes of dynamic shared memory on the current device.
template <typename Kernel>
cudaError_t full_grid(Kernel kernel, int threads, int smem,
                      LaunchCache& cache, int64_t* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(cache.mu);
  LaunchState& c = cache.dev[dev];
  if (c.smem == smem) {
    *grid = c.grid_full;
    return cudaSuccess;
  }
  if (smem > c.smem_attr) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    c.smem_attr = smem;
  }
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  c.smem = smem;
  c.grid_full = static_cast<int64_t>(sms) * per_sm;
  *grid = c.grid_full;
  return cudaSuccess;
}

}  // namespace sat
