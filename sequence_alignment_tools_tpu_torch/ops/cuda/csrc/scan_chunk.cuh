// Code shared by the scan kernels (scan_filter.cu, seed_gate.cu): pattern
// chunks in shared memory, and the per-device launch configuration.
//
// A chunk holds, for patterns [p0, p0 + pc_cur), the int16 weights
// [pc][Lmax][alpha] (pattern-major, so the 32 lanes of a warp read one
// pattern row at a time), the thresholds, and two bounds for the early
// exit of a window's score loop: rem[j], the most the weights of
// positions j.. can still add, and jend, one past the last position with
// any nonzero weight.

#pragma once

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace sat {

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory bytes of one pattern of a chunk: weights int16
// [Lmax][alpha], rem int32 [Lmax], thr + jend int32.
__host__ __device__ inline int per_pattern_bytes(int Lmax, int alpha) {
  return Lmax * alpha * 2 + Lmax * 4 + 8;
}

// Stage patterns [p0, p0 + pc_cur) of w [Lmax, alpha, P] and thr [P] into
// shared memory and derive rem[] and jend per pattern.  Every thread of
// the block must call it (it synchronises the block twice).
__device__ inline void stage_chunk(const int16_t* __restrict__ w,
                                   const int32_t* __restrict__ thr, int Lmax,
                                   int alpha, int P, int p0, int pc_cur,
                                   int32_t* thr_s, int32_t* jend_s,
                                   int16_t* w_s, int32_t* rem_s) {
  const int row = Lmax * alpha;
  for (int i = threadIdx.x; i < pc_cur * row; i += blockDim.x) {
    const int pl = i / row;
    const int r = i - pl * row;  // r = j * alpha + c
    w_s[i] = w[(int64_t)r * P + p0 + pl];
  }
  for (int i = threadIdx.x; i < pc_cur; i += blockDim.x) {
    thr_s[i] = thr[p0 + i];
  }
  __syncthreads();
  for (int pl = threadIdx.x; pl < pc_cur; pl += blockDim.x) {
    const int16_t* wp = w_s + pl * row;
    int acc = 0;
    int jend = 0;
    for (int j = Lmax - 1; j >= 0; --j) {
      int mx = 0;
      bool nz = false;
      for (int c = 0; c < alpha; ++c) {
        const int v = wp[j * alpha + c];
        mx = v > mx ? v : mx;
        nz = nz || v != 0;
      }
      acc += mx;
      rem_s[pl * Lmax + j] = acc;
      if (nz && jend == 0) jend = j + 1;
    }
    jend_s[pl] = jend;
  }
  __syncthreads();
}

// Whether the window at tp (tp[j] = text code at window position j) scores
// at least thr against one staged pattern; stops as soon as the weights
// still to come cannot reach the threshold.
__device__ inline bool window_hits(const uint8_t* tp, const int16_t* wp,
                                   const int32_t* rp, int th, int je,
                                   int alpha) {
  int s = 0;
  int j = 0;
  for (; j < je; ++j) {
    if (s + rp[j] < th) break;
    s += wp[j * alpha + tp[j]];
  }
  return j == je && s >= th;
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
