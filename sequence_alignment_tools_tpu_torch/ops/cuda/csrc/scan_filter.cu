// Microblock occupancy filter of the exact / k-mismatch scan, for sm_90a.
//
// Replaces the "occupancy" emit of the Pallas TPU kernel
// sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py::_scan_kernel
// (launched through _kernel_out from pallas_scan_hits).  Contract, which
// the plain PyTorch version scan_kernel.py::scan_occupancy_ref states
// too:
//
//   occ[m] = 1  iff  some window start t in [32m, 32m + 32) and some
//   pattern p have  sum_j w[j, text[t + j], p] >= thr[p],
//
// with text at positions >= n read as the EOS code.  The weights are the
// exact (unfolded) conv weights, so occ marks exactly the microblocks that
// hold a hit start; the TPU kernel's base-class fold made its mask a
// superset.
//
// What bounds it on an H100: not device memory (one byte of text per
// position, read once) but the shared-memory weight lookups, P x Lmax of
// them per position when every window is scored in full.  The design cuts
// that count, not the lookup cost:
//   - each pattern's score loop stops as soon as the weights still to come
//     cannot lift it to the threshold (rem[] below, an upper bound computed
//     per pattern chunk from the weights themselves).  On random DNA an
//     exact 13..18-mer dies after ~1.3 positions on average;
//   - a warp is one 32-position microblock: after each pattern it votes
//     with __any_sync and stops at the first hit, since one hit decides
//     the microblock's byte.
// The TPU's phase transpose, lane shifts, base-class fold and int8 MXU
// im2col exist for the TPU's vector units and are not carried over.  A
// tensor-core (wgmma) or bit-parallel form is later work.
//
// Layout: one block of 256 threads scores 256 consecutive window starts
// (8 microblocks) per tile and walks tiles with a grid stride.  The tile's
// text plus its Lmax - 1 halo sits in shared memory as bytes; the int16
// weights sit there in pattern chunks (all P at once when they fit, which
// holds for P <= 2048 and Lmax <= 128 over a DNA alphabet), stored
// pattern-major so the 32 lanes of a warp read one pattern row at a time.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_chunk.cuh"

namespace {

using sat::full_grid;
using sat::LaunchCache;
using sat::per_pattern_bytes;
using sat::round_up;
using sat::stage_chunk;

constexpr int kThreads = 256;  // window starts per tile, 8 warps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemBudget = 96 * 1024;  // leaves room for 2 blocks per SM
constexpr int kSmemMax = 232448;        // sm_90 per-block opt-in maximum

// Scores one chunk for this thread's window start; returns the warp's
// vote (true when any lane of the warp hit any pattern of the chunk).
__device__ bool scan_chunk(const uint8_t* txt, int Lmax, int alpha,
                           int pc_cur, const int32_t* thr_s,
                           const int32_t* jend_s, const int16_t* w_s,
                           const int32_t* rem_s) {
  const int row = Lmax * alpha;
  const uint8_t* tp = txt + threadIdx.x;
  for (int pl = 0; pl < pc_cur; ++pl) {
    const bool hit = sat::window_hits(tp, w_s + pl * row, rem_s + pl * Lmax,
                                      thr_s[pl], jend_s[pl], alpha);
    if (__any_sync(kFull, hit)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
occupancy_kernel(const uint8_t* __restrict__ codes, int64_t n,
                 const int16_t* __restrict__ w,
                 const int32_t* __restrict__ thr, int Lmax, int alpha, int P,
                 int eos, int text_bytes, int pc,
                 uint8_t* __restrict__ occ, int64_t nmb) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* txt = smem;
  int32_t* thr_s = reinterpret_cast<int32_t*>(smem + text_bytes);
  int32_t* jend_s = thr_s + pc;
  int32_t* rem_s = jend_s + pc;
  int16_t* w_s = reinterpret_cast<int16_t*>(rem_s + pc * Lmax);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool single = pc >= P;
  const int64_t ntiles = (nmb * 32 + kThreads - 1) / kThreads;
  const int span = kThreads + Lmax - 1;

  if (single) {
    stage_chunk(w, thr, Lmax, alpha, P, 0, P, thr_s, jend_s, w_s, rem_s);
  }
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = tile * kThreads;
    __syncthreads();  // the previous tile's readers are done with txt
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const int64_t pos = base + i;
      txt[i] = pos < n ? codes[pos] : static_cast<uint8_t>(eos);
    }
    __syncthreads();
    bool any = false;
    for (int p0 = 0; p0 < P; p0 += pc) {
      const int pc_cur = P - p0 < pc ? P - p0 : pc;
      if (!single) {
        __syncthreads();  // every warp is done with the previous chunk
        stage_chunk(w, thr, Lmax, alpha, P, p0, pc_cur, thr_s, jend_s, w_s,
                    rem_s);
      }
      if (!any) {
        any = scan_chunk(txt, Lmax, alpha, pc_cur, thr_s, jend_s, w_s,
                         rem_s);
      }
    }
    const int64_t mb = base / 32 + warp;
    if (lane == 0 && mb < nmb) occ[mb] = any ? 1 : 0;
  }
}

LaunchCache g_launch;

}  // namespace

// occ[0..nmb) from codes[0..n) (uint8 codes < alpha), w [Lmax, alpha, P]
// int16 and thr [P] int32, on `stream`.  nmb must be ceil(n / 32) or
// more.  Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_scan_occupancy(const void* codes, int64_t n,
                                  const void* w, const void* thr, int Lmax,
                                  int alpha, int P, int eos, void* occ,
                                  int64_t nmb, void* stream) {
  if (nmb <= 0) return 0;
  if (Lmax < 1 || alpha < 1 || alpha > 256 || P < 1 || eos < 0 ||
      eos >= alpha) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int text_bytes = round_up(kThreads + Lmax - 1, 16);
  const int per = per_pattern_bytes(Lmax, alpha);
  int pc = (kSmemBudget - text_bytes) / per;
  if (pc < 1) pc = 1;
  if (pc > P) pc = P;
  const int smem = text_bytes + pc * per;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int64_t grid = 0;
  const cudaError_t err =
      full_grid(occupancy_kernel, kThreads, smem, g_launch, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = (nmb * 32 + kThreads - 1) / kThreads;
  if (grid > ntiles) grid = ntiles;
  occupancy_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n,
      static_cast<const int16_t*>(w), static_cast<const int32_t*>(thr), Lmax,
      alpha, P, eos, text_bytes, pc, static_cast<uint8_t*>(occ), nmb);
  return static_cast<int>(cudaGetLastError());
}
