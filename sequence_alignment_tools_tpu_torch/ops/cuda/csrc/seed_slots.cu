// Many-seed exact scan with in-kernel hit extraction, for sm_90a: the
// device census of the many-pattern path.
//
// Replaces the Pallas TPU kernel
// sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py::_slots_kernel
// without gate_cfg (launched by pallas_scan_slots), held to its output at
// the point where the scanner consumes it: every window start where a
// literal seed matches exactly, with the seed's id, compacted, the true
// count kept.  Contract, which the plain PyTorch version
// slots.py::scan_slots_ref states too: emit every pair (t, s) such that
// seed s (length len[s], no wildcard) equals codes[t : t + len[s]] and
// t + len[s] <= n.  Pairs go to out[1 ..] (starts) and out[1 + cap ..]
// (seed ids) through an atomic counter, in no order; out[0] always
// receives the true number, so the host retries with a larger cap when it
// exceeds cap.
//
// The TPU kernel scored every seed at every position on the matrix unit
// (at most 128 seeds a pass), reduced a start to (count, sum of ids) and
// packed the text window beside it for its gate; starts with several
// seeds, saturated counts and full rows escaped to the host, and pattern
// sets past 2048 went to a host hash census.  Here the census itself runs
// on the card: the seeds of one length L sit in an open-addressing hash
// table keyed by their base-alpha code (built on the host by
// conv_scan.py::ConvScanner._mer_tables, duplicates chained), and a window
// start costs one code and one probe per distinct length, whatever the
// number of seeds.  Every chained seed is emitted, so nothing escapes, and
// the text window is not copied: gate_slots.cu reads the resident text.
//
// What bounds it on an H100: not the text (n bytes, read once into shared
// memory) but the probes, one dependent random 8-byte read per start and
// length into tables of a few MB that sit in L2, and for dense seed sets
// the 8 bytes written per hit.  The design:
//   - one block per tile of kTile window starts, the tile's text and its
//     Lmax - 1 byte halo in shared memory;
//   - one thread per start: the length classes are sorted by ascending
//     length, so the code of one class extends the code of the one
//     before (Lmax multiply-adds per start in a 64-bit register, which
//     conv_scan's _radix_eligible guarantees to fit), with one probe at
//     each class length;
//   - the probe is the host table's: slot = ((code * GOLD) >> 32) & mask,
//     linear probing to the key or an empty slot;
//   - hits reserve their output slots through one atomicAdd per group of
//     converged lanes (warp-aggregated, slot_out.cuh).
// A rolling code per thread over several consecutive starts, a presence
// bitmap in shared memory before the probe and block-level output staging
// are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_chunk.cuh"
#include "slot_out.cuh"

namespace {

using sat::emit_pair;
using sat::full_grid;
using sat::LaunchCache;
using sat::round_up;

constexpr int kThreads = 256;
constexpr int kPer = 4;  // window starts per thread and tile
constexpr int kTile = kThreads * kPer;
constexpr int kMaxClasses = 64;
constexpr unsigned long long kGold = 0x9E3779B97F4A7C15ULL;
constexpr unsigned long long kEmpty = ~0ULL;

__global__ void __launch_bounds__(kThreads)
seed_slots_kernel(const uint8_t* __restrict__ codes, int64_t n, int alpha,
                  const int64_t* __restrict__ cls, int ncls, int Lmax,
                  const unsigned long long* __restrict__ keys,
                  const int32_t* __restrict__ head,
                  const int32_t* __restrict__ enext,
                  const int32_t* __restrict__ epid,
                  int32_t* __restrict__ out, int64_t cap) {
  extern __shared__ __align__(16) unsigned char txt[];
  __shared__ int64_t cls_s[kMaxClasses * 3];  // (L, mask, slot offset)
  for (int i = threadIdx.x; i < ncls * 3; i += blockDim.x) cls_s[i] = cls[i];
  const int span = kTile + Lmax - 1;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const unsigned long long a = static_cast<unsigned long long>(alpha);

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t t0 = tile * kTile;
    __syncthreads();  // the previous tile's readers are done with txt
    for (int x = threadIdx.x; x < span; x += blockDim.x) {
      const int64_t pos = t0 + x;
      txt[x] = pos < n ? codes[pos] : 0;  // no window reaches past n
    }
    __syncthreads();
    for (int it = 0; it < kPer; ++it) {
      const int local = it * kThreads + threadIdx.x;
      const int64_t t = t0 + local;
      if (t >= n) continue;
      unsigned long long code = 0;
      int j = 0;
      for (int c = 0; c < ncls; ++c) {
        const int L = static_cast<int>(cls_s[3 * c]);
        if (t + L > n) break;  // ascending lengths: none of the rest fits
        for (; j < L; ++j) code = code * a + txt[local + j];
        const unsigned long long mask =
            static_cast<unsigned long long>(cls_s[3 * c + 1]);
        const int64_t off = cls_s[3 * c + 2];
        unsigned long long slot = ((code * kGold) >> 32) & mask;
        while (true) {
          const unsigned long long key = __ldg(keys + off + slot);
          if (key == kEmpty) break;
          if (key == code) {
            for (int e = __ldg(head + off + slot); e >= 0;
                 e = __ldg(enext + e)) {
              emit_pair(out, cap, static_cast<int32_t>(t), __ldg(epid + e));
            }
            break;
          }
          slot = (slot + 1) & mask;
        }
      }
    }
  }
}

LaunchCache g_launch;

}  // namespace

// Every exact seed hit of codes[0 .. n) into out[0 .. 1 + 2 cap): out[0]
// the true count (the caller zeroes it first), out[1 ..] the window
// starts, out[1 + cap ..] the 0-based seed ids.  codes [>= n] uint8;
// cls [ncls, 3] int64 rows (length, table size - 1, slot offset) sorted by
// ascending length; keys [sum of table sizes] uint64 (all ones = empty);
// head [same] int32 and enext [P] int32 entry indices (-1 ends a chain);
// epid [P] int32 seed ids.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int sat_seed_slots(const void* codes, int64_t n, int alpha,
                              const void* cls, int ncls, int Lmax,
                              const void* keys, const void* head,
                              const void* enext, const void* epid, void* out,
                              int64_t cap, void* stream) {
  if (n < 1 || alpha < 2 || ncls < 1 || ncls > kMaxClasses || Lmax < 1 ||
      cap < 1 || n + Lmax >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = round_up(kTile + Lmax - 1, 16);
  int64_t grid = 0;
  const cudaError_t err =
      full_grid(seed_slots_kernel, kThreads, smem, g_launch, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (grid > ntiles) grid = ntiles;
  seed_slots_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n, alpha,
      static_cast<const int64_t*>(cls), ncls, Lmax,
      static_cast<const unsigned long long*>(keys),
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(enext),
      static_cast<const int32_t*>(epid), static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
