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
// start costs one code update, a presence test in shared memory and, when
// that passes, one probe per distinct length, whatever the number of
// seeds.  Every chained seed is emitted, so nothing escapes, and the text
// window is not copied: gate_slots.cu reads the resident text.
//
// What bounds it on an H100: the bytes are small (n of text in, 8 per hit
// out); the first form recomputed every start's code from scratch (L
// 64-bit multiply-adds), made a dependent random 8-byte probe into L2 at
// every start and class, and emitted hits as scattered 4-byte stores.
// The design:
//   - one block of 1024 threads per tile of 1024 x 28 window starts (a
//     persistent grid), the tile's text and its Lmax - 1 byte halo in
//     shared memory;
//   - a thread owns 28 consecutive starts and rolls one code per length
//     class over them, class by class:
//       code(t + 1) = (code(t) - txt[t] alpha^(L-1)) alpha + txt[t + L],
//     exact in uint64 (conv_scan's _radix_eligible guarantees
//     alpha^Lmax < 2^64; a wrapped intermediate cancels modulo 2^64); 28
//     bytes a thread is 7 words, odd, so a warp's byte reads fall in 32
//     distinct banks;
//   - h = code * GOLD serves twice: its top bits index two bits of a
//     presence filter in shared memory (up to 128 KB, built on the host
//     from every class's keys: slots.py::presence_filter, no false
//     negatives), and only a start that passes probes the host's table at
//     slot = (h >> 32) & mask, linear probing to the key or an empty slot;
//   - hits are staged in shared memory (4096 pairs); one atomicAdd per
//     block and tile reserves their range in the output and the copy-out
//     is coalesced; a hit that finds the stage full goes out directly
//     (warp-aggregated, slot_out.cuh), so the true count holds.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_chunk.cuh"
#include "slot_out.cuh"

namespace {

using sat::emit_pair;
using sat::full_grid;
using sat::LaunchCache;
using sat::round_up;

constexpr int kThreads = 1024;
constexpr int kRun = 28;                 // window starts a thread, 7 words
constexpr int kTile = kThreads * kRun;   // 28,672, a multiple of 16
constexpr int kStage = 4096;             // hits staged a block and tile
constexpr int kMaxClasses = 64;
constexpr int kMaxFilterBits = 20;       // 128 KB of shared memory
constexpr unsigned long long kGold = 0x9E3779B97F4A7C15ULL;
constexpr unsigned long long kEmpty = ~0ULL;

__global__ void __launch_bounds__(kThreads, 1)
seed_slots_kernel(const uint8_t* __restrict__ codes, int64_t n, int alpha,
                  const int64_t* __restrict__ cls, int ncls, int Lmax,
                  const unsigned long long* __restrict__ keys,
                  const int32_t* __restrict__ head,
                  const int32_t* __restrict__ enext,
                  const int32_t* __restrict__ epid,
                  const uint32_t* __restrict__ filt, int fbits, int aligned,
                  int32_t* __restrict__ out, int64_t cap) {
  // shared layout: [filter, 2^fbits bits][staged starts][staged seed
  // ids][text tile + halo]
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* filt_s = smem;
  const int fwords = (1 << fbits) / 32;
  int32_t* st_t = reinterpret_cast<int32_t*>(smem + fwords);
  int32_t* st_s = st_t + kStage;
  uint8_t* txt = reinterpret_cast<uint8_t*>(st_s + kStage);
  __shared__ int64_t cls_s[kMaxClasses * 3];  // (L, mask, slot offset)
  __shared__ unsigned long long pw_s[kMaxClasses];  // alpha^(L - 1)
  __shared__ int staged;
  __shared__ int64_t base_s;
  const unsigned long long a = static_cast<unsigned long long>(alpha);
  for (int i = threadIdx.x; i < fwords; i += kThreads) filt_s[i] = filt[i];
  for (int i = threadIdx.x; i < ncls * 3; i += kThreads) cls_s[i] = cls[i];
  for (int c = threadIdx.x; c < ncls; c += kThreads) {
    unsigned long long pw = 1;
    for (int j = 1; j < static_cast<int>(cls[3 * c]); ++j) pw *= a;
    pw_s[c] = pw;
  }
  if (threadIdx.x == 0) staged = 0;
  const int span = round_up(kTile + Lmax - 1, 16);
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const int sh1 = 64 - fbits;
  const int sh2 = 64 - 2 * fbits;
  const unsigned long long fmask = (1ULL << fbits) - 1;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t t0 = tile * kTile;
    for (int x = 16 * threadIdx.x; x < span; x += 16 * kThreads) {
      const int64_t pos = t0 + x;
      if (aligned && pos + 16 <= n) {
        *reinterpret_cast<uint4*>(txt + x) =
            __ldg(reinterpret_cast<const uint4*>(codes + pos));
      } else {  // no window reaches past n
        for (int i = 0; i < 16; ++i) {
          txt[x + i] = pos + i < n ? __ldg(codes + pos + i) : 0;
        }
      }
    }
    __syncthreads();  // the tile, the tables, a reset stage count
    const int local0 = threadIdx.x * kRun;
    const int64_t s0 = t0 + local0;
    for (int c = 0; c < ncls; ++c) {
      const int L = static_cast<int>(cls_s[3 * c]);
      if (s0 + L > n) break;  // ascending lengths: none of the rest fits
      const unsigned long long mask =
          static_cast<unsigned long long>(cls_s[3 * c + 1]);
      const int64_t off = cls_s[3 * c + 2];
      const unsigned long long pw = pw_s[c];
      const uint8_t* tp = txt + local0;
      unsigned long long code = 0;
      for (int j = 0; j < L; ++j) code = code * a + tp[j];
      for (int r = 0; r < kRun; ++r) {
        if (r > 0) code = (code - tp[r - 1] * pw) * a + tp[r + L - 1];
        if (s0 + r + L > n) break;
        const unsigned long long h = code * kGold;
        const uint32_t b1 = static_cast<uint32_t>(h >> sh1);
        const uint32_t b2 = static_cast<uint32_t>((h >> sh2) & fmask);
        if (!((filt_s[b1 >> 5] >> (b1 & 31)) & (filt_s[b2 >> 5] >> (b2 & 31)) &
              1u)) {
          continue;
        }
        unsigned long long slot = (h >> 32) & mask;
        while (true) {
          const unsigned long long key = __ldg(keys + off + slot);
          if (key == kEmpty) break;
          if (key == code) {
            for (int e = __ldg(head + off + slot); e >= 0;
                 e = __ldg(enext + e)) {
              const int i = atomicAdd(&staged, 1);
              if (i < kStage) {
                st_t[i] = static_cast<int32_t>(s0 + r);
                st_s[i] = __ldg(epid + e);
              } else {
                emit_pair(out, cap, static_cast<int32_t>(s0 + r),
                          __ldg(epid + e));
              }
            }
            break;
          }
          slot = (slot + 1) & mask;
        }
      }
    }
    __syncthreads();  // every hit of the tile is staged or out
    const int nst = staged < kStage ? staged : kStage;
    if (threadIdx.x == 0 && nst > 0) base_s = atomicAdd(out, nst);
    __syncthreads();
    for (int i = threadIdx.x; i < nst; i += kThreads) {
      const int64_t o = base_s + i;
      if (o < cap) {
        out[1 + o] = st_t[i];
        out[1 + cap + o] = st_s[i];
      }
    }
    __syncthreads();  // the stage and the text are free again
    if (threadIdx.x == 0) staged = 0;
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
// epid [P] int32 seed ids; filt [2^fbits / 32] uint32, the presence
// filter (bits h >> (64 - fbits) and (h >> (64 - 2 fbits)) mod 2^fbits
// set for h = key * GOLD of every key), fbits in [7, 20].  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sat_seed_slots(const void* codes, int64_t n, int alpha,
                              const void* cls, int ncls, int Lmax,
                              const void* keys, const void* head,
                              const void* enext, const void* epid,
                              const void* filt, int fbits, void* out,
                              int64_t cap, void* stream) {
  if (n < 1 || alpha < 2 || ncls < 1 || ncls > kMaxClasses || Lmax < 1 ||
      fbits < 7 || fbits > kMaxFilterBits || cap < 1 ||
      n + Lmax >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = (1 << fbits) / 8 + kStage * 8 +
                   round_up(kTile + Lmax - 1, 16);
  int64_t grid = 0;
  const cudaError_t err =
      full_grid(seed_slots_kernel, kThreads, smem, g_launch, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (grid > ntiles) grid = ntiles;
  const int aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  seed_slots_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n, alpha,
      static_cast<const int64_t*>(cls), ncls, Lmax,
      static_cast<const unsigned long long*>(keys),
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(enext),
      static_cast<const int32_t*>(epid), static_cast<const uint32_t*>(filt),
      fbits, aligned, static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
