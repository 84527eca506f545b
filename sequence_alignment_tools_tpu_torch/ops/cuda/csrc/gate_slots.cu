// The banded extension gate over a list of seed-hit slots, for sm_90a.
//
// Replaces the Pallas TPU kernel
// sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py::_gate_slots_kernel
// (body _gate_body, launched by pallas_gate_slots).  Contract, which the
// plain PyTorch version slots.py::gate_slots_ref states too: from the slot
// row [count, starts (cap_in), sids (cap_in)] that seed_slots.cu wrote,
// emit every pair (anchor = start + len[sid], sid) whose gate DP is at
// most k (gate.cuh, equal to gate.py::gate_ok_ref).  Survivors go to
// out[1 ..] (anchors) and out[1 + cap ..] (seed ids) through an atomic
// counter, in no order; out[0] always receives the true number: the row
// seed_gate.cu writes, so one decoder serves both.
//
// The TPU kernel gated the first LgT <= 6 positions of an extension
// against the text window packed beside each slot, named one seed per
// slot (multi-seed slots and windows at the array tail escaped to the
// host, bit 31), and re-compacted per row.  This kernel runs the whole
// extension (the exact gate) against the resident text, text outside
// [0, n) reading as a sentinel no pattern accepts, and every slot names
// its seed, so nothing escapes.
//
// What bounds it on an H100: latency.  Its bytes are small (8 per slot,
// a 32-byte seed record and a few bytes of text, from L2), and a random
// slot dies after about three DP rows (k = 1, band 1); but every slot is
// a chain of dependent loads: the slot, then its seed's record, then the
// text.  The first form ran that chain per slot, a load and a select per
// cell of 17 unrolled cells with the band tested in each.  The design:
//   - one instance per band (gate.cuh's row of exactly 2 B + 1 cells, and
//     at B = 0 a count of mismatches);
//   - a thread walks its slots grid-stride with the chain pipelined over
//     them: while it gates slot i it holds the record and the first four
//     window codes of slot i + s in flight, the record of slot i + 2 s and
//     the slot i + 3 s (s the grid's stride), so a gate waits on nothing
//     fetched for it;
//   - one 32-byte record per seed, built on the host (length, glen, gdir,
//     the accept words of rows 1 to 5): one aligned sector where three
//     dependent loads were;
//   - a row reads one new window code, and past row 5 one accept word,
//     both fetched a row ahead as loads whose value nothing touches until
//     that row (the index is clamped into [0, n), the sentinel applied at
//     use), so no load stalls the thread at the instruction that sends it.
// A per-warp queue that refills a lane from the warp's batch when its slot
// dies (ballot and popcount) kept no lane idle behind a survivor, but its
// ballots, shared queue and the registers of its batches cost more than
// the idling on the many-pattern k = 1 slots (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

#include "gate.cuh"
#include "scan_chunk.cuh"
#include "slot_out.cuh"

namespace {

using sat::band_init;
using sat::band_row;
using sat::band_shift;
using sat::full_grid;
using sat::gate_miss;
using sat::kMaxBand;
using sat::kSentinel;
using sat::LaunchCache;

constexpr int kThreads = 256;
constexpr int kRecRows = 5;  // accept words in a seed's record
constexpr int kPre = 4;      // window codes fetched ahead with a slot

// Window slot j of a slot whose slot 0 lies at `base`: a load that is
// always in bounds (the index clamped into [0, n)), and whether the slot
// lies inside [0, n) (else it reads the sentinel).
struct Window {
  const uint8_t* __restrict__ codes;
  int n;
  __device__ __forceinline__ int load(int base, int step, int j) const {
    const int idx = base + step * j;
    return __ldg(codes + min(max(idx, 0), n - 1));
  }
  __device__ __forceinline__ bool inside(int base, int step, int j) const {
    const int idx = base + step * j;
    return idx >= 0 && idx < n;
  }
  __device__ __forceinline__ int operator()(int base, int step,
                                            int j) const {
    return inside(base, step, j) ? load(base, step, j) : kSentinel;
  }
};

// A slot in the pipeline: from the row, then its record, then its first
// window codes (loads in flight until the slot is gated).
struct Slot {
  int start = 0, sid = -1;
  int4 r0 = make_int4(0, 0, 0, 0);  // length, glen, gdir, accept row 1
  int4 r1 = make_int4(0, 0, 0, 0);  // accept rows 2 to 5
  int c[kPre] = {0, 0, 0, 0};
  unsigned in = 0;  // bit j: window slot j lies inside [0, n)

  __device__ __forceinline__ int anchor() const { return start + r0.x; }
  __device__ __forceinline__ int base() const {
    return r0.z > 0 ? anchor() : anchor() + r0.z;
  }
  __device__ __forceinline__ int step() const { return r0.z > 0 ? 1 : -1; }
};

template <int B>
__global__ void __launch_bounds__(kThreads)
gate_slots_kernel(const uint8_t* __restrict__ codes, int n,
                  const int32_t* __restrict__ slots, int64_t cap_in,
                  const int4* __restrict__ rec,
                  const int32_t* __restrict__ gbits, int Lg, int k,
                  int32_t* __restrict__ out, int64_t cap) {
  const Window text{codes, n};
  const int inf = k + 1;
  int64_t live = slots[0];
  if (live > cap_in) live = cap_in;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
  auto fetch_slot = [&](Slot& x, int64_t i) {
    x.sid = -1;
    if (i < live) {
      x.start = __ldg(slots + 1 + i);
      x.sid = __ldg(slots + 1 + cap_in + i);
    }
  };
  auto fetch_rec = [&](Slot& x) {
    if (x.sid >= 0) {
      x.r0 = __ldg(rec + 2 * x.sid);
      x.r1 = __ldg(rec + 2 * x.sid + 1);
    }
  };
  auto fetch_codes = [&](Slot& x) {
    if (x.sid >= 0) {
      const int base = x.base(), step = x.step();
      x.in = 0;
#pragma unroll
      for (int j = 0; j < kPre; ++j) {
        x.c[j] = text.load(base, step, j);
        x.in |= static_cast<unsigned>(text.inside(base, step, j)) << j;
      }
    }
  };
  // the slots of i + s (codes in flight), i + 2 s (record in flight) and
  // i + 3 s (slot in flight)
  Slot s1, s2, s3;
  fetch_slot(s1, i0);
  fetch_slot(s2, i0 + stride);
  fetch_slot(s3, i0 + 2 * stride);
  fetch_rec(s1);
  fetch_rec(s2);
  fetch_codes(s1);
  for (int64_t i = i0; i < live; i += stride) {
    const int sid = s1.sid;
    const int anchor = s1.anchor();
    const int glen = s1.r0.y;
    const int base = s1.base(), step = s1.step();
    uint32_t acc = s1.r0.w;
    uint32_t a1 = s1.r1.x, a2 = s1.r1.y, a3 = s1.r1.z, a4 = s1.r1.w;
    int pre = 0;  // window codes 0 to 3, a byte each
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      pre |= ((s1.in >> j) & 1u ? s1.c[j] : kSentinel) << (8 * j);
    }
    // move the pipeline on before the gate, so its loads overlap it
    s1 = s2;
    fetch_codes(s1);
    s2 = s3;
    fetch_rec(s2);
    fetch_slot(s3, i + 3 * stride);

    if (glen == 0) {  // an empty extension passes
      sat::emit_pair(out, cap, anchor, sid);
      continue;
    }
    const int32_t* brow = gbits + static_cast<int64_t>(sid) * Lg;
    int nx = 0;  // the next row's new window code, and whether inside
    bool nx_in = false;
    uint32_t accn = 0;  // the next row's accept word past row 5
    int D[2 * B + 1];
    int win[2 * B + 1];
    int miss = 0;
    if constexpr (B > 0) {
      band_init<B>(D, inf);
#pragma unroll
      for (int d = 0; d <= B; ++d) win[d] = kSentinel;  // slots below 0
#pragma unroll
      for (int j = 0; j < B; ++j) {
        win[B + 1 + j] =
            j < kPre ? (pre >> (8 * j)) & 0xff : text(base, step, j);
      }
    }
    if (B >= kPre) {
      nx = text.load(base, step, B);
      nx_in = text.inside(base, step, B);
    }
    bool pass = false;
    for (int p = 1; p <= glen; ++p) {
      // row p reads window slot p - 1 + B; the next row's code and
      // accept word are fetched now
      const int j = p - 1 + B;
      const int c = j < kPre ? (pre >> (8 * j)) & 0xff
                             : (nx_in ? nx : kSentinel);
      const uint32_t a = p <= kRecRows ? acc : accn;
      if (p < glen) {
        if (j + 1 >= kPre) {
          nx = text.load(base, step, j + 1);
          nx_in = text.inside(base, step, j + 1);
        }
        if (p >= kRecRows) accn = __ldg(brow + p);
      }
      acc = a1;
      a1 = a2;
      a2 = a3;
      a3 = a4;
      int rowmin;
      if constexpr (B == 0) {
        miss += gate_miss(a, c);
        rowmin = miss;
      } else {
        band_shift<B>(win, c);
        rowmin = band_row<B>(D, win, a, p, inf);
      }
      if (rowmin > k) break;
      pass = p == glen;
    }
    if (pass) sat::emit_pair(out, cap, anchor, sid);
  }
}

LaunchCache g_launch[kMaxBand + 1];

template <int B>
cudaError_t launch(const uint8_t* codes, int n, const int32_t* slots,
                   int64_t cap_in, const int4* rec, const int32_t* gbits,
                   int Lg, int k, int32_t* out, int64_t cap,
                   cudaStream_t stream) {
  int64_t grid = 0;
  const cudaError_t err =
      full_grid(gate_slots_kernel<B>, kThreads, 0, g_launch[B], &grid);
  if (err != cudaSuccess) return err;
  const int64_t need = (cap_in + kThreads - 1) / kThreads;
  if (grid > need) grid = need;
  gate_slots_kernel<B><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      codes, n, slots, cap_in, rec, gbits, Lg, k, out, cap);
  return cudaGetLastError();
}

}  // namespace

// Gate survivors of the slot row `slots` [1 + 2 cap_in] int32 (count,
// window starts, seed ids; the count is read on the device and clamped to
// cap_in) into out[0 .. 1 + 2 cap): out[0] the true count (the caller
// zeroes it first), out[1 ..] the anchors, out[1 + cap ..] the seed ids.
// codes [>= n] uint8; rec [S, 8] int32, 16-byte aligned, per seed (seed
// length, glen, gdir, accept words of rows 1 to 5, zero past glen); gate
// bits [S, Lg] int32.  The band is the gate's with indels, 0 without.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_gate_slots(const void* codes, int64_t n,
                              const void* slots, int64_t cap_in,
                              const void* rec, const void* gbits, int Lg,
                              int k, int band, void* out, int64_t cap,
                              void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) || cap_in < 1 || Lg < 1 || k < 0 ||
      band < 0 || band > kMaxBand || cap < 1 ||
      (reinterpret_cast<uintptr_t>(rec) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto c = static_cast<const uint8_t*>(codes);
  const auto sl = static_cast<const int32_t*>(slots);
  const auto r = static_cast<const int4*>(rec);
  const auto gb = static_cast<const int32_t*>(gbits);
  const auto o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n);
  cudaError_t err;
  switch (band) {
    case 0: err = launch<0>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    case 1: err = launch<1>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    case 2: err = launch<2>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    case 3: err = launch<3>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    case 4: err = launch<4>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    case 5: err = launch<5>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    case 6: err = launch<6>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    case 7: err = launch<7>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s); break;
    default:
      err = launch<8>(c, ni, sl, cap_in, r, gb, Lg, k, o, cap, s);
  }
  return static_cast<int>(err);
}
