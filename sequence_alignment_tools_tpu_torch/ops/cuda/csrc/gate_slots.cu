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
// What bounds it on an H100: the gate DP, glen rows of 2 band + 1 cells per
// slot in the registers of one thread, with an early exit at the first
// saturated row (a random slot dies after about two rows); the 8 bytes
// read per slot and the extension window, a few bytes of text per slot
// through the read-only cache, are small beside it.  One thread per slot:
// every lane of a warp has a DP to run, unlike seed_gate.cu, where hits
// are rare among the lanes.  The accept bits [S, Lg] (megabytes for 10^5
// seeds) are read through __ldg and sit in L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "gate.cuh"
#include "slot_out.cuh"

namespace {

using sat::emit_pair;
using sat::Gate;
using sat::gate_ok;
using sat::kMaxBand;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
gate_slots_kernel(const uint8_t* __restrict__ codes, int64_t n,
                  const int32_t* __restrict__ slots, int64_t cap_in,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ gbits,
                  const int32_t* __restrict__ glen,
                  const int32_t* __restrict__ gdir, int Lg, int k, int band,
                  int indels, int32_t* __restrict__ out, int64_t cap) {
  int64_t live = slots[0];
  if (live > cap_in) live = cap_in;
  const Gate g{gbits, glen, gdir, Lg, k, band, indels != 0, false};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < live; i += stride) {
    const int64_t t = slots[1 + i];
    const int s = slots[1 + cap_in + i];
    const int64_t anchor = t + __ldg(lengths + s);
    if (gate_ok(codes, n, anchor, s, g)) {
      emit_pair(out, cap, static_cast<int32_t>(anchor), s);
    }
  }
}

}  // namespace

// Gate survivors of the slot row `slots` [1 + 2 cap_in] int32 (count,
// window starts, seed ids; the count is read on the device and clamped to
// cap_in) into out[0 .. 1 + 2 cap): out[0] the true count (the caller
// zeroes it first), out[1 ..] the anchors, out[1 + cap ..] the seed ids.
// codes [>= n] uint8, lengths [S] int32 seed lengths, gate bits [S, Lg],
// glen [S], gdir [S] int32.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int sat_gate_slots(const void* codes, int64_t n,
                              const void* slots, int64_t cap_in,
                              const void* lengths, const void* gbits,
                              const void* glen, const void* gdir, int Lg,
                              int k, int band, int indels, void* out,
                              int64_t cap, void* stream) {
  if (n < 1 || cap_in < 1 || Lg < 1 || k < 0 || band < 0 ||
      band > kMaxBand || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t grid = (cap_in + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  gate_slots_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n,
      static_cast<const int32_t*>(slots), cap_in,
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(gbits), static_cast<const int32_t*>(glen),
      static_cast<const int32_t*>(gdir), Lg, k, band, indels,
      static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
