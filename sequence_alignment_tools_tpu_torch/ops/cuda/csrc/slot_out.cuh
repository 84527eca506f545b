// Output through an atomic counter, shared by seed_slots.cu and
// gate_slots.cu: rows [count, column 0 (cap), column 1 (cap)] whose count
// keeps the true number of entries while only the first cap are stored.

#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace sat {

// The output slot of the calling thread: the threads of the warp that
// reach this point together reserve their slots with one atomicAdd
// (warp-aggregated), so a dense output does not serialise on the counter.
__device__ inline int reserve_slot(int32_t* counter) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) {
    base = atomicAdd(counter, static_cast<int>(g.size()));
  }
  return g.shfl(base, 0) + static_cast<int>(g.thread_rank());
}

// Append (a, b) to the row at `out`; entries past cap are counted only.
__device__ inline void emit_pair(int32_t* out, int64_t cap, int32_t a,
                                 int32_t b) {
  const int o = reserve_slot(out);
  if (o >= 0 && o < cap) {
    out[1 + o] = a;
    out[1 + cap + o] = b;
  }
}

}  // namespace sat
