// Seed enumeration and extension gate of the pigeonhole (k > 0) engines,
// for sm_90a.
//
// Replaces the Pallas TPU kernel
// sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py::_slots_kernel
// with gate_cfg (launched by pallas_scan_gated_slots), together with its
// XLA epilogue: the chain-member gate (ops/gate.py::_gate_ok) and the
// dense pack.  Contract, which the plain PyTorch version
// seed_gate.py::seed_gate_ref states too.  Given the candidate microblocks
// mb_idx[0 .. min(*mb_count, cap_mb)) of the seed scan's occupancy filter
// (scan_filter.cu), emit every pair (anchor = t + len[s], sid = s) with
//   - seed s matching exactly at window start t < n, text past n read as
//     EOS:  sum_j w[j, text[t + j], s] >= thr[s];
//   - t inside a candidate microblock [32 m, 32 m + 32);
//   - the gate DP of (anchor, s) at most k (gate.py::gate_ok_ref, edge
//     rules included).
// Survivors go to anchors/sids through an atomic counter, in no order;
// *count always receives the true number, so the host retries with a
// larger cap when it exceeds cap.
//
// The TPU kernel reduced each window start to (sum of seed ids, count)
// with a matmul and so could name one seed only: starts where several
// seeds hit, windows touching EOS and slot-cap overflows escaped to a host
// rescan.  This kernel enumerates every seed at every start, so nothing
// escapes.
//
// What bounds it on an H100: not device memory (the candidate microblocks
// are a few percent of the text, read once) but the instructions of the
// seed loop, S seeds x the early-exit depth per window start, and the
// serial gate DP of each seed hit (Lg rows x (2 band + 1) cells, in
// registers).  The design:
//   - one warp per candidate microblock, one lane per window start; the
//     warp's text (32 + Lmax - 1 bytes, EOS past n) sits in shared memory;
//   - the seed weights sit in shared memory in pattern chunks, with the
//     early exit of scan_filter.cu (scan_chunk.cuh), but every seed of
//     every chunk is visited instead of stopping at the first hit;
//   - each seed hit runs the diagonal-banded gate DP (gate.cuh, shared
//     with gate_slots.cu) at once, in the registers of its lane
//     (D[2 band + 1], band <= 8, saturated at k + 1),
//     and stops as soon as a whole row is saturated; the extension window
//     is read from device memory through the read-only cache;
//   - the accept bits [S, Lg] sit in shared memory when they fit the
//     budget, else they are read through __ldg.
// Hits are rare (about 2.4e-3 per position for the bench's half seeds), so
// most lanes of a warp idle while one runs its DP; a warp-cooperative DP,
// or a second pass over a compacted hit list, is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "gate.cuh"
#include "scan_chunk.cuh"

namespace {

using sat::full_grid;
using sat::Gate;
using sat::gate_ok;
using sat::kMaxBand;
using sat::LaunchCache;
using sat::per_pattern_bytes;
using sat::round_up;
using sat::stage_chunk;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBudget = 96 * 1024;  // leaves room for 2 blocks per SM
constexpr int kGateSmemMax = 32 * 1024;
constexpr int kSmemMax = 232448;        // sm_90 per-block opt-in maximum

__global__ void __launch_bounds__(kThreads)
seed_gate_kernel(const uint8_t* __restrict__ codes, int64_t n,
                 const int16_t* __restrict__ w,
                 const int32_t* __restrict__ thr,
                 const int32_t* __restrict__ lengths, int Lmax, int alpha,
                 int P, int eos, const int64_t* __restrict__ mb_count,
                 const int64_t* __restrict__ mb_idx, int64_t cap_mb,
                 const int32_t* __restrict__ gbits,
                 const int32_t* __restrict__ glen,
                 const int32_t* __restrict__ gdir, int Lg, int k, int band,
                 int indels, int gate_words, int text_bytes, int pc,
                 int32_t* __restrict__ out, int64_t cap) {
  // shared layout: [gate bits][thr][jend][rem][weights][warp texts]
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* gbits_s = reinterpret_cast<int32_t*>(smem);
  int32_t* thr_s = gbits_s + gate_words;
  int32_t* jend_s = thr_s + pc;
  int32_t* rem_s = jend_s + pc;
  int16_t* w_s = reinterpret_cast<int16_t*>(rem_s + pc * Lmax);
  uint8_t* txt =
      reinterpret_cast<uint8_t*>(w_s + pc * Lmax * alpha) +
      (threadIdx.x >> 5) * text_bytes;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool single = pc >= P;
  const int row = Lmax * alpha;
  const int span = 32 + Lmax - 1;
  int64_t live = *mb_count;
  if (live > cap_mb) live = cap_mb;
  const int64_t ntiles = (live + kWarps - 1) / kWarps;
  if (static_cast<int64_t>(blockIdx.x) >= ntiles) return;  // block-uniform

  const Gate g{gate_words ? gbits_s : gbits, glen, gdir, Lg, k,
               band, indels != 0, gate_words != 0};
  for (int i = threadIdx.x; i < gate_words; i += blockDim.x) {
    gbits_s[i] = gbits[i];
  }
  if (single) {
    stage_chunk(w, thr, Lmax, alpha, P, 0, P, thr_s, jend_s, w_s, rem_s);
  } else {
    __syncthreads();  // the gate bits are staged
  }
  int32_t* anchors = out + 1;
  int32_t* sids = out + 1 + cap;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t i = tile * kWarps + warp;
    const bool active = i < live;
    const int64_t t0 = active ? mb_idx[i] * 32 : 0;
    __syncwarp();  // the warp's previous readers are done with txt
    for (int x = lane; x < span; x += 32) {
      const int64_t pos = t0 + x;
      txt[x] = (active && pos < n) ? codes[pos] : static_cast<uint8_t>(eos);
    }
    __syncwarp();
    const int64_t t = t0 + lane;
    const bool on = active && t < n;
    for (int p0 = 0; p0 < P; p0 += pc) {
      const int pc_cur = P - p0 < pc ? P - p0 : pc;
      if (!single) {
        __syncthreads();  // every warp is done with the previous chunk
        stage_chunk(w, thr, Lmax, alpha, P, p0, pc_cur, thr_s, jend_s, w_s,
                    rem_s);
      }
      if (!on) continue;
      for (int pl = 0; pl < pc_cur; ++pl) {
        if (!sat::window_hits(txt + lane, w_s + pl * row, rem_s + pl * Lmax,
                              thr_s[pl], jend_s[pl], alpha)) {
          continue;
        }
        const int s = p0 + pl;
        const int64_t anchor = t + __ldg(lengths + s);
        if (!gate_ok(codes, n, anchor, s, g)) continue;
        const int slot = atomicAdd(out, 1);
        if (slot < cap) {
          anchors[slot] = static_cast<int32_t>(anchor);
          sids[slot] = s;
        }
      }
    }
  }
}

LaunchCache g_launch;

}  // namespace

// Survivors of the seed scan and gate into out[0 .. 1 + 2 cap): out[0] the
// true count (the caller zeroes it first), out[1 ..] the anchors,
// out[1 + cap ..] the seed ids.  codes [>= n] uint8 (codes < alpha),
// w [Lmax, alpha, P] int16, thr/lengths [P] int32, mb_count one int64 and
// mb_idx [cap_mb] int64 on the device, gate bits [P, Lg], glen [P],
// gdir [P] int32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_seed_gate(const void* codes, int64_t n, const void* w,
                             const void* thr, const void* lengths, int Lmax,
                             int alpha, int P, int eos, const void* mb_count,
                             const void* mb_idx, int64_t cap_mb,
                             const void* gbits, const void* glen,
                             const void* gdir, int Lg, int k, int band,
                             int indels, void* out, int64_t cap,
                             void* stream) {
  if (cap_mb <= 0) return 0;
  if (Lmax < 1 || alpha < 1 || alpha > 256 || P < 1 || eos < 0 ||
      eos >= alpha || Lg < 1 || k < 0 || band < 0 || band > kMaxBand ||
      cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int text_bytes = round_up(32 + Lmax - 1, 16);
  const int text_all = kWarps * text_bytes;
  const int64_t gate_bytes = static_cast<int64_t>(P) * Lg * 4;
  const int gate_words =
      gate_bytes <= kGateSmemMax ? static_cast<int>(gate_bytes / 4) : 0;
  const int per = per_pattern_bytes(Lmax, alpha);
  int pc = (kSmemBudget - text_all - gate_words * 4) / per;
  if (pc < 1) pc = 1;
  if (pc > P) pc = P;
  const int smem = gate_words * 4 + pc * per + text_all;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int64_t grid = 0;
  const cudaError_t err =
      full_grid(seed_gate_kernel, kThreads, smem, g_launch, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = (cap_mb + kWarps - 1) / kWarps;
  if (grid > ntiles) grid = ntiles;
  seed_gate_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n,
      static_cast<const int16_t*>(w), static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(lengths), Lmax, alpha, P, eos,
      static_cast<const int64_t*>(mb_count),
      static_cast<const int64_t*>(mb_idx), cap_mb,
      static_cast<const int32_t*>(gbits), static_cast<const int32_t*>(glen),
      static_cast<const int32_t*>(gdir), Lg, k, band, indels, gate_words,
      text_bytes, pc, static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
