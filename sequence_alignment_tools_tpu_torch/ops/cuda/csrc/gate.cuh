// The banded extension gate of the pigeonhole (k > 0) engines, shared by
// seed_gate.cu (seed enumeration and gate, fused) and gate_slots.cu (gate
// over a slot list): the one gate recurrence of the kernels, equal to
// ops/gate.py::gate_ok_ref, edge rules included.  The window's text comes
// through a reader: device memory (GlobalText), or text a kernel staged
// in shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sat {

constexpr int kMaxBand = 8;
constexpr int kMaxW = 2 * kMaxBand + 1;
constexpr int kSentinel = 30;  // a code no accept bit matches

struct Gate {
  const int32_t* bits;  // [S, Lg], in shared memory when `shared`
  const int32_t* glen;
  const int32_t* gdir;
  int Lg, k, band;
  bool indels, shared;
};

// Text code at idx from device memory, the sentinel outside [0, n).
struct GlobalText {
  const uint8_t* __restrict__ codes;
  int64_t n;
  __device__ __forceinline__ int operator()(int64_t idx) const {
    return (idx >= 0 && idx < n) ? __ldg(codes + idx) : kSentinel;
  }
};

// The banded anchored edit distance of seed s's extension pattern at
// `anchor` is at most k.  D[d] holds dp[p][p + d - band], saturated at
// INF = k + 1; a row is updated in place in ascending d, since cell d
// reads the old cells d and d + 1 and the new cell d - 1.  Window slot j
// reads anchor + j (gdir > 0) or anchor + gdir - j; text outside [0, n)
// reads the sentinel (`text` returns it).
template <class Text>
__device__ inline bool gate_ok(const Text& text, int64_t anchor, int s,
                               const Gate& g) {
  const int glen = __ldg(g.glen + s);
  if (glen == 0) return true;
  const int gdir = __ldg(g.gdir + s);
  const int INF = g.k + 1;
  const int W = 2 * g.band + 1;
  const int Wg = g.Lg + g.band;
  int D[kMaxW];
#pragma unroll
  for (int d = 0; d < kMaxW; ++d) {
    int v = INF;
    if (g.indels) {
      if (d >= g.band) v = min(d - g.band, INF);
    } else if (d == g.band) {
      v = 0;
    }
    D[d] = v;
  }
  const int32_t* brow = g.bits + static_cast<int64_t>(s) * g.Lg;
  int rowmin = INF;
  for (int p = 1; p <= glen; ++p) {
    const int acc = g.shared ? brow[p - 1] : __ldg(brow + p - 1);
    int prev = INF;
    rowmin = INF;
#pragma unroll
    for (int d = 0; d < kMaxW; ++d) {
      if (d < W) {
        const int tpos = p + d - g.band;
        const int next = d + 1 < kMaxW ? D[d + 1 < kMaxW ? d + 1 : d] : INF;
        int v;
        if (tpos == 0 && g.indels && d + 1 < W) {
          v = min(next + 1, INF);  // leading deletion: dp[p][0] = p
        } else if (tpos < 1 || tpos > Wg) {
          v = INF;
        } else {
          const int64_t j = tpos - 1;
          const int64_t idx = gdir > 0 ? anchor + j : anchor + gdir - j;
          const int c = text(idx);
          const int match = c < 31 ? (acc >> c) & 1 : 0;
          v = D[d] + (match ? 0 : 1);
          if (g.indels) {
            if (d + 1 < W) v = min(v, next + 1);  // deletion
            if (d > 0) v = min(v, prev + 1);      // insertion
          }
          v = min(v, INF);
        }
        D[d] = v;
        prev = v;
        rowmin = min(rowmin, v);
      }
    }
    // a saturated row stays saturated: every later cell is >= INF
    if (rowmin > g.k) return false;
  }
  return true;
}

__device__ inline bool gate_ok(const uint8_t* __restrict__ codes, int64_t n,
                               int64_t anchor, int s, const Gate& g) {
  return gate_ok(GlobalText{codes, n}, anchor, s, g);
}

}  // namespace sat
