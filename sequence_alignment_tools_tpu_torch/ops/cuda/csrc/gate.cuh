// The banded extension gate of the pigeonhole (k > 0) engines, shared by
// seed_gate.cu (seed enumeration and gate, fused) and gate_slots.cu (gate
// over a slot list): the one gate recurrence of the kernels, equal to
// ops/gate.py::gate_ok_ref, edge rules included.
//
// The band is a compile-time constant B (the engines use k with indels,
// 0 without), so a row is exactly 2 B + 1 cells with no per-cell test of
// the band or of indels, and without indels (or at B = 0) the gate is a
// count of mismatches along the diagonal, stopping at k + 1.  Window slot
// j of a row is read once: row p reads slots p - 1 - B .. p - 1 + B, so a
// row shifts a window of 2 B + 1 codes by one and reads one new code.  The
// text comes through the kernel's reader (seed_gate.cu's staged text).  A
// kernel compiles one instance per band, so only the row of its band sits
// in its loop.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sat {

constexpr int kMaxBand = 8;
constexpr int kSentinel = 30;  // a code no accept bit matches

struct Gate {
  const int32_t* bits;  // [S, Lg], in shared memory when `shared`
  const int32_t* glen;
  const int32_t* gdir;
  int Lg, k;
  bool shared;
};

// 1 when accept word `acc` rejects code c.  Accept words hold bits below
// 30 only, so the sentinel (30) and any code past it never match.
__device__ __forceinline__ int gate_miss(uint32_t acc, int c) {
  return static_cast<int>(((acc >> min(c, 31)) & 1u) ^ 1u);
}

// The first row's input of the banded DP with indels: D[d] =
// dp[0][d - B] = d - B for d >= B (saturated at inf), inf below.
template <int B>
__device__ __forceinline__ void band_init(int (&D)[2 * B + 1], int inf) {
#pragma unroll
  for (int d = 0; d < 2 * B + 1; ++d) D[d] = d >= B ? min(d - B, inf) : inf;
}

// Row p (1-based) of the banded anchored edit distance with indels, band
// B.  On entry D[d] holds dp[p - 1][p - 1 + d - B], on exit dp[p][p + d -
// B], saturated at inf = k + 1; a row is updated in place in ascending d,
// since cell d reads the old cells d and d + 1 and the new cell d - 1.
// win[d] is the text code at window slot j = p - 1 - B + d (text position
// t = j + 1); a cell with t = 0 is the leading-deletion column dp[p][0] =
// p, a cell with t < 0 lies outside the matrix.  Returns the row's
// minimum: the extension dies when it exceeds k, since a saturated row
// stays saturated.
template <int B>
__device__ __forceinline__ int band_row(int (&D)[2 * B + 1],
                                        const int (&win)[2 * B + 1],
                                        uint32_t acc, int p, int inf) {
  constexpr int W = 2 * B + 1;
  int prev = inf;
  int rowmin = inf;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const int next = d + 1 < W ? D[d + 1 < W ? d + 1 : d] : inf;
    int v = D[d] + gate_miss(acc, win[d]);
    if (d + 1 < W) v = min(v, next + 1);  // deletion
    if (d > 0) v = min(v, prev + 1);      // insertion
    if (d < B) {                          // t = p + d - B can be < 1
      const int t = p + d - B;
      if (t == 0) v = next + 1;           // dp[p][0] = p
      if (t < 0) v = inf;
    }
    v = min(v, inf);
    D[d] = v;
    prev = v;
    rowmin = min(rowmin, v);
  }
  return rowmin;
}

// Shift the window by one slot and put `c` at its end.
template <int B>
__device__ __forceinline__ void band_shift(int (&win)[2 * B + 1], int c) {
#pragma unroll
  for (int d = 0; d < 2 * B; ++d) win[d] = win[d + 1];
  win[2 * B] = c;
}

// The gate of seed s's extension at `anchor`, glen > 0 rows, window slot j
// at text position base + step j, accept word of row p at brow[p - 1]:
// true when the banded anchored edit distance (B > 0) or the mismatch
// count (B = 0) is at most k.
template <int B, class Text>
__device__ bool gate_rows(const Text& text, int64_t base, int step,
                          const int32_t* brow, bool shared, int glen,
                          int k) {
  const int inf = k + 1;
  if constexpr (B == 0) {
    int miss = 0;
    for (int p = 1; p <= glen; ++p) {
      const uint32_t acc = shared ? brow[p - 1] : __ldg(brow + p - 1);
      miss += gate_miss(acc, text(base + step * (p - 1)));
      if (miss > k) return false;
    }
    return true;
  } else {
    int D[2 * B + 1];
    int win[2 * B + 1];
    band_init<B>(D, inf);
#pragma unroll
    for (int d = 0; d <= B; ++d) win[d] = kSentinel;  // slots below 0
#pragma unroll
    for (int j = 0; j < B; ++j) win[B + 1 + j] = text(base + step * j);
    for (int p = 1; p <= glen; ++p) {
      band_shift<B>(win, text(base + step * (p - 1 + B)));
      const uint32_t acc = shared ? brow[p - 1] : __ldg(brow + p - 1);
      if (band_row<B>(D, win, acc, p, inf) > k) return false;
    }
    return true;
  }
}

// The banded anchored edit distance (band B) of seed s's extension
// pattern at `anchor` is at most k.  Window slot j reads anchor + j (gdir
// > 0) or anchor + gdir - j; text outside [0, n) reads the sentinel
// (`text` returns it).
template <int B, class Text>
__device__ inline bool gate_ok(const Text& text, int64_t anchor, int s,
                               const Gate& g) {
  const int glen = __ldg(g.glen + s);
  if (glen == 0) return true;
  const int gdir = __ldg(g.gdir + s);
  return gate_rows<B>(text, gdir > 0 ? anchor : anchor + gdir,
                      gdir > 0 ? 1 : -1,
                      g.bits + static_cast<int64_t>(s) * g.Lg, g.shared,
                      glen, g.k);
}

}  // namespace sat
