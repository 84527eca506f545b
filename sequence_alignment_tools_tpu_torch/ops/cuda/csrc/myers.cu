// Myers bit-vector k-edit scan of the filter engine, for sm_90a.
//
// Replaces the Pallas TPU kernel
// sequence_alignment_tools_tpu/ops/pallas/myers_kernel.py::_myers_kernel
// (launched by pallas_myers_kernel) together with its XLA epilogue
// pallas_myers_epilogue.  Contract, which the plain PyTorch version
// myers.py::myers_pairs_ref states too: every pair (pos, p) such that the
// semi-global Levenshtein distance of pattern p against some text
// substring ending at position pos (boundary pos + 1) is at most k, with
// the Sellers EOS rule: an EOS character resets the state to a fresh start
// and never ends a hit (every pattern is longer than k).  Pairs go to
// out[1 ..] (positions) and out[1 + cap ..] (pattern ids) through an atomic
// counter, in no order; out[0] always receives the true number, so the host
// retries with a larger cap when it exceeds cap.
//
// Recurrence per text character (Myers 1999, free text start), per word:
//   Eq = eq[code];  Xv = Eq | Mv;  Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq
//   Ph = Mv | ~(Xh | Pv);  Mh = Pv & Xh
//   score += bit top of Ph;  score -= bit top of Mh
//   Ph <<= 1;  Mh <<= 1;  Pv = Mh | ~(Xv | Ph);  Mv = Ph & Xv
// Two patterns share one 32-bit word (field A at bits [0, la), a zero
// guard bit at la, field B from la + 1): the add's carry dies at the guard,
// and the bit that the shift moves from the guard into field B is cleared.
//
// The TPU layout (segment-transposed [tiles, groups, 256, 128] text planes,
// (8, 128) lane shuffles, in-kernel slot compaction) has no counterpart.
// What bounds this kernel on an H100: integer instructions, about 17 per
// word per character, not device memory (one byte per character).  The
// design:
//   - one thread per text segment of `segc` positions, which first walks a
//     warm-up halo of Lmax + k characters from a fresh state: a <= k-edit
//     alignment spans at most Lmax + k characters, so every value <= k is
//     exact after it;
//   - the (Pv, Mv, score) state of every word lives in registers (a
//     template bound MAXW on the word count, the loops fully unrolled);
//   - the per-word constants (masks, top bits, pattern ids) are kernel
//     parameters, uniform across the warp; the Eq words are indexed by
//     code from a [256, nw] table in shared memory;
//   - a warp vote skips the hit emission unless a lane hit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWords = 32;

template <int MAXW>
struct Words {
  uint32_t ones[MAXW];
  uint32_t smask[MAXW];
  int32_t top_a[MAXW];
  int32_t top_b[MAXW];
  int32_t pa[MAXW];
  int32_t pb[MAXW];
  int32_t la[MAXW];
  int32_t lb[MAXW];
};

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
myers_kernel(const uint8_t* __restrict__ codes, int64_t n,
             const uint32_t* __restrict__ eq, const Words<MAXW> ws, int nw,
             int eos, int k, int segc, int halo, int64_t nseg,
             int32_t* __restrict__ out, int64_t cap) {
  extern __shared__ uint32_t eq_s[];  // [256][nw]
  for (int i = threadIdx.x; i < 256 * nw; i += blockDim.x) eq_s[i] = eq[i];
  __syncthreads();

  const int64_t seg = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool live = seg < nseg;
  const int64_t own0 = seg * segc;
  const int64_t start = own0 - halo;

  uint32_t pv[MAXW], mv[MAXW];
  int sa[MAXW], sb[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    pv[w] = ws.ones[w];
    mv[w] = 0;
    sa[w] = ws.la[w];
    sb[w] = ws.lb[w];
  }
  int32_t* pos_out = out + 1;
  int32_t* pid_out = out + 1 + cap;

  // every lane runs the same number of steps, so the warp vote is uniform
  const int steps = halo + segc;
  for (int j = 0; j < steps; ++j) {
    const int64_t pos = start + j;
    const int c = (live && pos >= 0 && pos < n) ? __ldg(codes + pos) : eos;
    const uint32_t* er = eq_s + c * nw;
    int best = INT_MAX;
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < nw) {
        const uint32_t e = er[w];
        const uint32_t p = pv[w];
        const uint32_t m = mv[w];
        const uint32_t xv = e | m;
        const uint32_t xh = (((e & p) + p) ^ p) | e;
        uint32_t ph = m | ~(xh | p);
        uint32_t mh = p & xh;
        sa[w] += static_cast<int>((ph >> ws.top_a[w]) & 1u) -
                 static_cast<int>((mh >> ws.top_a[w]) & 1u);
        best = min(best, sa[w]);
        if (ws.pb[w] >= 0) {
          sb[w] += static_cast<int>((ph >> ws.top_b[w]) & 1u) -
                   static_cast<int>((mh >> ws.top_b[w]) & 1u);
          best = min(best, sb[w]);
        }
        ph = (ph << 1) & ws.smask[w];
        mh = (mh << 1) & ws.smask[w];
        pv[w] = (mh | ~(xv | ph)) & ws.ones[w];
        mv[w] = (ph & xv) & ws.ones[w];
      }
    }
    if (c == eos) {
      // a fresh start: Sellers allows no error move on EOS
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        pv[w] = ws.ones[w];
        mv[w] = 0;
        sa[w] = ws.la[w];
        sb[w] = ws.lb[w];
      }
      best = INT_MAX;
    }
    const bool hit = live && pos >= own0 && pos < n && best <= k;
    if (__any_sync(0xffffffffu, hit) && hit) {
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        if (w < nw) {
          if (sa[w] <= k) {
            const int slot = atomicAdd(out, 1);
            if (slot < cap) {
              pos_out[slot] = static_cast<int32_t>(pos);
              pid_out[slot] = ws.pa[w];
            }
          }
          if (ws.pb[w] >= 0 && sb[w] <= k) {
            const int slot = atomicAdd(out, 1);
            if (slot < cap) {
              pos_out[slot] = static_cast<int32_t>(pos);
              pid_out[slot] = ws.pb[w];
            }
          }
        }
      }
    }
  }
}

template <int MAXW>
int launch(const void* codes, int64_t n, const void* eq,
           const int32_t* words, int nw, int eos, int k, int segc, int halo,
           void* out, int64_t cap, cudaStream_t stream) {
  Words<MAXW> ws{};
  for (int w = 0; w < MAXW; ++w) {
    const bool on = w < nw;
    const int pa = on ? words[4 * w] : 0;
    const int pb = on ? words[4 * w + 1] : -1;
    const int la = on ? words[4 * w + 2] : 1;
    const int lb = on && pb >= 0 ? words[4 * w + 3] : 0;
    uint64_t ones = (1ull << la) - 1;
    uint64_t smask = 0xffffffffull;
    if (pb >= 0) {
      ones |= ((1ull << lb) - 1) << (la + 1);
      smask &= ~(1ull << (la + 1));
    }
    ws.ones[w] = static_cast<uint32_t>(ones);
    ws.smask[w] = static_cast<uint32_t>(smask);
    ws.top_a[w] = la - 1;
    ws.top_b[w] = pb >= 0 ? la + lb : 0;
    ws.pa[w] = pa;
    ws.pb[w] = pb;
    ws.la[w] = la;
    ws.lb[w] = pb >= 0 ? lb : INT_MAX / 2;
  }
  const int64_t nseg = (n + segc - 1) / segc;
  const int64_t blocks = (nseg + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(256) * nw * sizeof(uint32_t);
  myers_kernel<MAXW><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const uint8_t*>(codes), n,
      static_cast<const uint32_t*>(eq), ws, nw, eos, k, segc, halo, nseg,
      static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Candidate pairs of the Myers scan into out[0 .. 1 + 2 cap): out[0] the
// true count (the caller zeroes it first), out[1 ..] the 0-based end
// positions, out[1 + cap ..] the pattern ids.  codes [>= n] uint8 and
// eq [256, nw] uint32 on the device; words [nw, 4] int32 on the host:
// (pattern A, pattern B or -1, length A, length B) per word, every field
// length in [1, 31] and la + 1 + lb <= 32 for pairs.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sat_myers_pairs(const void* codes, int64_t n, const void* eq,
                               const int32_t* words, int nw, int eos, int k,
                               int segc, int halo, void* out, int64_t cap,
                               void* stream) {
  if (n < 1) return 0;
  if (nw < 1 || nw > kMaxWords || eos < 0 || eos > 255 || k < 0 ||
      segc < 1 || halo < 0 || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int w = 0; w < nw; ++w) {
    const int la = words[4 * w + 2];
    const int lb = words[4 * w + 3];
    if (la < 1 || la > 31 || (words[4 * w + 1] >= 0 &&
                              (lb < 1 || la + 1 + lb > 32))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (nw <= 4) return launch<4>(codes, n, eq, words, nw, eos, k, segc, halo,
                                out, cap, s);
  if (nw <= 8) return launch<8>(codes, n, eq, words, nw, eos, k, segc, halo,
                                out, cap, s);
  if (nw <= 16) return launch<16>(codes, n, eq, words, nw, eos, k, segc,
                                  halo, out, cap, s);
  return launch<32>(codes, n, eq, words, nw, eos, k, segc, halo, out, cap,
                    s);
}
