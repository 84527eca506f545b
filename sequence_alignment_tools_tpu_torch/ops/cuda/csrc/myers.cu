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
// Two patterns may share one 32-bit word (the host layout of myers_eqbits:
// field A at bits [0, la), a zero guard bit at la, field B from la + 1).
//
// The TPU layout (segment-transposed text planes, (8, 128) lane shuffles,
// in-kernel slot compaction) has no counterpart.  What bounds this kernel
// on an H100 is instruction issue: the integer ALU pipe takes 64 lanes per
// SM and clock, and every word step of the first form of this kernel
// issued 24 ALU instructions of 36, the score updates (two shift-and-mask
// extractions per field, a min) as many as Myers' step.  This form:
//   - moves field B to the top of the word when it stages the Eq rows
//     (field A stays at [0, la), B at [32 - lb, 32)), and sets every bit
//     between or above the fields in each Eq row: Xh is then 1 there, so
//     Ph and Mh are 0 there, the add's carry stops in the gap, and no bit
//     crosses into field B.  Only Pv and Mv need the field mask;
//   - keeps each score biased by -(k + 1), so that a hit is a negative
//     score: one 3-input OR per word folds both fields into a word whose
//     sign says "some pattern hit", one test per character;
//   - reads the score deltas off bit 31: field B's top is bit 31, so an
//     arithmetic shift of Ph or Mh by 31 gives 0 or -1, and one 3-input
//     add per field applies both; field A's top is first moved to bit 31
//     by a multiply by 2^(31 - top_a).  A singleton's or a padding word's
//     bit 31 lies in its gap, where Ph and Mh are 0.  The multipliers
//     (and the 1 of the add, the 2 of the shifts left) are kernel
//     parameters, so the compiler keeps them as IMADs, which issue beside
//     the ALU's LOP3s (multiply-highs in their place were slower: the
//     compiler added a move to each signed one);
//   - one template per exact word count (1 to 16, then 20, 24, 28, 32 with
//     inert padding words), loops fully unrolled, no per-word guards;
//   - each thread reads its text 16 characters at a time with one 128-bit
//     load (32-bit offsets, segments aligned to 16), and tests each 4-code
//     group for EOS with one has-zero-byte test and a warp vote: a warp
//     whose lanes see no EOS runs the 4 characters without the reset
//     (the common case; a reset inline would be executed as selects on
//     every character);
//   - the Eq rows of a code are 16-byte aligned in shared memory (stride
//     a multiple of 4 words, an odd number of 16-byte chunks), one 128-bit
//     load per four words;
//   - one thread per text segment of `segc` positions, which first walks a
//     warm-up halo of at least Lmax + k characters from a fresh state: a
//     <= k-edit alignment spans at most Lmax + k characters, so every value
//     <= k is exact after it; a warp vote skips the hit decode unless a
//     lane hit, and a lane that hit reserves its pairs with one atomic.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWords = 32;
constexpr int kInert = 1 << 24;  // the biased score of an absent field

// Per-word constants, uniform across the grid (kernel parameters).
template <int NW>
struct Words {
  uint32_t ones[NW];  // both fields' bits in the kernel's layout
  uint32_t mul_a[NW];  // 2^(31 - top_a): field A's top bit to bit 31
  uint32_t gap[NW];    // the bits set in every staged Eq row (all of a
                       // padding word's: its Ph and Mh stay 0)
  int32_t s0a[NW];     // fresh biased scores: la - (k + 1), lb - (k + 1)
  int32_t s0b[NW];
  int32_t pa[NW];
  int32_t pb[NW];
  int32_t la[NW];      // field lengths in the host layout (staging)
  int32_t lb[NW];
  uint32_t one, two;   // 1 and 2, opaque to the compiler (IMADs)
};

// The Eq row stride in words: a multiple of 4 with an odd number of
// 16-byte chunks, so that rows of different codes start in different banks.
template <int NW>
__host__ __device__ constexpr int eq_stride() {
  return ((NW + 3) / 4) % 2 == 1 ? (NW + 3) / 4 * 4 : (NW + 3) / 4 * 4 + 4;
}

// 16 text codes from position p (a multiple of 16), EOS outside [0, n) and
// for a thread without a segment.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ codes,
                                        int n, int p, uint32_t eos,
                                        bool live) {
  if (live && p >= 0 && p + 16 <= n) {
    return __ldg(reinterpret_cast<const uint4*>(codes) + (p >> 4));
  }
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int pos = p + 4 * q + b;
      const uint32_t c = (live && pos >= 0 && pos < n) ? codes[pos] : eos;
      v |= c << (8 * b);
    }
    w[q] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
myers_kernel(const uint8_t* __restrict__ codes, int n,
             const uint32_t* __restrict__ eq, const Words<NW> ws, int nw,
             int eos, int segc, int halo, int nseg,
             int32_t* __restrict__ out, int64_t cap) {
  constexpr int S = eq_stride<NW>();
  __shared__ __align__(16) uint32_t eq_s[256 * S];
  // stage the Eq rows in the kernel's layout: B moved to the top, the gap
  // bits set (every bit of a padding word)
  for (int i = threadIdx.x; i < 256 * S; i += blockDim.x) {
    const int c = i / S;
    const int w = i - c * S;
    uint32_t v = 0;
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      if (x == w) v = ws.gap[x];
      if (x == w && x < nw) {
        const uint32_t e = eq[c * nw + x];
        const int la = ws.la[x];
        const uint32_t a = e & ((1u << la) - 1u);
        const uint32_t b = ws.lb[x] > 0
            ? (e >> (la + 1)) << (32 - ws.lb[x]) : 0u;
        v = a | b | ws.gap[x];
      }
    }
    eq_s[i] = v;
  }
  __syncthreads();

  const int seg = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = seg < nseg;
  const int start = seg * segc - halo;  // a multiple of 16
  const int steps = halo + segc;        // the same in every lane
  const uint32_t eos4 = static_cast<uint32_t>(eos) * 0x01010101u;

  uint32_t pv[NW], mv[NW];
  int sa[NW], sb[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    pv[w] = ws.ones[w];
    mv[w] = 0;
    sa[w] = ws.s0a[w];
    sb[w] = ws.s0b[w];
  }

  // one character: Myers' step on every word; returns the OR of the
  // biased scores (negative iff some pattern hit)
  auto step = [&](uint32_t c) {
    const uint4* row = reinterpret_cast<const uint4*>(eq_s + c * S);
    uint32_t e[(NW + 3) / 4 * 4];
#pragma unroll
    for (int r = 0; r < (NW + 3) / 4; ++r) {
      const uint4 t = row[r];
      e[4 * r] = t.x;
      e[4 * r + 1] = t.y;
      e[4 * r + 2] = t.z;
      e[4 * r + 3] = t.w;
    }
    int acc = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t p = pv[w];
      const uint32_t m = mv[w];
      const uint32_t xv = e[w] | m;
      const uint32_t sum = (e[w] & p) * ws.one + p;
      const uint32_t xh = (sum ^ p) | e[w];
      const uint32_t ph = m | ~(xh | p);
      const uint32_t mh = p & xh;
      // top bits: +1 for Ph, -1 for Mh (bit 31, as 0 or -1 by an
      // arithmetic shift)
      sa[w] += (static_cast<int>(mh * ws.mul_a[w]) >> 31) -
               (static_cast<int>(ph * ws.mul_a[w]) >> 31);
      sb[w] += (static_cast<int>(mh) >> 31) - (static_cast<int>(ph) >> 31);
      acc |= sa[w] | sb[w];
      const uint32_t phs = ph * ws.two;
      const uint32_t mhs = mh * ws.two;
      pv[w] = (mhs | ~(xv | phs)) & ws.ones[w];
      mv[w] = phs & xv & ws.ones[w];
    }
    return acc;
  };
  // a fresh start: Sellers allows no error move on EOS
  auto reset = [&]() {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      pv[w] = ws.ones[w];
      mv[w] = 0;
      sa[w] = ws.s0a[w];
      sb[w] = ws.s0b[w];
    }
  };
  // the pairs of a character where some lane hit: one counter reservation
  // per lane (past n the text reads EOS, which never ends a hit)
  auto emit = [&](int acc, int j) {
    if (!__any_sync(0xffffffffu, acc < 0) || acc >= 0 || j < halo) return;
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) cnt += (sa[w] < 0) + (sb[w] < 0);
    int o = atomicAdd(out, cnt);
    const int32_t pos = start + j;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (sa[w] < 0) {
        if (o < cap) {
          out[1 + o] = pos;
          out[1 + cap + o] = ws.pa[w];
        }
        ++o;
      }
      if (sb[w] < 0) {
        if (o < cap) {
          out[1 + o] = pos;
          out[1 + cap + o] = ws.pb[w];
        }
        ++o;
      }
    }
  };

  uint4 next = load16(codes, n, start, eos, live);
  for (int g = 0; g < steps; g += 16) {
    uint4 v = next;
    if (g + 16 < steps) next = load16(codes, n, start + g + 16, eos, live);
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const uint32_t word = v.x;
      v.x = v.y;
      v.y = v.z;
      v.z = v.w;
      const uint32_t z = word ^ eos4;
      const bool has_eos = ((z - 0x01010101u) & ~z & 0x80808080u) != 0;
      const int j0 = g + 4 * q;
      if (!__any_sync(0xffffffffu, has_eos)) {
        // the common case: no EOS in the warp's 4 codes
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          emit(step((word >> (8 * b)) & 0xffu), j0 + b);
        }
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t c = (word >> (8 * b)) & 0xffu;
          int acc = step(c);
          if (c == static_cast<uint32_t>(eos)) {
            reset();
            acc = 0;
          }
          emit(acc, j0 + b);
        }
      }
    }
  }
}

template <int NW>
int launch(const void* codes, int n, const void* eq, const int32_t* words,
           int nw, int eos, int k, int segc, int halo, void* out,
           int64_t cap, cudaStream_t stream) {
  Words<NW> ws{};
  ws.one = 1;
  ws.two = 2;
  for (int w = 0; w < NW; ++w) {
    const bool on = w < nw;
    const bool pair = on && words[4 * w + 1] >= 0;
    const int la = on ? words[4 * w + 2] : 1;
    const int lb = pair ? words[4 * w + 3] : 0;
    const uint64_t ma = on ? (1ull << la) - 1 : 0;
    const uint64_t mb = pair ? ((1ull << lb) - 1) << (32 - lb) : 0;
    ws.ones[w] = static_cast<uint32_t>(ma | mb);
    ws.gap[w] = static_cast<uint32_t>(~(ma | mb));
    ws.mul_a[w] = on ? 1u << (32 - la) : 0u;  // top_a = la - 1
    ws.s0a[w] = on ? la - (k + 1) : kInert;
    ws.s0b[w] = pair ? lb - (k + 1) : kInert;
    ws.pa[w] = on ? words[4 * w] : -1;
    ws.pb[w] = pair ? words[4 * w + 1] : -1;
    ws.la[w] = la;
    ws.lb[w] = lb;
  }
  const int nseg = (n + segc - 1) / segc;
  const int blocks = (nseg + kThreads - 1) / kThreads;
  myers_kernel<NW><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(codes), n,
      static_cast<const uint32_t*>(eq), ws, nw, eos, segc, halo, nseg,
      static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, int, const void*, const int32_t*, int,
                       int, int, int, int, void*, int64_t, cudaStream_t);

// the instance for nw words: exact up to 16, then padded to a multiple of 4
Launch pick(int nw) {
  static const Launch exact[16] = {
      launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
      launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
      launch<13>, launch<14>, launch<15>, launch<16>};
  if (nw <= 16) return exact[nw - 1];
  if (nw <= 20) return launch<20>;
  if (nw <= 24) return launch<24>;
  if (nw <= 28) return launch<28>;
  return launch<32>;
}

}  // namespace

// Candidate pairs of the Myers scan into out[0 .. 1 + 2 cap): out[0] the
// true count (the caller zeroes it first), out[1 ..] the 0-based end
// positions, out[1 + cap ..] the pattern ids.  codes [>= n] uint8 (16-byte
// aligned) and eq [256, nw] uint32 on the device; words [nw, 4] int32 on
// the host: (pattern A, pattern B or -1, length A, length B) per word,
// every field length in [1, 31], la + 1 + lb <= 32 for pairs, and every
// length above k.  segc and halo (>= Lmax + k) are rounded up to multiples
// of 16.  Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_myers_pairs(const void* codes, int64_t n, const void* eq,
                               const int32_t* words, int nw, int eos, int k,
                               int segc, int halo, void* out, int64_t cap,
                               void* stream) {
  if (n < 1) return 0;
  if (nw < 1 || nw > kMaxWords || eos < 0 || eos > 255 || k < 0 ||
      segc < 1 || halo < 0 || cap < 1 ||
      (reinterpret_cast<uintptr_t>(codes) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int w = 0; w < nw; ++w) {
    const int la = words[4 * w + 2];
    const int lb = words[4 * w + 3];
    const bool pair = words[4 * w + 1] >= 0;
    if (la < 1 || la > 31 || la <= k ||
        (pair && (lb < 1 || lb <= k || la + 1 + lb > 32))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  segc = (segc + 15) / 16 * 16;
  halo = (halo + 15) / 16 * 16;
  if (n + static_cast<int64_t>(segc) + halo >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return pick(nw)(codes, static_cast<int>(n), eq, words, nw, eos, k, segc,
                  halo, out, cap, static_cast<cudaStream_t>(stream));
}
