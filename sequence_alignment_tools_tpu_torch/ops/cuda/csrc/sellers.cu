// Sellers k-edit scan of the filter engine, for sm_90a: a block
// bit-parallel scan.
//
// Replaces the Pallas TPU kernel
// sequence_alignment_tools_tpu/ops/sellers.py::_sellers_kernel (launched
// by pallas_sellers_scan) together with its dense-pack epilogue and the
// host rescan of multi-pattern boundaries (rescan_boundaries).  Contract,
// which the plain PyTorch version sellers.py::sellers_ref states too: every
// triple (pos, p, d) with d = mindist(pos, p) <= k, where mindist is the
// semi-global edit distance of pattern p against some text substring
// ending at position pos (boundary pos + 1), capped at k + 1, under the
// EOS rules of the XLA _sellers_block: no substitution, deletion or
// insertion on an EOS character (so no alignment crosses one), an
// insertion chain of t characters only over t non-EOS characters.
// Triples go to out[1 ..], out[1 + cap ..], out[1 + 2 cap ..] through an
// atomic counter, in no order; out[0] always receives the true number.
//
// The TPU kernel kept one pattern id and a count per boundary and sent
// boundaries where several patterns fired, or whose row overflowed, to a
// numpy rescan; this kernel emits every pattern, so nothing escapes.
//
// The column DP: per text character c, with C the column of pattern
// prefixes (C[0] = 0, the free start),
//   C'[j] = min(C[j-1] + (p[j] accepts c ? 0 : 1),   diagonal
//               C'[j-1] + 1,                         pattern char deleted
//               C[j] + 1)                            text char inserted
// and an EOS character resets C to (0, inf, inf, ...).  Without indels
// only the diagonal term remains.
//
// What bounds it on an H100: integer instructions per (character,
// pattern).  The byte-cell form it replaces loaded and stored a byte of
// shared memory per live DP cell, read the text 8,192 bytes apart across
// a warp and walked a long pattern's whole column where it aligned.  The
// design:
//   - with indels, Myers' bit-vector recurrence over 32-bit words with
//     the block form of Ukkonen's cutoff (Myers 1999, section 4): a
//     pattern of m rows is ceil(m / 32) words of vertical deltas (P, M),
//     carried from word to word by the horizontal delta; only words up to
//     the last active one (y) are advanced, y grows by one when the row
//     below it can reach <= k and shrinks while its bottom score is at
//     least k + 32, and only the score at y's last row is kept (a lower
//     word's is that minus its popcounts).  d is the score at row m, the
//     pattern's own top bit in its last word.  On random text one word is
//     active, and a character takes the hot path: one word update and two
//     compares; a stretch aligned with a long pattern costs m / 32 word
//     steps per character instead of m byte cells;
//   - the EOS rule as a column DP that reproduces the row DP's triples: a
//     fresh (0, 1, ..., m) column at every EOS and at the warm-up start,
//     on the first character after it only row 1 may match (the accept
//     word masked to its lowest bit in word 0, zero above), and nothing
//     reported at the EOS itself;
//   - without indels, bit-sliced saturating counters (1, 2, 4 or 8
//     planes a word, one instance each, from the bit length of k + 1):
//     shift by one row, add the mismatch word, saturate at k + 1; the same
//     active-word cutoff;
//   - one thread per (text segment, pattern), blockIdx.y the pattern; the
//     block's 128 segments are staged 32 characters at a time into shared
//     memory by coalesced 4-byte loads (rows of 9 words: a warp reads 32
//     rows without bank conflicts), so every segment runs the same
//     number of steps: a warm-up halo of at least Lmax + k characters
//     from a fresh column, then its own characters;
//   - the accept words per (pattern, word, code) are built once on the
//     host (sellers.py::SellersTables.peq) and sit in shared memory while
//     they fit, read through the read-only cache past that;
//   - word 0 lives in registers; words past it (a long pattern's, or any
//     word above the first once it activates) in a device scratch buffer
//     the wrapper allocates, laid out [word][thread of the launch] so a
//     warp's accesses coalesce; the cutoff keeps them cold on random text;
//   - segments are sized so the grid fills whole waves of the card's
//     resident blocks (sat_sellers_plan).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;               // text segments a block
constexpr int kTile = 32;                   // characters staged per row
constexpr int kRowWords = kTile / 4 + 1;    // 9 words a staged row
constexpr int kTileBytes = kThreads * kRowWords * 4;
constexpr int kSmemMax = 232448;            // sm_90 per-block opt-in max
constexpr uint32_t kOnes = 0xffffffffu;
constexpr uint32_t kHigh = 0x80000000u;
constexpr int kFirst = 1 << 30;              // flag on y: first character

// One word of Myers' block recurrence (Myers 1999, Fig. 9): advances the
// vertical deltas (P, M) of 32 rows by one text character whose accept
// word is eq, given the horizontal delta hin in {-1, 0, 1} entering at the
// word's lowest row; returns the delta leaving at the row of hmask.
__device__ __forceinline__ int advance(uint32_t& P, uint32_t& M, uint32_t eq,
                                       int hin, uint32_t hmask) {
  const uint32_t xv = eq | M;
  if (hin < 0) eq |= 1u;
  const uint32_t xh = (((eq & P) + P) ^ P) | eq;
  uint32_t ph = M | ~(xh | P);
  uint32_t mh = P & xh;
  const int hout = (ph & hmask) ? 1 : ((mh & hmask) ? -1 : 0);
  ph = (ph << 1) | static_cast<uint32_t>(hin > 0);
  mh = (mh << 1) | static_cast<uint32_t>(hin < 0);
  P = mh | ~(xv | ph);
  M = ph & xv;
  return hout;
}

// The bit-sliced counters without indels: kQ planes a word (plane i
// holds bit i of every row's count), counts saturating at s = k + 1 < 2^kQ
// (planes past the bit length of s stay zero).  sx[i] is all ones where
// bit i of s is 0, so a row holds s where every pl[i] ^ sx[i] is set.
template <int kQ>
__device__ __forceinline__ uint32_t saturated(const uint32_t* pl,
                                              const uint32_t* sx) {
  uint32_t e = kOnes;
#pragma unroll
  for (int i = 0; i < kQ; ++i) e &= pl[i] ^ sx[i];
  return e;
}

// One word of the counters: shift every row down by one (cin: the bits
// entering the lowest row, one per plane; on return the bits that left
// the top row), then add the mismatch word, saturating.
template <int kQ>
__device__ __forceinline__ void count_step(uint32_t* pl, uint32_t* cin,
                                           uint32_t mis,
                                           const uint32_t* sx) {
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const uint32_t out = pl[i] >> 31;
    pl[i] = (pl[i] << 1) | cin[i];
    cin[i] = out;
  }
  uint32_t cr = mis & ~saturated<kQ>(pl, sx);
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const uint32_t t = pl[i] & cr;
    pl[i] ^= cr;
    cr = t;
  }
}

// The count at bit `top` of the planes.
template <int kQ>
__device__ __forceinline__ int count_at(const uint32_t* pl, int top) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < kQ; ++i) v |= static_cast<int>((pl[i] >> top) & 1u) << i;
  return v;
}

// kQ = 0: with indels (Myers' words); kQ = 1, 2, 4 or 8: without, kQ
// counter planes a word.
template <int kQ, bool kPeqShared>
__global__ void __launch_bounds__(kThreads)
sellers_bp_kernel(const uint8_t* __restrict__ codes, int64_t n, int aligned,
                  const uint32_t* __restrict__ peq,
                  const int32_t* __restrict__ lens, int W, int alpha,
                  int eos, int k, int segc, int halo,
                  int32_t* __restrict__ out, int64_t cap,
                  uint32_t* __restrict__ far) {
  // shared layout: [staged text, kThreads rows of kRowWords words]
  // [accept words of this pattern, W x (alpha + 1) (kPeqShared)]
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tile = smem;
  const int A1 = alpha + 1;
  const int p = blockIdx.y;
  const uint32_t* peq_p = peq + static_cast<int64_t>(p) * W * A1;
  if (kPeqShared) {
    uint32_t* peq_s = smem + kThreads * kRowWords;
    for (int i = threadIdx.x; i < W * A1; i += kThreads) peq_s[i] = peq_p[i];
    peq_p = peq_s;
  }
  const int m = __ldg(lens + p);
  const int Wp = (m + 31) >> 5;         // this pattern's words
  const int top = (m - 1) & 31;         // row m's bit in word Wp - 1
  const uint32_t hlast = 1u << top;
  const uint32_t mlast = hlast | (hlast - 1u);
  const int64_t nthr = static_cast<int64_t>(gridDim.x) * gridDim.y * kThreads;
  const int64_t g = (static_cast<int64_t>(p) * gridDim.x + blockIdx.x) *
                        kThreads + threadIdx.x;
  const int64_t seg0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t own0 = (seg0 + threadIdx.x) * segc;

  constexpr bool kIndels = kQ == 0;
  constexpr int kP = kIndels ? 1 : kQ;  // counter planes (arrays >= 1)
  // with indels: word 0 in registers, words 1 .. in far[2 (b - 1) (+1)];
  // y carries kFirst on the character after an EOS or the warm-up start
  const int y0 = min(Wp - 1, max((k + 31) / 32, 1) - 1);
  const int sy0 = 32 * y0 + (y0 == Wp - 1 ? top + 1 : 32);
  const uint32_t h0 = Wp == 1 ? hlast : kHigh;
  // the hot path (word 0 alone): word 1 stays asleep while word 0's
  // previous bottom score is above kwake, and row m is word 0's when
  // klast >= 0
  const int kwake = Wp == 1 ? -1 : k;
  const int klast = Wp == 1 ? k : -1;
  uint32_t P0 = kOnes, M0 = 0;
  int y = kIndels ? (y0 | kFirst) : 0;
  int sy = sy0;
  // without indels: the planes of word 0 in registers, words 1 .. in
  // far[kQ (b - 1) + i]; a fresh word holds s = k + 1 in every row
  const int s = k + 1;
  uint32_t sx[kP], pl0[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    sx[i] = ((s >> i) & 1) ? 0u : kOnes;
    pl0[i] = ~sx[i];
  }
  if (kIndels) {
    for (int b = 1; b <= y0; ++b) {
      far[(2 * b - 2) * nthr + g] = kOnes;
      far[(2 * b - 1) * nthr + g] = 0u;
    }
  }
  // a triple at rel = pos - own0 is this thread's when 0 <= rel < lim
  const int64_t left = n - own0;
  const uint32_t lim = static_cast<uint32_t>(
      left <= 0 ? 0 : (left < segc ? left : segc));
  auto emit = [&](int rel, int d) {
    if (static_cast<uint32_t>(rel) < lim) {
      const int slot = atomicAdd(out, 1);
      if (slot < cap) {
        out[1 + slot] = static_cast<int32_t>(own0 + rel);
        out[1 + cap + slot] = p;
        out[1 + 2 * cap + slot] = d;
      }
    }
  };

  const int steps = halo + segc;  // both multiples of kTile
  for (int t0 = 0; t0 < steps; t0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int f = threadIdx.x; f < kThreads * (kTile / 4); f += kThreads) {
      const int r = f / (kTile / 4);
      const int w = f % (kTile / 4);
      const int64_t at = (seg0 + r) * segc - halo + t0 + 4 * w;
      uint32_t wd;
      if (aligned && at >= 0 && at + 4 <= n) {
        wd = __ldg(reinterpret_cast<const uint32_t*>(codes + at));
      } else {  // text outside [0, n) reads as EOS
        wd = 0;
        for (int i = 0; i < 4; ++i) {
          const uint32_t c =
              (at + i >= 0 && at + i < n) ? __ldg(codes + at + i) : eos;
          wd |= c << (8 * i);
        }
      }
      tile[r * kRowWords + w] = wd;
    }
    __syncthreads();
    const uint32_t* row = tile + threadIdx.x * kRowWords;
    for (int w = 0; w < kTile / 4; ++w) {
      const uint32_t wd = row[w];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (wd >> (8 * i)) & 255;
        const int rel = t0 - halo + 4 * w + i;
        if (c == eos) {
          if (kIndels) {
            P0 = kOnes;
            M0 = 0u;
            for (int b = 1; b <= y0; ++b) {
              far[(2 * b - 2) * nthr + g] = kOnes;
              far[(2 * b - 1) * nthr + g] = 0u;
            }
            y = y0 | kFirst;
            sy = sy0;
          } else {
#pragma unroll
            for (int j = 0; j < kP; ++j) pl0[j] = ~sx[j];
            y = 0;
          }
          continue;
        }
        const uint32_t* pq = peq_p + min(c, alpha);  // word b at pq[b * A1]
        if (kIndels) {
          if (y == 0 && sy > kwake) {  // the hot path: word 0 alone
            sy += advance(P0, M0, pq[0], 0, h0);
            if (sy <= klast) emit(rel, sy);
            continue;
          }
          const bool first = (y & kFirst) != 0;
          y &= ~kFirst;
          int carry = advance(P0, M0, first ? pq[0] & 1u : pq[0], 0, h0);
          for (int b = 1; b <= y; ++b) {
            uint32_t Pb = far[(2 * b - 2) * nthr + g];
            uint32_t Mb = far[(2 * b - 1) * nthr + g];
            carry = advance(Pb, Mb, first ? 0u : pq[b * A1], carry,
                            b == Wp - 1 ? hlast : kHigh);
            far[(2 * b - 2) * nthr + g] = Pb;
            far[(2 * b - 1) * nthr + g] = Mb;
          }
          sy += carry;
          if (y < Wp - 1 && sy - carry <= k) {
            // row 1 of word y + 1 reaches <= k through the diagonal (its
            // previous bottom is k and it matches) or a deletion (word y's
            // bottom fell to k - 1)
            const uint32_t eq = first ? 0u : pq[(y + 1) * A1];
            if ((eq & 1u) || carry < 0) {
              ++y;
              uint32_t Pb = kOnes, Mb = 0u;
              sy += (y == Wp - 1 ? top + 1 : 32) - carry;
              sy += advance(Pb, Mb, eq, carry, y == Wp - 1 ? hlast : kHigh);
              far[(2 * y - 2) * nthr + g] = Pb;
              far[(2 * y - 1) * nthr + g] = Mb;
            }
          }
          while (y > 0 && sy >= k + 32) {  // every row of word y > k
            const uint32_t rm = y == Wp - 1 ? mlast : kOnes;
            sy -= __popc(far[(2 * y - 2) * nthr + g] & rm) -
                  __popc(far[(2 * y - 1) * nthr + g] & rm);
            --y;
          }
          if (y == Wp - 1 && sy <= k) emit(rel, sy);
        } else {
          uint32_t cin[kP];
#pragma unroll
          for (int j = 0; j < kP; ++j) cin[j] = 0u;  // row 0 counts 0
          count_step<kP>(pl0, cin, ~pq[0], sx);
          // the old bottom row of word y, for word y + 1
          int v = count_at<kP>(cin, 0);
          if (y == 0) {  // the hot path: word 0 alone
            if (Wp == 1) {
              const int d = count_at<kP>(pl0, top);
              if (d <= k) emit(rel, d);
              continue;
            }
            if (v >= s) continue;  // word 1 stays asleep
          }
          int d = s;  // row m's count when word Wp - 1 is active
          for (int b = 1; b <= y + 1 && b < Wp; ++b) {
            uint32_t pl[kP];
            if (b == y + 1) {
              // word y + 1 holds s throughout; its row 1 takes the old
              // bottom row of word y
              if (v >= s) break;
              ++y;
#pragma unroll
              for (int j = 0; j < kP; ++j) pl[j] = ~sx[j];
            } else {
#pragma unroll
              for (int j = 0; j < kP; ++j) {
                pl[j] = far[(kP * (b - 1) + j) * nthr + g];
              }
            }
            count_step<kP>(pl, cin, ~pq[b * A1], sx);
            v = count_at<kP>(cin, 0);
#pragma unroll
            for (int j = 0; j < kP; ++j) {
              far[(kP * (b - 1) + j) * nthr + g] = pl[j];
            }
            if (b == Wp - 1) d = count_at<kP>(pl, top);
          }
          while (y > 0) {  // drop word y while every row holds s
            const uint32_t rm = y == Wp - 1 ? mlast : kOnes;
            uint32_t pl[kP];
#pragma unroll
            for (int j = 0; j < kP; ++j) {
              pl[j] = far[(kP * (y - 1) + j) * nthr + g];
            }
            if ((saturated<kP>(pl, sx) & rm) != rm) break;
            --y;
          }
          if (y == Wp - 1 && d <= k) emit(rel, d);
        }
      }
    }
  }
}

// Counter planes without indels: the bit length of k + 1, rounded up to
// a power of two (a plane past the bit length stays zero).
int planes(int k) {
  const int q = 32 - __builtin_clz(static_cast<unsigned>(k + 1));
  return q <= 1 ? 1 : q <= 2 ? 2 : q <= 4 ? 4 : 8;
}

// Scratch words per thread: the vertical deltas (indels) or the counter
// planes of every word past the first.
int64_t far_words(int W, int k, int indels) {
  return static_cast<int64_t>(W - 1) * (indels ? 2 : planes(k));
}

bool peq_shared(int W, int alpha) {
  return kTileBytes + static_cast<int64_t>(W) * (alpha + 1) * 4 <= kSmemMax;
}

size_t smem_bytes(int W, int alpha) {
  return kTileBytes +
         (peq_shared(W, alpha) ? static_cast<size_t>(W) * (alpha + 1) * 4
                               : 0);
}

using Kernel = void (*)(const uint8_t*, int64_t, int, const uint32_t*,
                       const int32_t*, int, int, int, int, int, int,
                       int32_t*, int64_t, uint32_t*);

// The instance of a scan: kQ 0 with indels, else planes(k).
template <bool kPeqShared>
Kernel pick(int indels, int k) {
  if (indels) return sellers_bp_kernel<0, kPeqShared>;
  switch (planes(k)) {
    case 1: return sellers_bp_kernel<1, kPeqShared>;
    case 2: return sellers_bp_kernel<2, kPeqShared>;
    case 4: return sellers_bp_kernel<4, kPeqShared>;
    default: return sellers_bp_kernel<8, kPeqShared>;
  }
}

Kernel pick(int indels, int k, bool shared) {
  return shared ? pick<true>(indels, k) : pick<false>(indels, k);
}

// Sets the kernel's shared-memory limit and, given per_sm, its resident
// blocks per SM.
cudaError_t prepare(Kernel kernel, size_t smem, int* per_sm) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (per_sm == nullptr) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

}  // namespace

// The launch plan of a scan into plan[0 .. 3): the segment length (a
// multiple of 32), the warm-up halo (Lmax + k rounded up to 32) and the
// bytes of device scratch.  segc_req > 0 asks for that segment length
// (rounded up to 32); 0 sizes the segments so that P rows of
// ceil(nseg / 128) blocks fill whole waves of the current device's
// resident blocks, each segment at least four halos and 256 characters
// long, and the scratch at most scratch_max bytes where segments can
// grow.  Returns a cudaError_t (0 on success).
extern "C" int sat_sellers_plan(int64_t n, int P, int Lmax, int alpha, int k,
                                int indels, int segc_req,
                                int64_t scratch_max, int64_t* plan) {
  if (n < 1 || P < 1 || Lmax < 1 || alpha < 1 || alpha > 256 || k < 0 ||
      k > 254) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = (Lmax + 31) / 32;
  const int64_t halo = round_up(static_cast<int64_t>(Lmax) + k, kTile);
  const int64_t per_thread = far_words(W, k, indels) * 4;
  int64_t segc = round_up(segc_req, kTile);
  if (segc_req <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err == cudaSuccess) {
      err = prepare(pick(indels, k, peq_shared(W, alpha)),
                    smem_bytes(W, alpha), &per_sm);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    const int64_t floor_c = round_up(4 * halo > 256 ? 4 * halo : 256, kTile);
    // the fewest waves whose segments are at most 8192 characters (or
    // the floor), so every block runs the same number of steps
    for (int64_t waves = 1;; ++waves) {
      // blocks per pattern row, at most waves x wave blocks in all
      const int64_t bx = waves * wave / P > 0 ? waves * wave / P : 1;
      segc = round_up((n + bx * kThreads - 1) / (bx * kThreads), kTile);
      if (segc <= 8192 || segc <= floor_c) break;
    }
    if (segc < floor_c) segc = floor_c;
    for (;;) {
      const int64_t nseg = (n + segc - 1) / segc;
      const int64_t thr = round_up(nseg, kThreads) * P;
      if (thr * per_thread <= scratch_max || segc >= n) break;
      segc *= 2;
    }
  }
  const int64_t nseg = (n + segc - 1) / segc;
  plan[0] = segc;
  plan[1] = halo;
  plan[2] = round_up(nseg, kThreads) * P * per_thread;
  return 0;
}

// Candidate triples of the Sellers scan into out[0 .. 1 + 3 cap): out[0]
// the true count (the caller zeroes it first), then the 0-based end
// positions, the pattern ids and the distances.  codes [>= n] uint8, peq
// [P, ceil(Lmax / 32), alpha + 1] uint32 (bit i of word b at code c: row
// 32 b + i + 1 of pattern p accepts c; column alpha zero) and lens [P]
// int32 (each in [1, Lmax]) on the device; segc and halo from
// sat_sellers_plan; scratch holds its plan[2] bytes (null when 0).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_sellers_scan(const void* codes, int64_t n, const void* peq,
                                const void* lens, int P, int Lmax, int alpha,
                                int eos, int k, int indels, int64_t segc,
                                int64_t halo, void* out, int64_t cap,
                                void* scratch, int64_t scratch_bytes,
                                void* stream) {
  if (n < 1) return 0;
  const int W = (Lmax + 31) / 32;
  if (P < 1 || P > 65535 || Lmax < 1 || alpha < 1 || alpha > 256 ||
      eos < 0 || eos > 255 || k < 0 || k > 254 || segc < kTile ||
      segc % kTile != 0 || halo < Lmax + k || halo % kTile != 0 ||
      cap < 1 || segc + halo >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nseg = (n + segc - 1) / segc;
  const int64_t bx = (nseg + kThreads - 1) / kThreads;
  const int64_t need = bx * kThreads * P * far_words(W, k, indels) * 4;
  if (bx > 0x7fffffff ||
      (need > 0 && (scratch == nullptr || scratch_bytes < need))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(W, alpha);
  const Kernel kernel = pick(indels, k, peq_shared(W, alpha));
  const cudaError_t err = prepare(kernel, smem, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(P));
  const int aligned = (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n, aligned,
      static_cast<const uint32_t*>(peq), static_cast<const int32_t*>(lens), W,
      alpha, eos, k, static_cast<int>(segc), static_cast<int>(halo),
      static_cast<int32_t*>(out), cap, static_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
