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
// Survivors go to anchors/sids through a counter, in no order; *count
// always receives the true number, so the host retries with a larger cap
// when it exceeds cap.
//
// The TPU kernel reduced each window start to (sum of seed ids, count)
// with a matmul and so could name one seed only: starts where several
// seeds hit, windows touching EOS and slot-cap overflows escaped to a host
// rescan.  This kernel enumerates every seed at every start, so nothing
// escapes.
//
// The first form of this kernel ran one lane per window start and
// every seed through a dependent loop of int16 weight lookups, then the
// gate DP of each hit in its own lane while the warp waited: bound by
// instruction issue and by those serial DPs.  This form:
//   - enumerates in the bit-parallel form of scan_filter.cu, over the
//     operands of scan_kernel.py::filter_tables (accept / kill classes per
//     seed position, jend, kp, poison; the same tables the filter launch
//     used): a warp stages its microblocks' text once, builds one 32-bit
//     mask per mask row and 32-position word with __ballot_sync, and a
//     seed's 32-start hit word is the AND of its funnel-shifted class masks
//     over its positions (a saturating bit-sliced miss counter when the
//     seed allows misses), with an exit at 0: one word step per (seed,
//     position) for 32 starts;
//   - lays 8 microblocks on a warp, 4 lanes each over its seeds: within
//     1% of one lane per microblock (every lane walking every seed, as the
//     filter does) where candidates are many, and it fills the card where
//     they are few (PERF.md section 6 has the layouts' times);
//   - pushes each hit (anchor, seed) into a per-warp queue in shared
//     memory (a ballot and a popcount prefix), and runs the gate DP
//     (gate.cuh; one kernel instance per band, so only that band's row
//     sits in the loop) 32 queued hits at a time, one per lane; the window
//     is read from the staged text where it lies inside it (the
//     microblock's text with a margin of Lg + band on each side), else
//     through __ldg;
//   - sends survivors out with warp-aggregated slots (slot_out.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "gate.cuh"
#include "scan_chunk.cuh"
#include "slot_out.cuh"

namespace {

using sat::full_grid;
using sat::Gate;
using sat::gate_ok;
using sat::kMaxBand;
using sat::kSentinel;
using sat::LaunchCache;
using sat::round_up;

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // no class: the empty set
constexpr int kMaxWarps = 8;
constexpr int kBitWords = 8;             // a row's bitset: 256 codes
constexpr int kQueue = 64;               // queued hits per warp
constexpr int kGateSmemMax = 32 * 1024;
constexpr int kSmemMax = 232448;         // sm_90 per-block opt-in maximum
constexpr int kMarginMax = 64;           // staged text past the seeds
constexpr uint8_t kOut = 0xff;           // a staged position outside [0, n)
constexpr int kMb = 8;                   // microblocks per warp

// Per-warp shared memory, and the geometry of a launch.
struct Geometry {
  int Wq;       // mask words per microblock: 2 + (J - 1) / 32
  int E;        // staged margin on each side (the gate's window), a
                // multiple of 4
  int hi;       // staged positions from t0 (exclusive), t0 = 32 m
  int spanp;    // staged bytes per microblock, padded
  int per_warp;
  int warps;
  int smem;
};

inline Geometry geometry(int R, int J, int Lmax, int Lg, int band,
                         int fixed) {
  Geometry g;
  g.Wq = 2 + ((J > 0 ? J - 1 : 0) >> 5);
  g.E = round_up(Lg + band < kMarginMax ? Lg + band : kMarginMax, 4);
  const int seeds = 31 + Lmax + g.E;
  g.hi = 32 * g.Wq > seeds ? 32 * g.Wq : seeds;
  g.spanp = round_up(g.E + g.hi, 4);
  g.per_warp = R * g.Wq * kMb * 4  // masks
               + 3 * kQueue * 4   // queue: anchors, seed ids, slots
               + kMb * 4          // t0 of each microblock
               + kMb * g.spanp;   // text
  int warps = (kSmemMax - fixed) / g.per_warp;
  if (warps > kMaxWarps) warps = kMaxWarps;
  g.warps = warps;
  g.smem = fixed + (warps > 0 ? warps : 0) * g.per_warp;
  return g;
}

// The verdict word of one class at seed position j for 32 starts: bit b
// set iff text[t0 + b + j] lies in the class.  `mw` points at this lane's
// microblock in word 0 of row 0; row r, word q lies at (r Wq + q) kMb.
template <bool kDirect>
__device__ __forceinline__ uint32_t class_mask(
    uint32_t cls, int j, const uint32_t* mw, int Wq,
    const int32_t* __restrict__ cls_off,
    const int32_t* __restrict__ cls_rows) {
  if (cls == kNone) return 0;
  const int q = j >> 5;
  const int s = j & 31;
  if (kDirect) {
    const uint32_t* r = mw + (static_cast<int>(cls) * Wq + q) * kMb;
    return __funnelshift_r(r[0], r[kMb], s);
  }
  uint32_t m = 0;
  const int end = __ldg(cls_off + cls + 1);
  for (int i = __ldg(cls_off + cls); i < end; ++i) {
    const uint32_t* r = mw + (__ldg(cls_rows + i) * Wq + q) * kMb;
    m |= __funnelshift_r(r[0], r[kMb], s);
  }
  return m;
}

// The starts of 32 that seed p hits with kp >= 1 misses allowed
// (kp < jend): a bit-sliced counter of misses per start on kPlanes planes
// (the first `b` used) that drops a start at kp + 1 (scan_filter.cu's
// count_hits, returning the word).
template <bool kDirect, int kPlanes>
__device__ uint32_t count_word(const uint2* __restrict__ e, int jend, int kp,
                               bool poison, const uint32_t* mw, int Wq,
                               const int32_t* __restrict__ cls_off,
                               const int32_t* __restrict__ cls_rows) {
  constexpr int kUnroll = kPlanes <= 4 ? kPlanes : 1;
  const uint32_t top = static_cast<uint32_t>(kp) + 1u;
  const int b = 32 - __clz(top);
  uint32_t c[kPlanes];
#pragma unroll kUnroll
  for (int i = 0; i < kPlanes; ++i) c[i] = 0;
  uint32_t alive = kFull;
  for (int j = 0; j < jend && alive != 0; ++j) {
    const uint2 id = __ldg(e + j);
    if (poison) {
      alive &= ~class_mask<kDirect>(id.y, j, mw, Wq, cls_off, cls_rows);
    }
    uint32_t carry =
        ~class_mask<kDirect>(id.x, j, mw, Wq, cls_off, cls_rows) & alive;
    uint32_t at_top = kFull;
#pragma unroll kUnroll
    for (int i = 0; i < kPlanes; ++i) {
      if (i < b) {
        const uint32_t t = c[i] & carry;
        c[i] ^= carry;
        carry = t;
        at_top &= ((top >> i) & 1u) ? c[i] : ~c[i];
      }
    }
    alive &= ~at_top;
  }
  return alive;
}

// The hit word of seed p on this lane's microblock: bit b set iff the
// window at t0 + b scores at least the seed's threshold.
template <bool kDirect>
__device__ uint32_t seed_word(const uint2* __restrict__ ent,
                              const int2* __restrict__ pat, int p, int J,
                              const uint32_t* mw, int Wq,
                              const int32_t* __restrict__ cls_off,
                              const int32_t* __restrict__ cls_rows) {
  const int2 hd = __ldg(pat + p);
  const int jend = hd.x & 0xffff;
  const bool poison = (hd.x >> 16) & 1;
  const int kp = hd.y;
  if (kp < 0) return 0;
  const uint2* e = ent + static_cast<int64_t>(p) * J;
  uint32_t alive = kFull;
  if (kp >= jend) {
    // no count of misses can exclude a start: only a killed code can
    for (int j = 0; poison && j < jend && alive != 0; ++j) {
      alive &= ~class_mask<kDirect>(__ldg(e + j).y, j, mw, Wq, cls_off,
                                       cls_rows);
    }
    return alive;
  }
  if (kp == 0) {
    // every position must accept (a killed code is a miss too); two
    // positions a step, so that their loads overlap
    const uint32_t* ex = reinterpret_cast<const uint32_t*>(e);
    int j = 0;
    for (; j + 1 < jend; j += 2) {
      const uint32_t a0 = __ldg(ex + 2 * j);
      const uint32_t a1 = __ldg(ex + 2 * j + 2);
      alive &= class_mask<kDirect>(a0, j, mw, Wq, cls_off, cls_rows) &
               class_mask<kDirect>(a1, j + 1, mw, Wq, cls_off, cls_rows);
      if (alive == 0) return 0;
    }
    if (j < jend) {
      alive &= class_mask<kDirect>(__ldg(ex + 2 * j), j, mw, Wq, cls_off,
                                      cls_rows);
    }
    return alive;
  }
  if (kp <= 2) {
    return count_word<kDirect, 2>(e, jend, kp, poison, mw, Wq, cls_off,
                                     cls_rows);
  }
  if (kp <= 14) {
    return count_word<kDirect, 4>(e, jend, kp, poison, mw, Wq, cls_off,
                                     cls_rows);
  }
  return count_word<kDirect, 16>(e, jend, kp, poison, mw, Wq, cls_off,
                                    cls_rows);
}

// Text code at idx for the gate: from a microblock's staged text where the
// position lies inside it, else from device memory; the sentinel outside
// [0, n).
struct StagedText {
  const uint8_t* txt;  // the microblock's staged bytes, or null
  int64_t lo;          // the position of txt[0]
  int len;
  const uint8_t* __restrict__ codes;
  int64_t n;
  __device__ __forceinline__ int operator()(int64_t idx) const {
    const int64_t off = idx - lo;
    if (txt != nullptr && off >= 0 && off < len) {
      const uint8_t c = txt[off];
      return c == kOut ? kSentinel : c;
    }
    return (idx >= 0 && idx < n) ? __ldg(codes + idx) : kSentinel;
  }
};

template <bool kDirect, int B>
__global__ void __launch_bounds__(kMaxWarps * 32)
seed_gate_kernel(const uint8_t* __restrict__ codes, int64_t n, int eos,
                 const uint32_t* __restrict__ bits, int R,
                 const uint2* __restrict__ ent, const int2* __restrict__ pat,
                 int P, int J, const int32_t* __restrict__ cls_off,
                 const int32_t* __restrict__ cls_rows,
                 const int32_t* __restrict__ lengths,
                 const int64_t* __restrict__ mb_count,
                 const int64_t* __restrict__ mb_idx, int64_t cap_mb,
                 const int32_t* __restrict__ gbits,
                 const int32_t* __restrict__ glen,
                 const int32_t* __restrict__ gdir, int Lg, int k,
                 int gate_words, Geometry geo, int32_t* __restrict__ out,
                 int64_t cap) {
  // shared layout: [gate bits][row bitsets][per warp: masks, queue, t0,
  // text]
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* gbits_s = reinterpret_cast<int32_t*>(smem);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(gbits_s + gate_words);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Wq = geo.Wq;
  uint32_t* masks = reinterpret_cast<uint32_t*>(
      reinterpret_cast<unsigned char*>(bits_s + R * kBitWords) +
      warp * geo.per_warp);
  int32_t* q_anchor = reinterpret_cast<int32_t*>(masks + R * Wq * kMb);
  int32_t* q_sid = q_anchor + kQueue;
  int32_t* q_slot = q_sid + kQueue;
  int32_t* t0s = q_slot + kQueue;
  uint8_t* txt = reinterpret_cast<uint8_t*>(t0s + kMb);

  for (int i = threadIdx.x; i < gate_words; i += blockDim.x) {
    gbits_s[i] = gbits[i];
  }
  for (int i = threadIdx.x; i < R * kBitWords; i += blockDim.x) {
    bits_s[i] = bits[i];
  }
  __syncthreads();  // the only block-wide barrier: warps run on their own

  const Gate g{gate_words ? gbits_s : gbits, glen, gdir, Lg, k,
               gate_words != 0};
  int64_t live = *mb_count;
  if (live > cap_mb) live = cap_mb;
  const int64_t ntiles = (live + kMb - 1) / kMb;
  const int64_t wstride = static_cast<int64_t>(gridDim.x) * geo.warps;
  const int span = geo.E + geo.hi;
  const int mi = lane % kMb;  // this lane's microblock
  constexpr int kLanesPerMb = 32 / kMb;
  const int so = lane / kMb;  // and its first seed
  const int rounds = (P + kLanesPerMb - 1) / kLanesPerMb;
  const uint32_t* mw = masks + mi;
  const uint32_t lt = (1u << lane) - 1u;
  int qn = 0;  // queued hits, the same in every lane

  // the gate over the first `cnt` queued hits, one per lane
  auto flush = [&](int cnt) {
    __syncwarp();
    if (lane < cnt) {
      const int a = q_anchor[lane];
      const int s = q_sid[lane];
      const int sl = q_slot[lane];
      const StagedText text{
          sl >= 0 ? txt + sl * geo.spanp : nullptr,
          sl >= 0 ? static_cast<int64_t>(t0s[sl]) - geo.E : 0, span, codes,
          n};
      if (gate_ok<B>(text, a, s, g)) sat::emit_pair(out, cap, a, s);
    }
    __syncwarp();
  };

  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * geo.warps + warp;
       tile < ntiles; tile += wstride) {
    // queued hits of earlier tiles read their windows from device memory
    if (lane < qn) q_slot[lane] = -1;
    if (lane < kMb) {
      const int64_t i = tile * kMb + lane;
      t0s[lane] = i < live ? static_cast<int32_t>(mb_idx[i] * 32) : -1;
    }
    __syncwarp();
    // 1. stage each microblock's text with its margins, 4 codes a load
    // (t0 - E is a multiple of 4)
    const int spanw = geo.spanp / 4;
#pragma unroll 4
    for (int i = lane; i < kMb * spanw; i += 32) {
      const int m = i / spanw;
      const int x = i - m * spanw;
      const int t0 = t0s[m];
      if (t0 < 0) continue;
      const int64_t pos = static_cast<int64_t>(t0) - geo.E + 4 * x;
      uint32_t v;
      if (pos >= 0 && pos + 4 <= n) {
        v = __ldg(reinterpret_cast<const uint32_t*>(codes) + (pos >> 2));
      } else {
        v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t c =
              (pos + b >= 0 && pos + b < n) ? codes[pos + b] : kOut;
          v |= c << (8 * b);
        }
      }
      reinterpret_cast<uint32_t*>(txt + m * geo.spanp)[x] = v;
    }
    __syncwarp();
    // 2. the mask rows: word q of microblock m covers t0 + 32 q + lane
    for (int m = 0; m < kMb; ++m) {
      if (t0s[m] < 0) continue;  // warp-uniform
      for (int q = 0; q < Wq; ++q) {
        int c = txt[m * geo.spanp + geo.E + 32 * q + lane];
        if (c == kOut) c = eos;  // past n
        const int cw = c >> 5;
        const int cb = c & 31;
        for (int r0 = 0; r0 < R; r0 += 32) {
          const int rn = R - r0 < 32 ? R - r0 : 32;
          uint32_t mine = 0;
          for (int i = 0; i < rn; ++i) {
            const uint32_t set = bits_s[(r0 + i) * kBitWords + cw];
            const uint32_t v = __ballot_sync(kFull, (set >> cb) & 1u);
            if (lane == i) mine = v;
          }
          if (lane < rn) masks[((r0 + lane) * Wq + q) * kMb + m] = mine;
        }
      }
    }
    __syncwarp();
    // 3. every seed on every microblock; hits into the queue
    const int t0 = t0s[mi];
    const int64_t room = t0 < 0 ? 0 : n - t0;  // starts below n
    const uint32_t valid =
        room >= 32 ? kFull
                   : (room <= 0 ? 0u : (1u << static_cast<int>(room)) - 1u);
    for (int rd = 0; rd < rounds; ++rd) {
      const int s = so + rd * kLanesPerMb;
      uint32_t hw = 0;
      if (valid != 0 && s < P) {
        hw = seed_word<kDirect>(ent, pat, s, J, mw, Wq, cls_off,
                                   cls_rows) & valid;
      }
      const int len = hw != 0 ? __ldg(lengths + s) : 0;
      while (__any_sync(kFull, hw != 0)) {
        const bool has = hw != 0;
        const unsigned bal = __ballot_sync(kFull, has);
        if (has) {
          const int b = __ffs(hw) - 1;
          hw &= hw - 1u;
          const int at = qn + __popc(bal & lt);
          q_anchor[at] = t0 + b + len;
          q_sid[at] = s;
          q_slot[at] = mi;
        }
        qn += __popc(bal);
        if (qn >= 32) {
          flush(32);
          if (lane + 32 < qn) {
            q_anchor[lane] = q_anchor[lane + 32];
            q_sid[lane] = q_sid[lane + 32];
            q_slot[lane] = q_slot[lane + 32];
          }
          qn -= 32;
          __syncwarp();
        }
      }
    }
    __syncwarp();  // every lane is done with the masks before the next tile
  }
  if (qn > 0) flush(qn);
}

LaunchCache g_launch[2][kMaxBand + 1];

template <bool kDirect, int B>
cudaError_t launch(const uint8_t* codes, int64_t n, int eos,
                   const uint32_t* bits, int R, const uint2* ent,
                   const int2* pat, int P, int J, const int32_t* cls_off,
                   const int32_t* cls_rows, const int32_t* lengths, int Lmax,
                   const int64_t* mb_count, const int64_t* mb_idx,
                   int64_t cap_mb, const int32_t* gbits, const int32_t* glen,
                   const int32_t* gdir, int Lg, int k, int band,
                   int32_t* out, int64_t cap, cudaStream_t stream) {
  const int64_t gate_bytes = static_cast<int64_t>(P) * Lg * 4;
  const int gate_words =
      gate_bytes <= kGateSmemMax ? static_cast<int>(gate_bytes / 4) : 0;
  const int fixed = round_up(gate_words * 4 + R * kBitWords * 4, 16);
  const Geometry geo = geometry(R, J, Lmax, Lg, band, fixed);
  if (geo.warps < 1) return cudaErrorInvalidValue;
  const int threads = geo.warps * 32;
  int64_t grid = 0;
  const cudaError_t err =
      full_grid(seed_gate_kernel<kDirect, B>, threads, geo.smem,
                g_launch[kDirect ? 1 : 0][B], &grid);
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (cap_mb + kMb - 1) / kMb;
  const int64_t need = (ntiles + geo.warps - 1) / geo.warps;
  if (grid > need) grid = need;
  seed_gate_kernel<kDirect, B>
      <<<static_cast<unsigned>(grid), threads, geo.smem, stream>>>(
          codes, n, eos, bits, R, ent, pat, P, J, cls_off, cls_rows, lengths,
          mb_count, mb_idx, cap_mb, gbits, glen, gdir, Lg, k, gate_words,
          geo, out, cap);
  return cudaGetLastError();
}

// The instance of the gate's band: the band with indels, 0 without.
template <bool kDirect, class... Args>
cudaError_t launch_band(int b, Args... args) {
  switch (b) {
    case 0: return launch<kDirect, 0>(args...);
    case 1: return launch<kDirect, 1>(args...);
    case 2: return launch<kDirect, 2>(args...);
    case 3: return launch<kDirect, 3>(args...);
    case 4: return launch<kDirect, 4>(args...);
    case 5: return launch<kDirect, 5>(args...);
    case 6: return launch<kDirect, 6>(args...);
    case 7: return launch<kDirect, 7>(args...);
    default: return launch<kDirect, 8>(args...);
  }
}

}  // namespace

// Survivors of the seed scan and gate into out[0 .. 1 + 2 cap): out[0] the
// true count (the caller zeroes it first), out[1 ..] the anchors,
// out[1 + cap ..] the seed ids.  On the device: codes [>= n] uint8
// (codes < alpha <= 30); the seed tables of scan_kernel.py::filter_tables
// (bits [R][8] uint32, ent [P][J] uint2, pat [P] int2, and in code mode
// (direct == 0) cls_off, cls_rows int32); lengths [P] int32; mb_count one
// int64 and mb_idx [cap_mb] int64; gate bits [P, Lg], glen [P], gdir [P]
// int32; codes 4-byte aligned.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int sat_seed_gate(const void* codes, int64_t n, int eos,
                             const void* bits, int R, const void* ent,
                             const void* pat, int P, int J,
                             const void* cls_off, const void* cls_rows,
                             int direct, const void* lengths, int Lmax,
                             const void* mb_count, const void* mb_idx,
                             int64_t cap_mb, const void* gbits,
                             const void* glen, const void* gdir, int Lg,
                             int k, int band, int indels, void* out,
                             int64_t cap, void* stream) {
  if (cap_mb <= 0) return 0;
  if (n < 1 || n + Lmax >= (int64_t{1} << 31) || R < 0 || P < 1 || J < 0 ||
      J > 0xffff || Lmax < 1 || eos < 0 || eos > 255 ||
      (!direct && R > 256) || Lg < 1 || k < 0 || band < 0 ||
      band > kMaxBand || cap < 1 ||
      (reinterpret_cast<uintptr_t>(codes) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const uint8_t*>(codes);
  const auto b = static_cast<const uint32_t*>(bits);
  const auto e = static_cast<const uint2*>(ent);
  const auto pt = static_cast<const int2*>(pat);
  const auto co = static_cast<const int32_t*>(cls_off);
  const auto cr = static_cast<const int32_t*>(cls_rows);
  const auto ln = static_cast<const int32_t*>(lengths);
  const auto mc = static_cast<const int64_t*>(mb_count);
  const auto mx = static_cast<const int64_t*>(mb_idx);
  const auto gb = static_cast<const int32_t*>(gbits);
  const auto gl = static_cast<const int32_t*>(glen);
  const auto gd = static_cast<const int32_t*>(gdir);
  const auto o = static_cast<int32_t*>(out);
  const int gb_band = indels ? band : 0;
  const cudaError_t err =
      direct ? launch_band<true>(gb_band, c, n, eos, b, R, e, pt, P, J, co,
                                 cr, ln, Lmax, mc, mx, cap_mb, gb, gl, gd,
                                 Lg, k, band, o, cap, s)
             : launch_band<false>(gb_band, c, n, eos, b, R, e, pt, P, J, co,
                                  cr, ln, Lmax, mc, mx, cap_mb, gb, gl, gd,
                                  Lg, k, band, o, cap, s);
  return static_cast<int>(err);
}
