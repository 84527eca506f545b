// Microblock occupancy filter of the exact / k-mismatch scan, for sm_90a:
// a warp bit-parallel k-mismatch filter over accept classes.
//
// Replaces the "occupancy" emit of the Pallas TPU kernel
// sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py::_scan_kernel
// (launched through _kernel_out from pallas_scan_hits).  Contract, which
// the plain PyTorch version scan_kernel.py::scan_occupancy_ref states
// too:
//
//   occ[m] = 1  iff  some window start t in [32m, 32m + 32) and some
//   pattern p have  sum_j w[j, text[t + j], p] >= thr[p],
//
// with text at positions >= n read as the EOS code.  Exact, not a
// superset.
//
// The weights the port builds (tables.py::conv_weights_f32) are 0/1 accept
// weights plus, under poison_eos, a negative EOS column that no window can
// outweigh.  scan_kernel.py::filter_tables turns a weight tensor of that
// form into the operands here (and refuses any other):
//   - classes: the distinct nonempty accept and kill sets of the
//     (position, pattern) cells, each a bitset over the alphabet (a few
//     for literal DNA, 16 for IUPAC under -w, up to 256 codes for raw or
//     protein alphabets);
//   - ent[p][j]: the accept class of cell (j, p) and its kill class
//     (the codes with a negative entry), -1 for none;
//   - pat[p]: jend (one past the last position with an accept or kill
//     entry), the poison flag, and kp = jend - thr[p].
// A window hits pattern p iff none of its first jend positions holds a
// killed code and at most kp of them miss their accept class.
//
// What bounded the first form of this kernel (one thread per window
// start, a dependent shared-memory weight lookup per start, pattern and
// position, a warp vote per pattern, 96 KB of weights per block) was
// instruction issue.  This kernel scores 32 window starts with one word
// operation:
//   - a warp owns a tile of 32 microblocks (1,024 starts), one lane per
//     microblock.  It reads the tile's text plus its halo once, one byte
//     per lane and 32-position word, and builds in shared memory one
//     32-bit mask per mask row and word with __ballot_sync: bit b is set
//     iff the code at that position lies in the row's set.  That is the
//     only per-position work, amortised over every pattern;
//   - per pattern and position j a lane funnel-shifts the class mask of
//     (p, j) by j, which gives the verdict of position j for its 32
//     starts at once.  k = 0 ANDs it into an alive word; k > 0 adds the
//     misses into a bit-sliced counter that saturates at kp + 1; a kill
//     mask clears starts outright.  The lane leaves a pattern when its
//     alive word is 0 (after about log4(32) + 1 positions on random DNA)
//     and stops at its first hitting pattern: no vote between lanes;
//   - the class id of (p, j) is the same for the whole warp (a broadcast
//     read through the read-only cache), and the 32 lanes read
//     consecutive mask words (no bank conflicts: the row stride is odd).
// Mask rows: one per class ("direct") while the classes are few; past
// that one per code, a class mask then being the OR of its codes' rows
// (the class lists cls_off / cls_rows), so shared memory stays bounded by
// the alphabet.  Shared memory holds the row bitsets and each warp's
// masks only: a few KB for DNA, so residency is bounded by registers.
// Patterns, class ids and thresholds stay in device memory (L1 / L2), so
// any P runs in one pass.  The bound is the text's bytes plus about one
// ballot per mask row and 32 positions plus the word steps per pattern
// and microblock (chip_smoke.py's occ_bound).

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_chunk.cuh"

namespace {

using sat::full_grid;
using sat::LaunchCache;

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // no class: the empty set
constexpr int kMaxWarps = 8;
constexpr int kSmemMax = 232448;  // sm_90 per-block opt-in maximum
constexpr int kBitWords = 8;      // a row's bitset: 256 codes
constexpr int kSmallRows = 8;

struct Geometry {
  int W;   // mask words per row and tile: 32 + the halo's words + 1
  int Ws;  // row stride in words (odd: conflict-free stores)
  int warps;
  int smem;
};

// The launch shape for J pattern positions and R mask rows (the same
// arithmetic as scan_kernel.py::_filter_smem); warps < 1 when one warp's
// masks do not fit a block.
inline Geometry geometry(int J, int R) {
  Geometry g;
  g.W = 33 + ((J > 0 ? J - 1 : 0) >> 5);
  g.Ws = g.W | 1;
  const int bits = R * kBitWords * 4;
  const int per_warp = R * g.Ws * 4;
  int warps = per_warp > 0 ? (kSmemMax - bits) / per_warp : kMaxWarps;
  if (warps > kMaxWarps) warps = kMaxWarps;
  g.warps = warps;
  g.smem = bits + (warps > 0 ? warps : 0) * per_warp;
  return g;
}

// The verdict word of one class at pattern position j for this lane's 32
// starts: bit b set iff text[start_b + j] lies in the class.  `mw` is this
// warp's mask rows, offset by the lane.
template <bool kDirect>
__device__ __forceinline__ uint32_t class_mask(
    uint32_t cls, int j, const uint32_t* mw, int Ws,
    const int32_t* __restrict__ cls_off,
    const int32_t* __restrict__ cls_rows) {
  if (cls == kNone) return 0;
  const int q = j >> 5;
  const int s = j & 31;
  if (kDirect) {
    const uint32_t* r = mw + cls * Ws + q;
    return __funnelshift_r(r[0], r[1], s);
  }
  uint32_t m = 0;
  const int end = __ldg(cls_off + cls + 1);
  for (int i = __ldg(cls_off + cls); i < end; ++i) {
    const uint32_t* r = mw + __ldg(cls_rows + i) * Ws + q;
    m |= __funnelshift_r(r[0], r[1], s);
  }
  return m;
}

// Whether some start of this lane's microblock hits pattern p with
// kp >= 1 misses allowed (kp < jend): a bit-sliced counter of misses per
// start on kPlanes planes (the first `b` used) that kills a start at
// kp + 1.  kPlanes = 16 (kp > 14, rare) keeps its planes in local memory
// (loops not unrolled), so that the common paths keep their registers.
template <bool kDirect, int kPlanes>
__device__ bool count_hits(const uint2* __restrict__ e, int jend, int kp,
                           bool poison, const uint32_t* mw, int Ws,
                           const int32_t* __restrict__ cls_off,
                           const int32_t* __restrict__ cls_rows) {
  constexpr int kUnroll = kPlanes <= 4 ? kPlanes : 1;
  const uint32_t top = static_cast<uint32_t>(kp) + 1u;
  const int b = 32 - __clz(top);
  uint32_t c[kPlanes];
#pragma unroll kUnroll
  for (int i = 0; i < kPlanes; ++i) c[i] = 0;
  uint32_t alive = kFull;
  for (int j = 0; j < jend; ++j) {
    const uint2 id = __ldg(e + j);
    if (poison) {
      alive &= ~class_mask<kDirect>(id.y, j, mw, Ws, cls_off, cls_rows);
    }
    uint32_t carry =
        ~class_mask<kDirect>(id.x, j, mw, Ws, cls_off, cls_rows) & alive;
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
    if (alive == 0) return false;
  }
  return true;
}

template <bool kDirect>
__device__ bool pattern_hits(const uint2* __restrict__ ent,
                             const int2* __restrict__ pat, int p, int J,
                             const uint32_t* mw, int Ws,
                             const int32_t* __restrict__ cls_off,
                             const int32_t* __restrict__ cls_rows) {
  const int2 hd = __ldg(pat + p);
  const int jend = hd.x & 0xffff;
  const bool poison = (hd.x >> 16) & 1;
  const int kp = hd.y;
  if (kp < 0) return false;
  const uint2* e = ent + static_cast<int64_t>(p) * J;
  if (kp >= jend) {
    // no count of misses can exclude a start: only a killed code can
    if (!poison) return true;
    uint32_t alive = kFull;
    for (int j = 0; j < jend && alive != 0; ++j) {
      alive &= ~class_mask<kDirect>(__ldg(e + j).y, j, mw, Ws, cls_off,
                                    cls_rows);
    }
    return alive != 0;
  }
  if (kp == 0) {
    // every position must accept (a killed code is a miss too); two
    // positions a step, so that their loads overlap
    uint32_t alive = kFull;
    int j = 0;
    for (; j + 1 < jend; j += 2) {
      const uint32_t a0 = __ldg(e + j).x;
      const uint32_t a1 = __ldg(e + j + 1).x;
      alive &= class_mask<kDirect>(a0, j, mw, Ws, cls_off, cls_rows) &
               class_mask<kDirect>(a1, j + 1, mw, Ws, cls_off, cls_rows);
      if (alive == 0) return false;
    }
    if (j < jend) {
      alive &= class_mask<kDirect>(__ldg(e + j).x, j, mw, Ws, cls_off,
                                   cls_rows);
    }
    return alive != 0;
  }
  if (kp <= 2) {
    return count_hits<kDirect, 2>(e, jend, kp, poison, mw, Ws, cls_off,
                                  cls_rows);
  }
  if (kp <= 14) {
    return count_hits<kDirect, 4>(e, jend, kp, poison, mw, Ws, cls_off,
                                  cls_rows);
  }
  return count_hits<kDirect, 16>(e, jend, kp, poison, mw, Ws, cls_off,
                                 cls_rows);
}

// kSmall: at most kSmallRows mask rows over an alphabet of at most 32
// codes, whose bitset words the lanes keep in registers while they build
// the masks.
template <bool kDirect, bool kSmall>
__global__ void __launch_bounds__(kMaxWarps * 32)
occupancy_kernel(const uint8_t* __restrict__ codes, int64_t n, int eos,
                 const uint32_t* __restrict__ bits, int R,
                 const uint2* __restrict__ ent,
                 const int2* __restrict__ pat, int P, int J,
                 const int32_t* __restrict__ cls_off,
                 const int32_t* __restrict__ cls_rows, int W, int Ws,
                 uint8_t* __restrict__ occ, int64_t nmb) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* bits_s = smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* masks = smem + R * kBitWords +
                    static_cast<int64_t>(warp) * R * Ws;
  for (int i = threadIdx.x; i < R * kBitWords; i += blockDim.x) {
    bits_s[i] = bits[i];
  }
  __syncthreads();  // the only block-wide barrier: warps run on their own

  uint32_t rw[kSmallRows];
#pragma unroll
  for (int r = 0; r < kSmallRows; ++r) {
    rw[r] = kSmall && r < R ? bits_s[r * kBitWords] : 0;
  }

  const int64_t ntiles = (nmb + 31) / 32;
  const int64_t wstride = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  const uint32_t* mw = masks + lane;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      warp;
       tile < ntiles; tile += wstride) {
    const int64_t base = tile * 1024;
    // 1. the tile's mask rows: word w covers positions base + 32w + lane
    int64_t pos = base + lane;
    int next = pos < n ? __ldg(codes + pos) : eos;
    for (int w = 0; w < W; ++w) {
      const int c = next;
      pos += 32;
      if (w + 1 < W) next = pos < n ? __ldg(codes + pos) : eos;
      if (kSmall) {
        uint32_t mine = 0;
#pragma unroll
        for (int r = 0; r < kSmallRows; ++r) {
          if (r < R) {
            const uint32_t m = __ballot_sync(kFull, (rw[r] >> c) & 1u);
            mine = lane == r ? m : mine;
          }
        }
        if (lane < R) masks[lane * Ws + w] = mine;
        continue;
      }
      const int cw = c >> 5;
      const int cb = c & 31;
      for (int r0 = 0; r0 < R; r0 += 32) {
        const int rn = R - r0 < 32 ? R - r0 : 32;
        uint32_t mine = 0;
        for (int i = 0; i < rn; ++i) {
          const uint32_t set = bits_s[(r0 + i) * kBitWords + cw];
          const uint32_t m = __ballot_sync(kFull, (set >> cb) & 1u);
          if (lane == i) mine = m;
        }
        if (lane < rn) masks[(r0 + lane) * Ws + w] = mine;
      }
    }
    __syncwarp();
    // 2. this lane's microblock against the patterns, first hit wins
    bool any = false;
    for (int p = 0; p < P && !any; ++p) {
      any = pattern_hits<kDirect>(ent, pat, p, J, mw, Ws, cls_off,
                                  cls_rows);
    }
    const int64_t mb = tile * 32 + lane;
    if (mb < nmb) occ[mb] = any ? 1 : 0;
    __syncwarp();  // every lane is done with the masks before the next tile
  }
}

LaunchCache g_launch[4];

template <bool kDirect, bool kSmall>
cudaError_t launch(const uint8_t* codes, int64_t n, int eos,
                   const uint32_t* bits, int R, const uint2* ent,
                   const int2* pat, int P, int J, const int32_t* cls_off,
                   const int32_t* cls_rows, uint8_t* occ, int64_t nmb,
                   cudaStream_t stream) {
  const Geometry g = geometry(J, R);
  if (g.warps < 1) return cudaErrorInvalidValue;
  const int threads = g.warps * 32;
  int64_t grid = 0;
  cudaError_t err =
      full_grid(occupancy_kernel<kDirect, kSmall>, threads, g.smem,
                g_launch[(kDirect ? 2 : 0) + (kSmall ? 1 : 0)], &grid);
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (nmb + 31) / 32;
  const int64_t need = (ntiles + g.warps - 1) / g.warps;
  if (grid > need) grid = need;
  occupancy_kernel<kDirect, kSmall>
      <<<static_cast<unsigned>(grid), threads, g.smem, stream>>>(
          codes, n, eos, bits, R, ent, pat, P, J, cls_off, cls_rows, g.W,
          g.Ws, occ, nmb);
  return cudaGetLastError();
}

}  // namespace

// occ[0..nmb) from codes[0..n) (uint8), text past n read as `eos`, on
// `stream`.  bits [R][8] uint32 (the mask rows' code sets), ent [P][J]
// uint2, pat [P] int2, and in code mode (direct == 0) cls_off [C + 1]
// and cls_rows int32, all built by scan_kernel.py::filter_tables; small
// != 0 when R <= 8 and the alphabet has at most 32 codes.  nmb must be
// ceil(n / 32) or more.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sat_scan_occupancy(const void* codes, int64_t n, int eos,
                                  const void* bits, int R, const void* ent,
                                  const void* pat, int P, int J,
                                  const void* cls_off, const void* cls_rows,
                                  int direct, int small, void* occ,
                                  int64_t nmb, void* stream) {
  if (nmb <= 0) return 0;
  if (R < 0 || P < 0 || J < 0 || J > 0xffff || eos < 0 || eos > 255 ||
      (!direct && R > 256) || (small && (R > kSmallRows || eos > 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const uint8_t*>(codes);
  const auto b = static_cast<const uint32_t*>(bits);
  const auto e = static_cast<const uint2*>(ent);
  const auto pt = static_cast<const int2*>(pat);
  const auto co = static_cast<const int32_t*>(cls_off);
  const auto cr = static_cast<const int32_t*>(cls_rows);
  const auto o = static_cast<uint8_t*>(occ);
  cudaError_t err;
  if (direct) {
    err = small ? launch<true, true>(c, n, eos, b, R, e, pt, P, J, co, cr, o,
                                     nmb, s)
                : launch<true, false>(c, n, eos, b, R, e, pt, P, J, co, cr,
                                      o, nmb, s);
  } else {
    err = small ? launch<false, true>(c, n, eos, b, R, e, pt, P, J, co, cr,
                                      o, nmb, s)
                : launch<false, false>(c, n, eos, b, R, e, pt, P, J, co, cr,
                                       o, nmb, s);
  }
  return static_cast<int>(err);
}
