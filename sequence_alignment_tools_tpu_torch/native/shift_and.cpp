// Bit-parallel multi-pattern scan (host fast path).
//
// The reference's fastest exact engine is the multiword shift-and scan
// (shift_and.cc:218-254) and its k-error generalization is the Wu-Manber
// row stack (shift_and_inexact.cc:265-330).  This is that machine, built
// from the framework's dense [P, Lmax, alpha] accept table so IUPAC
// wildcard classes need no special casing: U[c] bit b is simply "pattern
// position b accepts alphabet code c".
//
// Substitution-only rows (the ConvScanner contract is k-MISMATCH; indel
// candidates go through the Sellers DP):
//   R0' = ((R0 << 1) | S) & U[c]
//   Ri' = (((Ri << 1) | S) & U[c]) | (R(i-1)_old << 1) | S        i >= 1
// where R(i-1)_old is row i-1 BEFORE this character's update.  Rows are
// monotone (Ri <= R(i+1)), so the lowest row whose end bit fires is the
// exact mismatch count.  Carry bleed across word boundaries lands only on
// pattern start bits, which S sets unconditionally, so the multiword
// shift needs no per-pattern masking (same argument as the reference's
// concatenated-pattern layout).  With poison_eos, an EOS character clears
// every row: no window may straddle an entry boundary (the semantics of
// conv_weights' poison row).
//
// Hits are emitted as (end_position, bit_index, mismatches); the Python
// wrapper maps bit_index -> pattern and orders by (window_start, pattern).

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <thread>
#include <utility>
#include <vector>

namespace {
constexpr int32_t kMaxWords = 64;  // 4096 concatenated pattern chars
}

extern "C" {

// Returns the TOTAL hit count (callers retry with a larger cap when the
// return exceeds cap - the scan is cheap enough to re-run), or -1 when
// nwords exceeds the compiled state budget.
// codes:   [n] uint8 text codes
// u:       [alpha][nwords] uint64 accept masks
// s,e:     [nwords] start-bit / end-bit masks
// rows:    caller scratch, (k+1)*nwords uint64 (zeroed here)
// out_end/out_bit/out_mism: [cap] hit buffers
int64_t sat_shift_and_scan(const uint8_t* codes, int64_t n,
                           const uint64_t* u, int32_t alpha, int32_t nwords,
                           const uint64_t* s, const uint64_t* e,
                           int32_t k, int32_t poison_eos, int32_t eos_code,
                           uint64_t* rows,
                           int64_t* out_end, int32_t* out_bit,
                           int32_t* out_mism, int64_t cap) {
  if (nwords > kMaxWords || nwords <= 0) return -1;
  const int32_t nr = k + 1;
  std::memset(rows, 0, sizeof(uint64_t) * (size_t)nr * nwords);
  uint64_t oldprev[kMaxWords];  // row i-1 before its update this char
  uint64_t tmp[kMaxWords];      // row i before its update this char
  int64_t nhits = 0;
  for (int64_t t = 0; t < n; ++t) {
    const uint8_t c = codes[t];
    if (poison_eos && (int32_t)c == eos_code) {
      std::memset(rows, 0, sizeof(uint64_t) * (size_t)nr * nwords);
      continue;
    }
    const uint64_t* uc = u + (size_t)c * nwords;
    uint64_t any_end = 0;
    for (int32_t i = 0; i < nr; ++i) {
      uint64_t* ri = rows + (size_t)i * nwords;
      std::memcpy(tmp, ri, sizeof(uint64_t) * nwords);
      uint64_t ca = 0, cb = 0;
      for (int32_t w = 0; w < nwords; ++w) {
        const uint64_t sha = (tmp[w] << 1) | ca;
        ca = tmp[w] >> 63;
        uint64_t val = (sha | s[w]) & uc[w];
        if (i > 0) {
          const uint64_t shb = (oldprev[w] << 1) | cb;
          cb = oldprev[w] >> 63;
          val |= shb | s[w];
        }
        ri[w] = val;
        any_end |= val & e[w];
      }
      std::memcpy(oldprev, tmp, sizeof(uint64_t) * nwords);
    }
    if (any_end) {
      for (int32_t w = 0; w < nwords; ++w) {
        uint64_t bits = rows[(size_t)(nr - 1) * nwords + w] & e[w];
        while (bits) {
          const int32_t b = __builtin_ctzll(bits);
          bits &= bits - 1;
          int32_t mism = nr - 1;
          for (int32_t i = 0; i < nr - 1; ++i) {
            if (rows[(size_t)i * nwords + w] & (1ULL << b)) { mism = i; break; }
          }
          if (nhits < cap) {
            out_end[nhits] = t + 1;
            out_bit[nhits] = w * 64 + b;
            out_mism[nhits] = mism;
          }
          ++nhits;
        }
      }
    }
  }
  return nhits;
}

}  // extern "C"

// Threaded exact/k-mismatch shift-and: the row state at any character
// depends only on the previous (longest pattern - 1) characters (row
// bit j encodes "prefix of length j+1 ends here", and poison resets
// only shorten the memory), so chunks warmed up over a halo of that
// width reproduce every row bit exactly.  Per-chunk hits land in local
// vectors and are copied out in chunk order — which IS global end-
// position order, the single-thread emission contract.
namespace {

struct SAHit {
  int64_t end;
  int32_t bit;
  int32_t mism;
};

void sa_scan_range(const uint8_t* codes, int64_t t0, int64_t t1,
                   int64_t emit_from, const uint64_t* u, int32_t nwords,
                   const uint64_t* s, const uint64_t* e, int32_t k,
                   int32_t poison_eos, int32_t eos_code,
                   std::vector<SAHit>* out) {
  const int32_t nr = k + 1;
  std::vector<uint64_t> rowbuf((size_t)nr * nwords, 0);
  uint64_t* rows = rowbuf.data();
  uint64_t oldprev[kMaxWords];
  uint64_t tmp[kMaxWords];
  for (int64_t t = t0; t < t1; ++t) {
    const uint8_t c = codes[t];
    if (poison_eos && (int32_t)c == eos_code) {
      std::memset(rows, 0, sizeof(uint64_t) * (size_t)nr * nwords);
      continue;
    }
    const uint64_t* uc = u + (size_t)c * nwords;
    uint64_t any_end = 0;
    for (int32_t i = 0; i < nr; ++i) {
      uint64_t* ri = rows + (size_t)i * nwords;
      std::memcpy(tmp, ri, sizeof(uint64_t) * nwords);
      uint64_t ca = 0, cb = 0;
      for (int32_t w = 0; w < nwords; ++w) {
        const uint64_t sha = (tmp[w] << 1) | ca;
        ca = tmp[w] >> 63;
        uint64_t val = (sha | s[w]) & uc[w];
        if (i > 0) {
          const uint64_t shb = (oldprev[w] << 1) | cb;
          cb = oldprev[w] >> 63;
          val |= shb | s[w];
        }
        ri[w] = val;
        any_end |= val & e[w];
      }
      std::memcpy(oldprev, tmp, sizeof(uint64_t) * nwords);
    }
    if (any_end && t >= emit_from) {
      for (int32_t w = 0; w < nwords; ++w) {
        uint64_t bits = rows[(size_t)(nr - 1) * nwords + w] & e[w];
        while (bits) {
          const int32_t b = __builtin_ctzll(bits);
          bits &= bits - 1;
          int32_t mism = nr - 1;
          for (int32_t i = 0; i < nr - 1; ++i) {
            if (rows[(size_t)i * nwords + w] & (1ULL << b)) {
              mism = i;
              break;
            }
          }
          out->push_back(SAHit{t + 1, w * 64 + b, mism});
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Threaded variant of sat_shift_and_scan: halo = longest pattern - 1
// (the exact state memory); nthreads <= 0 picks the hardware count.
// Same output contract (total count; retry when total > cap).
int64_t sat_shift_and_scan_mt(const uint8_t* codes, int64_t n,
                              const uint64_t* u, int32_t alpha,
                              int32_t nwords,
                              const uint64_t* s, const uint64_t* e,
                              int32_t k, int32_t poison_eos,
                              int32_t eos_code, int32_t halo,
                              int32_t nthreads,
                              int64_t* out_end, int32_t* out_bit,
                              int32_t* out_mism, int64_t cap) {
  (void)alpha;
  if (nwords > kMaxWords || nwords <= 0 || halo < 0) return -1;
  int32_t nt = nthreads > 0 ? nthreads
                            : (int32_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  const int64_t min_chunk = 1 << 18;
  int64_t chunk = (n + nt - 1) / nt;
  if (chunk < min_chunk) chunk = min_chunk;
  std::vector<std::vector<SAHit>> outs;
  std::vector<std::thread> threads;
  std::vector<std::array<int64_t, 3>> ranges;
  for (int64_t lo = 0; lo < n; lo += chunk) {
    const int64_t hi = std::min(lo + chunk, n);
    const int64_t t0 = std::max<int64_t>(lo - halo, 0);
    ranges.push_back({t0, hi, lo});
  }
  outs.resize(ranges.size());
  if (ranges.size() == 1) {
    sa_scan_range(codes, ranges[0][0], ranges[0][1], ranges[0][2], u,
                  nwords, s, e, k, poison_eos, eos_code, &outs[0]);
  } else {
    for (size_t i = 0; i < ranges.size(); ++i)
      threads.emplace_back(sa_scan_range, codes, ranges[i][0],
                           ranges[i][1], ranges[i][2], u, nwords, s, e, k,
                           poison_eos, eos_code, &outs[i]);
    for (auto& th : threads) th.join();
  }
  int64_t total = 0;
  for (const auto& v : outs) {
    for (const auto& h : v) {
      if (total < cap) {
        out_end[total] = h.end;
        out_bit[total] = h.bit;
        out_mism[total] = h.mism;
      }
      ++total;
    }
  }
  return total;
}

}  // extern "C"

// k-EDIT rows (the Wu-Manber/agrep indel generalization,
// shift_and_inexact.cc:265-315 semantics == the level sets of the
// Sellers semi-global DP: bit (p, j) of row i <=> the length-(j+1)
// prefix of pattern p aligns to some text substring ending at the
// current character with <= i edits):
//
//   Ri' = (((Ri << 1) | S) & U[c])        match
//       | ((R(i-1)_old << 1) | S)         substitution
//       | R(i-1)_old                      insertion (text char consumed)
//       | (R(i-1)' << 1) & ~S             deletion (uses the row already
//                                          updated THIS char: deletions
//                                          consume no text and chain
//                                          upward through the rows;
//                                          masked at start bits so they
//                                          never bleed across patterns)
//       | INIT_i                          free-start prefix deletions
//                                          (run bits 0..i-1: first i
//                                          pattern chars deleted, cost i)
//
// An EOS character resets every row to INIT and emits nothing: the
// Sellers DP disallows every error transition on EOS, so no alignment
// spans an entry boundary and the scan restarts fresh after it.
// Emission: end bit set in row k at text char t => candidate boundary
// t + 1; rows are monotone, so the minimal row whose end bit is set is
// the exact mindist.
//
// Layout: rows double-buffered (old/new pointer swap per char — the
// memcpy form measured 3.5 s per 16 MB; this one ~0.9 s single-thread)
// and the word loop specialized on the word count.  Threaded over text
// chunks: any <= k-edit alignment spans at most Lmax + k text chars, so
// a chunk warmed up over that halo reproduces every row bit exactly.

namespace {

constexpr int32_t kMaxRows = 9;  // k <= 8

template <int NW>
void sellers_range(const uint8_t* codes, int64_t t0, int64_t t1,
                   int64_t emit_from, const uint64_t* u, int32_t nr,
                   const uint64_t* s, const uint64_t* e,
                   const uint64_t* init, int32_t eos_code,
                   int64_t* out_end, int32_t* out_bit, int32_t* out_mism,
                   int64_t cap, std::atomic<int64_t>* nhits) {
  uint64_t bufa[kMaxRows][NW], bufb[kMaxRows][NW];
  uint64_t (*old_r)[NW] = bufa, (*new_r)[NW] = bufb;
  for (int32_t i = 0; i < nr; ++i)
    for (int32_t w = 0; w < NW; ++w) old_r[i][w] = init[i * NW + w];
  for (int64_t t = t0; t < t1; ++t) {
    const uint8_t c = codes[t];
    if ((int32_t)c == eos_code) {
      for (int32_t i = 0; i < nr; ++i)
        for (int32_t w = 0; w < NW; ++w) old_r[i][w] = init[i * NW + w];
      continue;
    }
    const uint64_t* uc = u + (size_t)c * NW;
    uint64_t any_end = 0;
    for (int32_t i = 0; i < nr; ++i) {
      uint64_t ca = 0, cb = 0, cd = 0;
      for (int32_t w = 0; w < NW; ++w) {
        const uint64_t ro = old_r[i][w];
        const uint64_t sha = (ro << 1) | ca;
        ca = ro >> 63;
        uint64_t val = (sha | s[w]) & uc[w];
        if (i > 0) {
          const uint64_t po = old_r[i - 1][w];
          const uint64_t pn = new_r[i - 1][w];
          const uint64_t shb = (po << 1) | cb;
          cb = po >> 63;
          const uint64_t shd = (pn << 1) | cd;
          cd = pn >> 63;
          val |= (shb | s[w]) | po | (shd & ~s[w]);
        }
        val |= init[i * NW + w];
        new_r[i][w] = val;
        any_end |= val & e[w];
      }
    }
    uint64_t (*sw)[NW] = old_r;
    old_r = new_r;
    new_r = sw;
    if (any_end && t >= emit_from) {
      for (int32_t w = 0; w < NW; ++w) {
        uint64_t bits = old_r[nr - 1][w] & e[w];
        while (bits) {
          const int32_t b = __builtin_ctzll(bits);
          bits &= bits - 1;
          int32_t mism = nr - 1;
          for (int32_t i = 0; i < nr - 1; ++i)
            if (old_r[i][w] & (1ULL << b)) { mism = i; break; }
          const int64_t slot = nhits->fetch_add(1, std::memory_order_relaxed);
          if (slot < cap) {
            out_end[slot] = t + 1;
            out_bit[slot] = w * 64 + b;
            out_mism[slot] = mism;
          }
        }
      }
    }
  }
}

using SellersRangeFn = void (*)(const uint8_t*, int64_t, int64_t, int64_t,
                                const uint64_t*, int32_t, const uint64_t*,
                                const uint64_t*, const uint64_t*, int32_t,
                                int64_t*, int32_t*, int32_t*, int64_t,
                                std::atomic<int64_t>*);

template <int... NW>
SellersRangeFn pick_sellers(int32_t nwords, std::integer_sequence<int, NW...>) {
  SellersRangeFn fn = nullptr;
  (void)std::initializer_list<int>{
      (nwords == NW + 1 ? (fn = &sellers_range<NW + 1>, 0) : 0)...};
  return fn;
}

}  // namespace

extern "C" {

// Exact multi-pattern mer scan: rolling base-alpha window codes probed
// against an open-addressing hash of the pattern codes — the reference's
// xmers / hash_table mer lookup (hash_table.cc:144-226) as a native
// threaded pass.  This is the huge-P exact regime where ANY dense
// correlation design is MXU-FLOP-bound (O(n * P * K): 50k patterns over
// 16 Mbases is ~210 TFLOP on the MXU, =~ 0.5 s at v5e int8 peak), so
// the speed-of-light here is a memory-bound hash probe per position.
//
// Table: tsize power-of-2 slots; keys[slot] uint64 (~0ULL = empty),
// head[slot] = first entry index; duplicate pattern codes chain through
// enext[]; epid[] maps entries to pattern ids.  EOS needs no special
// case: it is a live alphabet digit that no pattern contains, so any
// window crossing an entry boundary rolls to a code that cannot match.
namespace {

inline int64_t mer_hash(uint64_t code, int64_t tmask) {
  return (int64_t)((code * 0x9E3779B97F4A7C15ULL) >> 32) & tmask;
}

// second independent hash for the (ideally L1-resident) bloom
// prefilter: most positions miss, and testing one bit in a small
// bitmap beats loading from the (L2-sized) slot table.  The bit count
// scales with the pattern count (conv_scan._mer_native) — a fixed
// 2^19-bit filter saturates to ~17% false positives at P = 100k.
inline int64_t mer_bloom_bit(uint64_t code, int32_t shift) {
  return (int64_t)((code * 0xC2B2AE3D27D4EB4FULL) >> shift);
}

// Inline banded PREFIX extension gate on a census hit (the pigeonhole
// engines' exact_halves/exact_bases seeds, exact_halves.cc:120-224):
// a full <= k-edit extension implies its prefix aligns within k under a
// cost model that never overcharges (sub/indel cost 1, out-of-range
// text = a plain mismatch), so a prefix minimum > k soundly rejects the
// candidate before it ever leaves the scan thread — at xmers phase-2
// rates (~10% of positions are random half-seed hits) this prunes ~90%
// of the output while the text block is still cache-hot.
inline bool mer_gate_pass(const uint8_t* codes, int64_t n, int64_t s,
                          int32_t L, int32_t pid, const int8_t* gdir,
                          const uint8_t* gpref, const uint8_t* gglen,
                          int32_t G, int32_t k, int32_t band) {
  const int32_t g = gglen[pid];
  if (g <= 0) return true;
  const uint8_t* pp = gpref + (size_t)pid * G;
  int64_t row[2 * 8 + 1];
  for (int32_t d = 0; d <= 2 * band; ++d)
    row[d] = d >= band ? d - band : band - d;
  for (int32_t p = 1; p <= g; ++p) {
    const uint8_t pc = pp[p - 1];
    int64_t prev = 1 << 20, rowmin = 1 << 20;
    for (int32_t d = 0; d <= 2 * band; ++d) {
      const int64_t t = (int64_t)p + d - band;
      int64_t v = 1 << 20;
      if (t >= 1) {
        const int64_t pos = gdir[pid] > 0 ? s + L + t - 1 : s - t;
        const uint8_t tc =
            (pos >= 0 && pos < n) ? codes[pos] : (uint8_t)0xFE;
        v = row[d] + (tc == pc ? 0 : 1);
        if (d + 1 <= 2 * band && row[d + 1] + 1 < v) v = row[d + 1] + 1;
        if (prev + 1 < v) v = prev + 1;
      } else if (t == 0 && d + 1 <= 2 * band) {
        v = row[d + 1] + 1;
      }
      prev = v;
      row[d] = v;
      if (v < rowmin) rowmin = v;
    }
    if (rowmin > k) return false;
  }
  return true;
}

// Packed-gate variant of mer_gate_pass: the per-pattern gate metadata
// (direction, prefix length, up to 6 prefix codes) lives in ONE uint64
// per pattern — the generic three-array form costs ~3 random cache
// lines per gated candidate (gdir + gglen + the gpref row), which at
// xmers-phase-2 rates (~200k candidates/2 Mb) measured ~2/3 of the
// whole gate cost.  Bit layout (see ops/conv_scan._mer_native):
//   [0:2]  direction (0 = ungated, 1 = forward, 2 = backward)
//   [2:6]  prefix length g (<= 6)
//   [16:]  g prefix codes, 8 bits each
// The DP recurrence is byte-identical to mer_gate_pass (int32 cells,
// text window gathered once with the same s+L+t-1 / s-t mapping and
// 0xFE out-of-range poison).
inline bool mer_gate_pass_packed(const uint8_t* codes, int64_t n,
                                 int64_t s, int32_t L, uint64_t gm,
                                 int32_t k, int32_t band) {
  const int32_t g = (int32_t)((gm >> 2) & 15);
  const int32_t dir = (int32_t)(gm & 3);
  if (dir == 0 || g == 0) return true;
  uint8_t tc[16];
  const int32_t span = g + band;
  if (dir == 1) {
    const int64_t base = s + L;
    if (base + span <= n) {
      for (int32_t j = 0; j < span; ++j) tc[j] = codes[base + j];
    } else {
      for (int32_t j = 0; j < span; ++j) {
        const int64_t pos = base + j;
        tc[j] = pos < n ? codes[pos] : (uint8_t)0xFE;
      }
    }
  } else {
    if (s - span >= 0) {
      for (int32_t j = 0; j < span; ++j) tc[j] = codes[s - 1 - j];
    } else {
      for (int32_t j = 0; j < span; ++j) {
        const int64_t pos = s - 1 - j;
        tc[j] = pos >= 0 ? codes[pos] : (uint8_t)0xFE;
      }
    }
  }
  if (band == 1) {
    // fully-unrolled 3-diagonal form (the k=1 gate, the xmers phase-2
    // hot case) — recurrence identical to the generic loop below
    int32_t r0, r1, r2;
    uint64_t pb = gm >> 16;
    {
      // p = 1 against row init [1, 0, 1]:
      //   v0 = row[1] + 1 = 1 (t = 0 insertion path)
      //   v1 = min(0 + mism(tc[0]), min(row[2], v0) + 1) = mism(tc[0])
      //   v2 = min(1 + mism(tc[1]), v1 + 1)
      const uint8_t pc = (uint8_t)(pb & 0xFF);
      const int32_t v1 = (tc[0] != pc);
      int32_t v2 = 1 + (tc[1] != pc);
      if (v1 + 1 < v2) v2 = v1 + 1;
      r0 = 1; r1 = v1; r2 = v2;
      if (r0 > k && r1 > k && r2 > k) return false;
      pb >>= 8;
    }
    for (int32_t p = 2; p <= g; ++p, pb >>= 8) {
      const uint8_t pc = (uint8_t)(pb & 0xFF);
      int32_t v0 = r0 + (tc[p - 2] != pc);
      if (r1 + 1 < v0) v0 = r1 + 1;
      int32_t v1 = r1 + (tc[p - 1] != pc);
      const int32_t m01 = r2 < v0 ? r2 : v0;
      if (m01 + 1 < v1) v1 = m01 + 1;
      int32_t v2 = r2 + (tc[p] != pc);
      if (v1 + 1 < v2) v2 = v1 + 1;
      r0 = v0; r1 = v1; r2 = v2;
      if (r0 > k && r1 > k && r2 > k) return false;
    }
    return true;
  }
  int32_t row[2 * 8 + 1];
  for (int32_t d = 0; d <= 2 * band; ++d)
    row[d] = d >= band ? d - band : band - d;
  uint64_t pbits = gm >> 16;
  for (int32_t p = 1; p <= g; ++p, pbits >>= 8) {
    const uint8_t pc = (uint8_t)(pbits & 0xFF);
    int32_t prev = 1 << 20, rowmin = 1 << 20;
    for (int32_t d = 0; d <= 2 * band; ++d) {
      const int32_t t = p + d - band;
      int32_t v = 1 << 20;
      if (t >= 1) {
        v = row[d] + (tc[t - 1] == pc ? 0 : 1);
        if (d + 1 <= 2 * band && row[d + 1] + 1 < v) v = row[d + 1] + 1;
        if (prev + 1 < v) v = prev + 1;
      } else if (t == 0 && d + 1 <= 2 * band) {
        v = row[d + 1] + 1;
      }
      prev = v;
      row[d] = v;
      if (v < rowmin) rowmin = v;
    }
    if (rowmin > k) return false;
  }
  return true;
}

void mer_scan_range(const uint8_t* codes, int64_t n, int64_t lo,
                    int64_t hi, int64_t nstarts, int32_t L,
                    uint64_t alpha, uint64_t topmul, const uint64_t* keys,
                    const int32_t* head, const int32_t* enext,
                    const int32_t* epid, int64_t tmask,
                    const uint64_t* bloom, int32_t bloom_shift,
                    const int8_t* gdir, const uint8_t* gpref,
                    const uint8_t* gglen, int32_t G, int32_t gk,
                    int32_t gband, const uint64_t* gpack,
                    int64_t* out_start, int32_t* out_pid, int64_t cap,
                    std::atomic<int64_t>* nhits) {
  // Blocked three-phase walk (the branchy one-pass form measured ~4x
  // slower at high hit densities): per 2048-position block, (1) the
  // rolling codes land in a stack buffer — a pure dependency chain the
  // core pipelines at ~1 mul/cycle; (2) a BRANCHLESS bloom sweep packs
  // candidate indices (the sum of a predicate, no mispredicts); (3)
  // only candidates probe the slot table, with the next candidate's
  // slot prefetched.  Hits buffer thread-locally and reserve output
  // space in batches — the old per-hit fetch_add serialized all
  // threads on one cache line (~10 ms per 200k hits measured).
  constexpr int64_t BL = 2048;
  constexpr int PEND = 1024;
  uint64_t codebuf[BL];
  int32_t cand[BL];
  int64_t pend_s[PEND];
  int32_t pend_p[PEND];
  int npend = 0;
  auto flush = [&]() {
    if (!npend) return;
    const int64_t base =
        nhits->fetch_add(npend, std::memory_order_relaxed);
    const int64_t take = std::min<int64_t>(
        npend, std::max<int64_t>(cap - base, 0));
    for (int64_t i = 0; i < take; ++i) {
      out_start[base + i] = pend_s[i];
      out_pid[base + i] = pend_p[i];
    }
    npend = 0;
  };
  uint64_t code = 0;
  for (int64_t j = lo; j < lo + L; ++j) code = code * alpha + codes[j];
  for (int64_t blo = lo; blo < hi; blo += BL) {
    const int64_t bl = std::min(BL, hi - blo);
    for (int64_t i = 0; i < bl; ++i) {
      codebuf[i] = code;
      const int64_t s = blo + i;
      // the final position of the whole scan has no successor window
      const uint64_t nxt = (s + 1 < nstarts) ? codes[s + L] : 0;
      code = (code - codes[s] * topmul) * alpha + nxt;
    }
    int64_t nc = 0;
    for (int64_t i = 0; i < bl; ++i) {
      const int64_t b = mer_bloom_bit(codebuf[i], bloom_shift);
      cand[nc] = (int32_t)i;
      nc += (bloom[b >> 6] >> (b & 63)) & 1;
    }
    int64_t slots[BL];
    for (int64_t j = 0; j < nc; ++j)
      slots[j] = mer_hash(codebuf[cand[j]], tmask);
    // packed-gate mode runs the chain walk and the gate DP as TWO
    // passes over a small queue: the gate record load (gpack[pid],
    // random into a ~P*8-byte array) is prefetched at enqueue time so
    // the DP never stalls on it — as a dependent load on the critical
    // path it measured ~half the per-candidate gate cost
    int32_t gq_i[256];
    int32_t gq_pid[256];
    int ngq = 0;
    auto gate_drain = [&]() {
      for (int q = 0; q < ngq; ++q) {
        const int64_t s = blo + gq_i[q];
        const int32_t pid = gq_pid[q];
        if (mer_gate_pass_packed(codes, n, s, L, gpack[pid], gk, gband)) {
          pend_s[npend] = s;
          pend_p[npend] = pid;
          if (++npend == PEND) flush();
        }
      }
      ngq = 0;
    };
    for (int64_t j = 0; j < nc; ++j) {
      if (j + 2 < nc) __builtin_prefetch(&keys[slots[j + 2]]);
      int64_t slot = slots[j];
      const uint64_t c = codebuf[cand[j]];
      while (true) {
        const uint64_t k = keys[slot];
        if (k == ~0ULL) break;
        if (k == c) {
          for (int32_t e = head[slot]; e >= 0; e = enext[e]) {
            const int32_t pid = epid[e];
            if (gpack != nullptr) {
              __builtin_prefetch(&gpack[pid]);
              gq_i[ngq] = cand[j];
              gq_pid[ngq] = pid;
              if (++ngq == 256) gate_drain();
              continue;
            }
            if (gdir != nullptr && gdir[pid] != 0 &&
                !mer_gate_pass(codes, n, blo + cand[j], L, pid,
                               gdir, gpref, gglen, G, gk, gband)) {
              continue;
            }
            pend_s[npend] = blo + cand[j];
            pend_p[npend] = pid;
            if (++npend == PEND) flush();
          }
          break;
        }
        slot = (slot + 1) & tmask;
      }
    }
    if (gpack != nullptr) gate_drain();
  }
  flush();
}

// Direct-address variant of the census walk for base-4 (DNA) seed sets
// with 2*L <= 22 bits: the rolling window code IS the table index
// (head4[4^L], L3-resident at <= 16 MB), so the bloom filter, the
// 64-bit key compare, and the open-addressing walk all disappear —
// one load per position.  Window validity under chars with code >= 4
// (EOS / ambiguity codes, which base-4 masking would alias) rides a
// last-bad-position watermark.  Matches the hash walk's output order
// and gate semantics (packed gate only).
void mer_scan_range_d4(const uint8_t* codes, const uint8_t* pack,
                       const int64_t* bad, int64_t nbad, int64_t n,
                       int64_t lo, int64_t hi, int64_t nstarts, int32_t L,
                       const int32_t* head4, const int32_t* enext,
                       const int32_t* epid, const uint64_t* bit4,
                       int32_t gk, int32_t gband, const uint64_t* gpack,
                       int64_t* out_start, int32_t* out_pid, int64_t cap,
                       std::atomic<int64_t>* nhits) {
  constexpr int64_t BL = 2048;
  constexpr int PEND = 1024;
  uint32_t codebuf[BL];
  uint8_t okbuf[BL];
  int32_t cand[BL];
  int64_t pend_s[PEND];
  int32_t pend_p[PEND];
  int npend = 0;
  auto flush = [&]() {
    if (!npend) return;
    const int64_t base =
        nhits->fetch_add(npend, std::memory_order_relaxed);
    const int64_t take = std::min<int64_t>(
        npend, std::max<int64_t>(cap - base, 0));
    for (int64_t i = 0; i < take; ++i) {
      out_start[base + i] = pend_s[i];
      out_pid[base + i] = pend_p[i];
    }
    npend = 0;
  };
  int64_t bcur = 0;
  int32_t gq_i[256];
  int32_t gq_pid[256];
  int ngq = 0;
  auto gate_drain = [&]() {
    for (int q = 0; q < ngq; ++q) {
      const int64_t s = bcur + gq_i[q];
      const int32_t pid = gq_pid[q];
      if (mer_gate_pass_packed(codes, n, s, L, gpack[pid], gk, gband)) {
        pend_s[npend] = s;
        pend_p[npend] = pid;
        if (++npend == PEND) flush();
      }
    }
    ngq = 0;
  };
  const int32_t shr = 64 - 2 * L;
  // bad-position cursor: bad[] is the sorted (static per database)
  // list of chars with code >= 4; a window [s, s+L) is valid iff no
  // bad position lands in it
  int64_t bi = 0;
  while (bi < nbad && bad[bi] < lo) ++bi;
  for (int64_t blo = lo; blo < hi; blo += BL) {
    bcur = blo;
    const int64_t bl = std::min(BL, hi - blo);
    // phase 1: window codes from the 2-bit packed text — one 8-byte
    // big-endian load covers 4 consecutive positions (L <= 11 always
    // fits the remaining 28+ bits)
    for (int64_t i = 0; i < bl; ++i) {
      const int64_t s = blo + i;
      uint64_t w;
      std::memcpy(&w, pack + (s >> 2), 8);
      w = __builtin_bswap64(w);
      codebuf[i] = (uint32_t)((w << (2 * (s & 3))) >> shr);
    }
    // validity: common case is zero bad positions in the block span
    if (bi >= nbad || bad[bi] >= blo + bl + L - 1) {
      std::memset(okbuf, 1, bl);
    } else {
      // windows [s, s+L) with s in [blo, blo+bl): position s is
      // invalid iff the next bad position >= s is < s + L
      int64_t bj = bi;
      for (int64_t i = 0; i < bl; ++i) {
        const int64_t s = blo + i;
        while (bj < nbad && bad[bj] < s) ++bj;
        okbuf[i] = !(bj < nbad && bad[bj] < s + L);
      }
    }
    while (bi < nbad && bad[bi] < blo + bl) ++bi;
    // phase 2: exact presence test against the L2-resident bitmap
    // (head4 itself is up to 16 MB — touching it per position was the
    // dominant sweep cost)
    int64_t nc = 0;
    for (int64_t i = 0; i < bl; ++i) {
      const uint32_t c = codebuf[i];
      cand[nc] = (int32_t)i;
      nc += (int64_t)(((bit4[c >> 6] >> (c & 63)) & 1) & okbuf[i]);
    }
    // phase 3: chain walk on the candidates only, heads prefetched
    for (int64_t j = 0; j < nc; ++j) {
      if (j + 4 < nc) __builtin_prefetch(&head4[codebuf[cand[j + 4]]]);
      const int64_t i = cand[j];
      for (int32_t e = head4[codebuf[i]]; e >= 0; e = enext[e]) {
        const int32_t pid = epid[e];
        if (gpack != nullptr) {
          __builtin_prefetch(&gpack[pid]);
          gq_i[ngq] = (int32_t)i;
          gq_pid[ngq] = pid;
          if (++ngq == 256) gate_drain();
        } else {
          pend_s[npend] = blo + i;
          pend_p[npend] = pid;
          if (++npend == PEND) flush();
        }
      }
    }
    if (gpack != nullptr) gate_drain();
  }
  flush();
}

}  // namespace

int64_t sat_mer_scan_d4(const uint8_t* codes, const uint8_t* pack,
                        const int64_t* bad, int64_t nbad, int64_t n,
                        int32_t L, const int32_t* head4,
                        const int32_t* enext, const int32_t* epid,
                        const uint64_t* bit4,
                        int32_t gate_k, int32_t gate_band,
                        const uint64_t* gate_pack, int32_t nthreads,
                        int64_t* out_start, int32_t* out_pid,
                        int64_t cap) {
  if (n < L || L <= 0 || L > 11) return -1;
  if (gate_pack != nullptr && (gate_band < 0 || gate_band > 8)) return -1;
  const int64_t nstarts = n - L + 1;
  std::atomic<int64_t> nhits{0};
  int32_t nt = nthreads > 0 ? nthreads
                            : (int32_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  const int64_t min_chunk = 1 << 16;
  if (nstarts < 2 * min_chunk || nt == 1) {
    mer_scan_range_d4(codes, pack, bad, nbad, n, 0, nstarts, nstarts, L,
                      head4, enext, epid, bit4, gate_k, gate_band,
                      gate_pack, out_start, out_pid, cap, &nhits);
    return nhits.load();
  }
  int64_t chunk = (nstarts + nt - 1) / nt;
  if (chunk < min_chunk) chunk = min_chunk;
  std::vector<std::thread> threads;
  for (int64_t lo = 0; lo < nstarts; lo += chunk) {
    const int64_t hi = std::min(lo + chunk, nstarts);
    threads.emplace_back(mer_scan_range_d4, codes, pack, bad, nbad, n,
                         lo, hi, nstarts, L, head4, enext, epid, bit4,
                         gate_k, gate_band, gate_pack, out_start,
                         out_pid, cap, &nhits);
  }
  for (auto& th : threads) th.join();
  return nhits.load();
}

int64_t sat_mer_scan(const uint8_t* codes, int64_t n, int32_t L,
                     int64_t alpha, const uint64_t* keys,
                     const int32_t* head, const int32_t* enext,
                     const int32_t* epid, int64_t tsize,
                     const uint64_t* bloom, int32_t bloom_bits,
                     const int8_t* gate_dir, const uint8_t* gate_pref,
                     const uint8_t* gate_glen, int32_t gate_G,
                     int32_t gate_k, int32_t gate_band,
                     const uint64_t* gate_pack,
                     int32_t nthreads,
                     int64_t* out_start, int32_t* out_pid, int64_t cap) {
  if (n < L || L <= 0 || tsize <= 0 || (tsize & (tsize - 1))) return -1;
  if (bloom_bits < 6 || bloom_bits > 40) return -1;
  if ((gate_dir != nullptr || gate_pack != nullptr) &&
      (gate_band < 0 || gate_band > 8 || gate_G <= 0))
    return -1;
  const int32_t bloom_shift = 64 - bloom_bits;
  const int64_t nstarts = n - L + 1;
  uint64_t topmul = 1;
  for (int32_t j = 0; j < L - 1; ++j) topmul *= (uint64_t)alpha;
  std::atomic<int64_t> nhits{0};
  int32_t nt = nthreads > 0 ? nthreads
                            : (int32_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  const int64_t min_chunk = 1 << 16;
  const int64_t tmask = tsize - 1;
  if (nstarts < 2 * min_chunk || nt == 1) {
    mer_scan_range(codes, n, 0, nstarts, nstarts, L, alpha, topmul, keys,
                   head, enext, epid, tmask, bloom, bloom_shift,
                   gate_dir, gate_pref, gate_glen, gate_G, gate_k,
                   gate_band, gate_pack, out_start, out_pid, cap, &nhits);
    return nhits.load();
  }
  int64_t chunk = (nstarts + nt - 1) / nt;
  if (chunk < min_chunk) chunk = min_chunk;
  std::vector<std::thread> threads;
  for (int64_t lo = 0; lo < nstarts; lo += chunk) {
    const int64_t hi = std::min(lo + chunk, nstarts);
    threads.emplace_back(mer_scan_range, codes, n, lo, hi, nstarts, L,
                         alpha, topmul, keys, head, enext, epid, tmask,
                         bloom, bloom_shift, gate_dir, gate_pref,
                         gate_glen, gate_G, gate_k, gate_band, gate_pack,
                         out_start, out_pid, cap, &nhits);
  }
  for (auto& th : threads) th.join();
  return nhits.load();
}

// Sequential lasthit+dedup thinning over extension survivors, the
// exact_halves emission rule (exact_halves.cc:163-176 semantics as
// replicated in models/primer_match._halves_emit): rows arrive sorted
// (hit-end asc, half-id desc); keep row i iff
// he[i] > lasthit[pid[i]] + dedup, updating lasthit only on keeps.
// Replaces a ~12k-iteration Python loop (~3 ms at xmers phase-2 scale).
// lasthit must be zero-initialized, length >= npid.
int64_t sat_lasthit_dedup(const int64_t* pid, const int64_t* he,
                          int64_t m, int64_t dedup, int64_t* lasthit,
                          uint8_t* keep) {
  int64_t kept = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t p = pid[i];
    const int64_t h = he[i];
    const uint8_t take = h > lasthit[p] + dedup;
    keep[i] = take;
    if (take) {
      lasthit[p] = h;
      ++kept;
    }
  }
  return kept;
}

// Threaded k-edit scan.  halo = Lmax + k (the maximum text span of a
// <= k-edit alignment); nthreads <= 0 picks the hardware count.
// Returns the TOTAL hit count (> cap => caller retries with larger cap),
// or -1 when the state exceeds the compiled budget.
int64_t sat_sellers_scan(const uint8_t* codes, int64_t n,
                         const uint64_t* u, int32_t alpha, int32_t nwords,
                         const uint64_t* s, const uint64_t* e,
                         const uint64_t* init, int32_t k, int32_t eos_code,
                         int32_t halo, int32_t nthreads,
                         int64_t* out_end, int32_t* out_bit,
                         int32_t* out_mism, int64_t cap) {
  (void)alpha;
  if (nwords > 24 || nwords <= 0 || k + 1 > kMaxRows) return -1;
  SellersRangeFn fn =
      pick_sellers(nwords, std::make_integer_sequence<int, 24>{});
  if (!fn) return -1;
  std::atomic<int64_t> nhits{0};
  int32_t nt = nthreads > 0 ? nthreads
                            : (int32_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  const int64_t min_chunk = 1 << 16;
  if (n < 2 * min_chunk || nt == 1) {
    fn(codes, 0, n, 0, u, k + 1, s, e, init, eos_code, out_end, out_bit,
       out_mism, cap, &nhits);
    return nhits.load();
  }
  int64_t chunk = (n + nt - 1) / nt;
  if (chunk < min_chunk) chunk = min_chunk;
  std::vector<std::thread> threads;
  for (int64_t start = 0; start < n; start += chunk) {
    const int64_t end = std::min(start + chunk, n);
    const int64_t warm = std::max<int64_t>(0, start - halo);
    threads.emplace_back(fn, codes, warm, end, start, u, k + 1, s, e, init,
                         eos_code, out_end, out_bit, out_mism, cap, &nhits);
  }
  for (auto& th : threads) th.join();
  return nhits.load();
}

}  // extern "C"
