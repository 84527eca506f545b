// Native banded edit-distance verify DP — the host-side hot path of the
// candidate verification pipeline (one call per engine candidate).
//
// Exact port of engine/verify.py::EditDistAligner.align, which itself
// reproduces the reference's editdist_alignment (pattern_alignment.cc:117-705)
// bit for bit: right-anchored reversed DP, band +-k (+-1 in dna_mut mode),
// free trailing columns for the candidate end range, constraint-violation
// penalty 5k+1, early exit when a row's minimum exceeds k, diagonal-preferring
// best-end selection and gap-run-preserving traceback.
//
// Built as a plain C-ABI shared library (no pybind11 on this image); loaded
// via ctypes from engine/native.py with the pure-Python DP as fallback.

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t MAXVAL = 0xFFFFFFFFll;

// alignment codes (alignment_code.h:6-20)
enum {
  A_NONE = 0, A_EQUAL = 1, A_WC_EQUAL = 2, A_SUB = 3, A_INS = 4, A_DEL = 5,
  A_CONST_VIOL = 6, A_END = 7, A_SUB1 = 8, A_SUB2 = 9, A_SUB3 = 10,
  A_INS3 = 11, A_DEL3 = 12, N_CODES = 13,
};

// op-mask bits (alignment_code.h:22-36)
enum {
  M_NONE = 1, M_EQUAL = 2, M_WC = 4, M_SUB = 8, M_INS = 16, M_DEL = 32,
  M_CV = 64, M_END = 128, M_SUB1 = 256, M_SUB2 = 512, M_SUB3 = 1024,
  M_INS3 = 2048, M_DEL3 = 4096,
};

constexpr int DIAG = M_EQUAL | M_WC | M_SUB | M_SUB1 | M_SUB2 | M_SUB3;
constexpr int SUBS = M_SUB | M_SUB1 | M_SUB2 | M_SUB3;
constexpr int INSM = M_INS | M_INS3;
constexpr int DELM = M_DEL | M_DEL3;

struct Scratch {
  std::vector<int64_t> dp;
  std::vector<int32_t> best;
};

thread_local Scratch g_scratch;

}  // namespace

extern "C" {

// Returns 1 on success.  out_found/out_bestval/out_beststart/out_endt are
// always written; out_codes receives up to cap traceback codes in append
// order (same as the Python list), out_stats is a N_CODES int64 histogram.
int sat_verify_align(
    const unsigned char* pat, int32_t patlen,
    const unsigned char* buffer, int32_t buflen,
    const int8_t* cids,  // codon ids aligned with buffer, or nullptr
    int32_t k, uint8_t eos, int32_t wc, int32_t textn, int32_t indels,
    int32_t dna_mut, int32_t trans, int32_t yesno,
    int32_t esb, int32_t eeb, int64_t freecols,
    const uint8_t* compat,          // [256*256] or nullptr
    const int8_t* aasub,            // [256*256] or nullptr
    const int8_t* aacodonsub,       // [256*6*256] or nullptr
    int32_t* out_found, int32_t* out_bestval,
    int32_t* out_beststart, int32_t* out_endt,
    int32_t* out_codes, int32_t codes_cap, int32_t* out_ncodes,
    int64_t* out_stats) {
  const int band = indels ? (dna_mut ? 1 : k) : 0;
  const int64_t cvp = 5 * k + 1;
  const int64_t freec = freecols;

  int lbexact = 0;
  int rbexact = patlen + 1;
  if (esb > 0) rbexact = patlen + 1 - esb;
  if (eeb > 0) lbexact = eeb;

  const int P = patlen + 1;
  const int T = buflen + 1;
  Scratch& s = g_scratch;
  if ((int64_t)s.dp.size() < (int64_t)P * T) {
    s.dp.resize((size_t)P * T);
    s.best.resize((size_t)P * T);
  }
  int64_t* dp = s.dp.data();
  int32_t* best = s.best.data();
  for (int64_t i = 0; i < (int64_t)P * T; i++) dp[i] = MAXVAL;
  std::memset(best, 0, sizeof(int32_t) * (size_t)P * T);
#define DP(p, t) dp[(int64_t)(p) * T + (t)]
#define BEST(p, t) best[(int64_t)(p) * T + (t)]

  DP(0, 0) = 0;
  BEST(0, 0) = M_END;
  const int64_t gapc = dna_mut ? 3 : 1;

  int ub = band < patlen ? band : patlen;
  for (int p = 1; p <= ub; p++) {
    if (!indels || p < lbexact || p >= rbexact ||
        pat[patlen - p] == eos) {
      DP(p, 0) = cvp;
      BEST(p, 0) = M_CV;
    } else {
      DP(p, 0) = DP(p - 1, 0) + gapc;
      BEST(p, 0) = dna_mut ? M_DEL3 : M_DEL;
    }
  }
  int64_t ub2 = freec + band;
  if (ub2 > buflen) ub2 = buflen;
  for (int64_t t = 1; t <= ub2; t++) {
    if (t <= freec) {
      DP(0, t) = 0;
      BEST(0, t) = M_END;
    } else if (!indels || lbexact > 0) {
      DP(0, t) = cvp;
      BEST(0, t) = M_CV;
    } else {
      DP(0, t) = DP(0, t - 1) + gapc;
      BEST(0, t) = dna_mut ? M_INS3 : M_INS;
    }
  }

  *out_found = 0;
  *out_bestval = 0;
  *out_beststart = 0;
  *out_endt = 0;
  *out_ncodes = 0;
  for (int i = 0; i < N_CODES; i++) out_stats[i] = 0;

  for (int p = 1; p <= patlen; p++) {
    const unsigned char pc = pat[patlen - p];  // pat_rev[p-1]
    int64_t lb = p - band;
    if (lb < 1) lb = 1;
    int64_t ubr = p + freec + band;
    if (ubr > buflen) ubr = buflen;
    int64_t bestrow = cvp;
    for (int64_t t = lb; t <= ubr; t++) {
      const unsigned char tc = buffer[buflen - t];  // buf_rev[t-1]
      int64_t v;
      int32_t ac;
      if (tc == pc) {
        v = DP(p - 1, t - 1);
        ac = M_EQUAL;
      } else if (wc && compat && compat[(size_t)pc * 256 + tc] &&
                 (tc != 'N' || textn)) {
        v = DP(p - 1, t - 1);
        ac = M_WC;
      } else if (tc == eos || pc == eos || p <= lbexact || p >= rbexact) {
        v = cvp;
        ac = M_CV;
      } else if (!dna_mut) {
        v = DP(p - 1, t - 1) + 1;
        ac = M_SUB;
      } else {
        int mut;
        if (trans) {
          const int cid = cids ? cids[buflen - t] : -1;
          mut = (cid >= 0 && cid < 6)
                    ? aacodonsub[((size_t)tc * 6 + cid) * 256 + pc]
                    : -1;
        } else {
          mut = aasub[(size_t)tc * 256 + pc];
        }
        if (mut >= 0) {
          v = DP(p - 1, t - 1) + (int64_t)mut;
          ac = (mut == 1) ? M_SUB1 : (mut == 2 ? M_SUB2 : M_SUB3);
        } else {
          v = cvp;
          ac = M_CV;
        }
      }
      // insertion (extra text char)
      if (tc == eos || pc == eos || !indels || t <= lb || p < lbexact ||
          p >= rbexact) {
        if (cvp < v) {
          v = cvp;
          ac = M_CV;
        }
      } else {
        const int64_t v1 = DP(p, t - 1) + gapc;
        const int32_t im = dna_mut ? M_INS3 : M_INS;
        if (v1 < v) {
          v = v1;
          ac = im;
        } else if (v1 == v) {
          ac |= im;
        }
      }
      // deletion (pattern char unmatched)
      if (!indels || pc == eos || t >= ubr || p <= lbexact || p >= rbexact) {
        if (cvp < v) {
          v = cvp;
          ac = M_CV;
        }
      } else {
        const int64_t v1 = DP(p - 1, t) + gapc;
        const int32_t dm = dna_mut ? M_DEL3 : M_DEL;
        if (v1 < v) {
          v = v1;
          ac = dm;
        } else if (v1 == v) {
          ac |= dm;
        }
      }
      DP(p, t) = v;
      BEST(p, t) = ac;
      if (v < bestrow) bestrow = v;
    }
    if (bestrow > (int64_t)k) {
      // early exit: not found; caller records a constraint violation
      *out_beststart = -1;
      if (!yesno) {
        out_stats[A_CONST_VIOL] = 1;
        if (codes_cap > 0) {
          out_codes[0] = A_CONST_VIOL;
          *out_ncodes = 1;
        }
      }
      return 1;
    }
  }

  // best end selection (pattern_alignment.cc:443-475)
  int64_t beststart = patlen - band;
  if (beststart > buflen) beststart = buflen;
  if (beststart < 0) beststart = 0;
  int64_t bestval = DP(patlen, beststart);
  int64_t ubb = patlen + freec + band;
  if (ubb > buflen) ubb = buflen;
  for (int64_t t = beststart + 1; t <= ubb; t++) {
    const int64_t v = DP(patlen, t);
    if (v < bestval || (v <= bestval && (BEST(patlen, t) & DIAG))) {
      bestval = v;
      beststart = t;
    }
  }

  int64_t p = patlen, t = beststart;
  if (t < p - band || t > p + band + freec) {
    *out_beststart = -1;
    if (!yesno) {
      out_stats[A_CONST_VIOL] = 1;
      if (codes_cap > 0) {
        out_codes[0] = A_CONST_VIOL;
        *out_ncodes = 1;
      }
    }
    return 1;
  }

  // traceback (pattern_alignment.cc:494-597)
  int lastac = A_NONE;
  int n = 0;
  while (!(BEST(p, t) & M_END)) {
    const int32_t ac = BEST(p, t);
    const bool match = (ac & DIAG) != 0;
    const bool wceq = (ac & M_WC) != 0;
    const bool sub = (ac & SUBS) != 0;
    const bool ins = (ac & INSM) != 0;
    const bool del = (ac & DELM) != 0;
    if (match && !((lastac == A_INS || lastac == A_INS3) && ins) &&
        !((lastac == A_DEL || lastac == A_DEL3) && del) &&
        !(lastac == A_WC_EQUAL && !wceq && (ins || del))) {
      p -= 1;
      t -= 1;
      if ((ac & M_EQUAL) && !((lastac == A_WC_EQUAL && wceq) ||
                              (lastac == A_SUB && sub))) {
        lastac = A_EQUAL;
      } else if (wceq) {
        lastac = A_WC_EQUAL;
      } else if (sub) {
        if (ac & M_SUB) lastac = A_SUB;
        else if (ac & M_SUB1) lastac = A_SUB1;
        else if (ac & M_SUB2) lastac = A_SUB2;
        else lastac = A_SUB3;
      }
    } else if (del) {
      p -= 1;
      lastac = (ac & M_DEL) ? A_DEL : A_DEL3;
    } else if (ins) {
      t -= 1;
      lastac = (ac & M_INS) ? A_INS : A_INS3;
    } else if (ac & M_CV) {
      p = 0;
      t = 0;
      lastac = A_CONST_VIOL;
    } else {
      return 0;  // bad traceback cell
    }
    if (!yesno) {
      out_stats[lastac] += 1;
      if (n < codes_cap) out_codes[n] = lastac;
      n += 1;
    }
  }
  *out_ncodes = n;
  *out_found = bestval <= (int64_t)k;
  *out_bestval = (int32_t)bestval;
  *out_beststart = (int32_t)beststart;
  *out_endt = (int32_t)t;
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Seed-extension DP (engine/extend.py::Extender.global_align, yesno path) —
// exact port of the reference's primer_alignment::global_align
// (primer_alignment.cc:10-299): banded global DP from an anchored side,
// direction +-1, constraint columns from the residual exact-base bounds,
// diagonal-preferring final-row selection.  One call per pigeonhole seed
// hit (exact_halves / exact_bases), the k>0 host hot loop.

extern "C" {

int sat_extend_align(
    const unsigned char* text, int32_t textlen,
    const unsigned char* pattern, int32_t patlen,
    int32_t dirn, int32_t lmatch, int32_t rmatch,
    int32_t k, uint8_t eos, int32_t wc, int32_t textn,
    int32_t indels, int32_t dna_mut,
    const uint8_t* compat, const int8_t* aasub,
    int32_t* out_ok, int32_t* out_matchlen, int32_t* out_value) {
  const int band = indels ? (dna_mut ? 1 : k) : 0;
  const int64_t cvp = 5 * (int64_t)k + 1;

  int lbexact = 0;
  int rbexact = patlen + 1;
  if (dirn < 0) {
    if (lmatch > 0) rbexact = patlen + 1 - lmatch;
    if (rmatch > 0) lbexact = rmatch;
  } else {
    if (lmatch > 0) lbexact = lmatch;
    if (rmatch > 0) rbexact = patlen + 1 - rmatch;
  }

  const int P = patlen + 1;
  const int T = textlen + 1;
  Scratch& s = g_scratch;
  if ((int64_t)s.dp.size() < (int64_t)P * T) {
    s.dp.resize((size_t)P * T);
    s.best.resize((size_t)P * T);
  }
  int64_t* dp = s.dp.data();
  int32_t* best = s.best.data();
  const int64_t INF = 1ll << 30;
  // LAZY banded initialization: the DP only ever reads cells inside the
  // band plus a one-cell frame around it, and the batched pigeonhole
  // callers run ~10^5 short candidates per scan — the former whole
  // P*T INF fill + best memset dominated their cost (the row loop
  // early-exits after ~k+2 rows on random candidates).  The frame cells
  // are pinned per row below: (p, lb-1) and (p-1, ub) when they fall
  // outside the previously computed region.
#define EDP(p, t) dp[(int64_t)(p) * T + (t)]
#define EBEST(p, t) best[(int64_t)(p) * T + (t)]

  *out_ok = 0;
  *out_matchlen = 0;
  *out_value = 0;

  EDP(0, 0) = 0;
  const int64_t gapc = dna_mut ? 3 : 1;

  int ub0 = band < patlen ? band : patlen;
  for (int p = 1; p <= ub0; p++) {
    if (!indels || p < lbexact || p >= rbexact) {
      EDP(p, 0) = cvp;
      EBEST(p, 0) = M_CV;
    } else {
      EDP(p, 0) = EDP(p - 1, 0) + gapc;
      EBEST(p, 0) = dna_mut ? M_DEL3 : M_DEL;
    }
  }
  int ub1 = band < textlen ? band : textlen;
  for (int t = 1; t <= ub1; t++) {
    const unsigned char tc =
        (dirn > 0) ? text[t - 1] : text[textlen - t];
    if (!indels || 0 < lbexact || 0 >= rbexact || tc == eos) {
      EDP(0, t) = cvp;
      EBEST(0, t) = M_CV;
    } else {
      EDP(0, t) = EDP(0, t - 1) + gapc;
      EBEST(0, t) = dna_mut ? M_INS3 : M_INS;
    }
  }

  for (int p = 1; p <= patlen; p++) {
    int lb = p - band;
    if (lb < 1) lb = 1;
    int ub = p + band;
    if (ub > textlen) ub = textlen;
    // banded-frame pins (see the lazy-init note above): the horizontal
    // arm reads (p, lb-1) and the vertical arm (p-1, ub), which the
    // previous rows never wrote when the band slides right
    if (lb > 1) EDP(p, lb - 1) = INF;
    if (ub > (p - 1) + band) EDP(p - 1, ub) = INF;
    int64_t bestrow = cvp;
    for (int t = lb; t <= ub; t++) {
      unsigned char tc, pc;
      if (dirn > 0) {
        tc = text[t - 1];
        pc = pattern[p - 1];
      } else {
        tc = text[textlen - t];
        pc = pattern[patlen - p];
      }
      int64_t v;
      int32_t ac;
      if (tc == pc) {
        v = EDP(p - 1, t - 1);
        ac = M_EQUAL;
      } else if (wc && compat && compat[(size_t)tc * 256 + pc] &&
                 (textn || tc != 'N')) {
        v = EDP(p - 1, t - 1);
        ac = M_WC;
      } else if (tc == eos || pc == eos || p <= lbexact || p >= rbexact) {
        v = cvp;
        ac = M_CV;
      } else if (!dna_mut) {
        v = EDP(p - 1, t - 1) + 1;
        ac = M_SUB;
      } else {
        const int mut = aasub ? aasub[(size_t)tc * 256 + pc] : -1;
        if (mut >= 0) {
          v = EDP(p - 1, t - 1) + (int64_t)mut;
          ac = (mut == 1) ? M_SUB1 : (mut == 2 ? M_SUB2 : M_SUB3);
        } else {
          v = cvp;
          ac = M_CV;
        }
      }
      int64_t v1;
      int32_t ac1;
      if (tc == eos || pc == eos || !indels || t <= lb || p < lbexact ||
          p >= rbexact) {
        v1 = cvp;
        ac1 = M_CV;
      } else {
        v1 = EDP(p, t - 1) + gapc;
        ac1 = dna_mut ? M_INS3 : M_INS;
      }
      if (v1 < v) {
        v = v1;
        ac = ac1;
      } else if (v1 == v) {
        ac |= ac1;
      }
      if (!indels || t >= ub || p <= lbexact || p >= rbexact) {
        v1 = cvp;
        ac1 = M_CV;
      } else {
        v1 = EDP(p - 1, t) + gapc;
        ac1 = dna_mut ? M_DEL3 : M_DEL;
      }
      if (v1 < v) {
        v = v1;
        ac = ac1;
      } else if (v1 == v) {
        ac |= ac1;
      }
      EDP(p, t) = v;
      EBEST(p, t) = ac;
      if (v < bestrow) bestrow = v;
    }
    if (bestrow > (int64_t)k) return 1;  // ok=0
  }

  int bestpos = patlen - band;
  if (bestpos > textlen) bestpos = textlen;
  if (bestpos < 0) bestpos = 0;
  int64_t bestval = EDP(patlen, bestpos);
  int ubf = patlen + band;
  if (ubf > textlen) ubf = textlen;
  for (int t = bestpos + 1; t <= ubf; t++) {
    const int64_t val = EDP(patlen, t);
    if (val < bestval || (val <= bestval && (EBEST(patlen, t) & DIAG))) {
      bestval = val;
      bestpos = t;
    }
  }
  if (bestpos < patlen - band || bestpos > patlen + band) return 1;
  *out_ok = 1;
  *out_matchlen = bestpos;
  *out_value = (int32_t)bestval;
  return 1;
#undef EDP
#undef EBEST
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched entry points: one C call per CANDIDATE ARRAY instead of one ctypes
// round-trip per candidate.  The per-candidate DPs above stay the single
// source of truth; the batch wrappers add only window materialization from
// the flat code array (the text_at() logic of models/primer_match.py:310-317:
// clamp to [0, n), decode alphabet codes to chars, pad with EOS) and the
// per-seed-id geometry of Extender.lmatch/rmatch (primer_alignment.cc:568-728)
// and EditDistAligner.align (pattern_alignment.cc:117-198).

namespace {

thread_local std::vector<unsigned char> g_winbuf;

// text_at(start, length) over the code array: clamped, decoded, EOS-padded.
inline const unsigned char* make_window(const uint8_t* codes, int64_t n,
                                        const uint8_t* ch_of, uint8_t eos,
                                        int64_t start, int64_t length) {
  if (g_winbuf.size() < (size_t)length) g_winbuf.resize((size_t)length);
  unsigned char* w = g_winbuf.data();
  int64_t s0 = start < 0 ? 0 : start;
  int64_t e0 = s0 + length < n ? s0 + length : n;
  int64_t m = e0 > s0 ? e0 - s0 : 0;
  for (int64_t i = 0; i < m; i++) w[i] = ch_of[codes[s0 + i]];
  for (int64_t i = m; i < length; i++) w[i] = eos;
  return w;
}

// Persistent worker pool for the batched DP entry points.  Workers are
// created ONCE (their thread_local Scratch/window buffers then persist
// and stay warm — spawning fresh std::threads per call re-allocates all
// scratch and measured 4x SLOWER than single-thread); work is claimed
// in fixed grains off an atomic cursor, and the caller participates.
class BatchPool {
 public:
  static BatchPool& inst() {
    // intentionally leaked: a static instance's destructor would tear
    // down mutexes while detached workers wait on them (aborts at exit)
    static BatchPool* p = new BatchPool();
    return *p;
  }

  bool run(int64_t n, bool (*fn)(int64_t, void*), void* ctx) {
    std::unique_lock<std::mutex> lk(caller_);
    cursor_.store(0, std::memory_order_relaxed);
    ok_.store(true, std::memory_order_relaxed);
    n_ = n;
    fn_ = fn;
    ctx_ = ctx;
    done_.store(0, std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> g(m_);
      ++epoch_;
    }
    cv_.notify_all();
    work();  // caller participates
    std::unique_lock<std::mutex> g(m_);
    fin_.wait(g, [&] { return done_.load() == (int)workers_.size(); });
    return ok_.load();
  }

 private:
  BatchPool() {
    int nw = (int)std::thread::hardware_concurrency() - 1;
    // SAT_VERIFY_THREADS caps total participants (tail worker processes
    // set it to 1 so children don't thrash the shared cores)
    if (const char* env = std::getenv("SAT_VERIFY_THREADS")) {
      const int cap = std::atoi(env);
      if (cap >= 1 && cap - 1 < nw) nw = cap - 1;
    }
    if (nw > 3) nw = 3;
    if (nw < 0) nw = 0;
    for (int i = 0; i < nw; ++i)
      workers_.emplace_back([this] { loop(); });
  }

  void loop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> g(m_);
        cv_.wait(g, [&] { return epoch_ != seen; });
        seen = epoch_;
      }
      work();
      {
        std::lock_guard<std::mutex> g(m_);
        ++done_;
      }
      fin_.notify_one();
    }
  }

  void work() {
    const int64_t grain = 64;
    for (;;) {
      const int64_t lo = cursor_.fetch_add(grain, std::memory_order_relaxed);
      if (lo >= n_) return;
      const int64_t hi = lo + grain < n_ ? lo + grain : n_;
      for (int64_t i = lo; i < hi; ++i) {
        if (!ok_.load(std::memory_order_relaxed)) return;
        if (!fn_(i, ctx_)) ok_.store(false, std::memory_order_relaxed);
      }
    }
  }

  std::mutex caller_;  // one batch at a time
  std::mutex m_;
  std::condition_variable cv_, fin_;
  std::vector<std::thread> workers_;
  uint64_t epoch_ = 0;
  std::atomic<int> done_{0};
  std::atomic<int64_t> cursor_{0};
  std::atomic<bool> ok_{true};
  int64_t n_ = 0;
  bool (*fn_)(int64_t, void*) = nullptr;
  void* ctx_ = nullptr;
};

// Run fn(i) over [0, ncand) — threaded through the persistent pool when
// the batch is big enough to amortize the handoff.
template <class F>
bool run_batch(int64_t ncand, F fn) {
  const int64_t kMinPer = 384;
  if (ncand < 2 * kMinPer) {
    for (int64_t i = 0; i < ncand; i++)
      if (!fn(i)) return false;
    return true;
  }
  auto tramp = [](int64_t i, void* ctx) -> bool {
    return (*static_cast<F*>(ctx))(i);
  };
  return BatchPool::inst().run(ncand, tramp, &fn);
}

}  // namespace

extern "C" {

// Batched seed extension (Extender.lmatch/rmatch, yesno path).  Per seed id
// s: expats[ext_off[s] .. +ext_len[s]) is the pattern part to extend,
// dirs[s] > 0 means lmatch (window = [anchor, anchor + ext_len + k), extend
// right) and dirs[s] < 0 means rmatch (textstart = max(anchor - geomA, 0),
// buflen = anchor - geomB - textstart, extend left); la/ra are the residual
// constraint args passed straight to the extension DP.  Per candidate i:
// anchors[i] is the seed-hit end position, sids[i] the seed id.  Outputs:
// ok, hit end (anchor + matchlen for lmatch, anchor for rmatch), value.
int sat_extend_align_batch(
    const uint8_t* codes, int64_t n, const uint8_t* ch_of,
    const uint8_t* expats, const int32_t* ext_off, const int32_t* ext_len,
    const int32_t* dirs, const int32_t* la, const int32_t* ra,
    const int32_t* geomA, const int32_t* geomB,
    const int64_t* anchors, const int32_t* sids, int64_t ncand,
    int32_t k, uint8_t eos, int32_t wc, int32_t textn, int32_t indels,
    int32_t dna_mut, const uint8_t* compat, const int8_t* aasub,
    int32_t* ok_out, int64_t* end_out, int32_t* val_out) {
  return run_batch(ncand, [&](int64_t i) {
    const int32_t s = sids[i];
    const int64_t anchor = anchors[i];
    int64_t start, buflen;
    if (dirs[s] > 0) {
      start = anchor;
      buflen = (int64_t)ext_len[s] + k;
    } else {
      start = anchor > geomA[s] ? anchor - geomA[s] : 0;
      buflen = anchor - geomB[s] - start;
      if (buflen < 0) buflen = 0;
    }
    // Banded PREFIX pre-gate straight off the text (no window copy, no
    // general-DP setup): a full <= k-edit extension implies its prefix
    // aligns within k under a cost model that never overcharges (sub/
    // indel cost 1 <= the true arm, constraint/eos penalties ignored —
    // both only WEAKEN the gate), so a prefix minimum > k soundly
    // rejects.  At pigeonhole candidate rates (~10^5 random half-hits
    // per scan, xmers.cc:821 phase-2 geometry) this kills ~90% of the
    // batch before the full-DP path.
    const int32_t band0 = indels ? (dna_mut ? 1 : k) : 0;
    const int32_t G0 = ext_len[s] < k + 4 ? ext_len[s] : k + 4;
    if (!wc && !textn && !dna_mut && G0 >= 1 && k >= 1 && k <= 8 &&
        buflen >= G0 + band0) {
      const unsigned char* pp = expats + ext_off[s];
      const int32_t plen = ext_len[s];
      int64_t row[2 * 8 + 1];  // diagonals d = t - p in [-band, band]
      const int32_t band = band0;
      for (int32_t d = 0; d <= 2 * band; ++d)
        row[d] = d >= band ? d - band : band - d;  // row-0 indel ramp
      bool dead = true;
      for (int32_t p = 1; p <= G0; ++p) {
        const unsigned char pc =
            dirs[s] > 0 ? pp[p - 1] : pp[plen - p];
        int64_t prev_d = 1 << 20, rowmin = 1 << 20;
        for (int32_t d = 0; d <= 2 * band; ++d) {
          const int64_t t = (int64_t)p + d - band;
          int64_t v = 1 << 20;
          if (t >= 1 && t <= buflen) {
            const int64_t pos = dirs[s] > 0
                ? start + t - 1
                : anchor - geomB[s] - t;
            const unsigned char tc =
                (pos >= 0 && pos < n) ? ch_of[codes[pos]] : eos;
            v = row[d] + (tc == pc ? 0 : 1);
            if (d + 1 <= 2 * band && row[d + 1] + 1 < v)
              v = row[d + 1] + 1;  // text gap
            if (prev_d + 1 < v) v = prev_d + 1;  // pattern gap
          } else if (t == 0 && d + 1 <= 2 * band) {
            v = row[d + 1] + 1;
          }
          prev_d = v;
          row[d] = v;
          if (v < rowmin) rowmin = v;
        }
        if (rowmin > k) { dead = true; break; }
        dead = false;
      }
      if (dead) {
        ok_out[i] = 0;
        end_out[i] = anchor;
        val_out[i] = 0;
        return true;
      }
    }
    const unsigned char* w =
        make_window(codes, n, ch_of, eos, start, buflen);
    int32_t ok = 0, matchlen = 0, value = 0;
    const int r = sat_extend_align(
        w, (int32_t)buflen, expats + ext_off[s], ext_len[s], dirs[s],
        la[s], ra[s], k, eos, wc, textn, indels, dna_mut, compat, aasub,
        &ok, &matchlen, &value);
    if (r != 1) return false;
    ok_out[i] = ok;
    end_out[i] = dirs[s] > 0 ? anchor + matchlen : anchor;
    val_out[i] = value;
    return true;
  }) ? 1 : 0;
}

// Batched yes/no verify (EditDistAligner.align semantics: right-anchored
// window [textstart, posub) with free trailing columns posub - poslb).  Per
// candidate: sids[i] picks the pattern (+ its esb/eeb), poslb/posub the end
// range.  Outputs: found, alignment start/end (start = posub - beststart,
// end = start + (beststart - endt)), value.
int sat_verify_align_batch(
    const uint8_t* codes, int64_t n, const uint8_t* ch_of,
    const uint8_t* pats, const int32_t* pat_off, const int32_t* pat_len,
    const int32_t* esb, const int32_t* eeb,
    const int64_t* poslb, const int64_t* posub, const int32_t* sids,
    int64_t ncand,
    int32_t k, uint8_t eos, int32_t wc, int32_t textn, int32_t indels,
    int32_t dna_mut, const uint8_t* compat, const int8_t* aasub,
    int32_t* found_out, int64_t* start_out, int64_t* end_out,
    int32_t* val_out) {
  return run_batch(ncand, [&](int64_t i) {
    const int32_t s = sids[i];
    const int64_t end = poslb[i];
    const int32_t patlen = pat_len[s];
    const int64_t textstart =
        end > (int64_t)patlen + k ? end - patlen - k : 0;
    const int64_t buflen = posub[i] - textstart;
    const unsigned char* w =
        make_window(codes, n, ch_of, eos, textstart, buflen);
    int32_t found = 0, bestval = 0, beststart = 0, endt = 0, ncodes = 0;
    int64_t stats[N_CODES];
    const int r = sat_verify_align(
        pats + pat_off[s], patlen, w, (int32_t)buflen, nullptr, k, eos,
        wc, textn, indels, dna_mut, /*trans=*/0, /*yesno=*/1,
        esb[s], eeb[s], posub[i] - end, compat, aasub, nullptr,
        &found, &bestval, &beststart, &endt,
        nullptr, 0, &ncodes, stats);
    if (r != 1) return false;
    if (beststart < 0) {  // early exit / out-of-band: not found
      found_out[i] = 0;
      start_out[i] = end;
      end_out[i] = end;
      val_out[i] = 0;
      return true;
    }
    found_out[i] = found;
    start_out[i] = posub[i] - beststart;
    end_out[i] = start_out[i] + (beststart - endt);
    val_out[i] = bestval;
    return true;
  }) ? 1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// std::sort on (key, payload) int64 pairs with a KEY-ONLY comparator — the
// reference normalizes candidate batches with std::sort over
// pattern_hit_vector elements comparing keys only (sortedvector.t normalize,
// used by filter_bitvec.cc:142); libstdc++'s introsort permutation depends
// only on the comparator outcomes, so sorting (key, original_payload) pairs
// here reproduces the reference's exact tie order.

#include <algorithm>
#include <utility>

extern "C" {

void sat_sort_pairs(int64_t* keys, int64_t* vals, int64_t n) {
  thread_local std::vector<std::pair<int64_t, int64_t>> buf;
  buf.resize((size_t)n);
  for (int64_t i = 0; i < n; i++) buf[i] = {keys[i], vals[i]};
  std::sort(buf.begin(), buf.end(),
            [](const std::pair<int64_t, int64_t>& a,
               const std::pair<int64_t, int64_t>& b) {
              return a.first < b.first;
            });
  for (int64_t i = 0; i < n; i++) {
    keys[i] = buf[i].first;
    vals[i] = buf[i].second;
  }
}

}  // extern "C"
