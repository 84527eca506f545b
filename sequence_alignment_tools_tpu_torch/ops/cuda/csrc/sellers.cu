// Sellers k-edit scan of the filter engine, for sm_90a.
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
// The column form of the row DP: per text character c, with C the column
// of pattern prefixes (C[0] = 0, the free start):
//   C'[j] = min(C[j-1] + (p[j] accepts c ? 0 : 1),   diagonal
//               C'[j-1] + 1,                         pattern char deleted
//               C[j] + 1)                            text char inserted
// capped at k + 1; an EOS character resets C to (0, k + 1, k + 1, ...).
// Without indels only the diagonal term remains.
//
// What bounds it on an H100: integer instructions per DP cell.  The
// design:
//   - one thread per (text segment, pattern): blockIdx.y is the pattern,
//     so a block's threads share its accept words in shared memory;
//   - each thread first walks a warm-up halo of Lmax + k characters from
//     a fresh column: a <= k-edit alignment spans at most Lmax + k
//     characters, so every value <= k is exact after it;
//   - the column is one byte per cell in shared memory, laid out
//     [cell][thread] so a warp's accesses to one cell fall in 8 words;
//   - Ukkonen's cutoff: only cells up to the last one <= k, plus the
//     run of cells a deletion chain can still bring to <= k, are
//     updated; every other cell holds k + 1.  On random text that is
//     about k + 2 cells per character instead of the pattern length.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemMax = 232448;  // sm_90 per-block opt-in maximum

__global__ void __launch_bounds__(kThreads)
sellers_kernel(const uint8_t* __restrict__ codes, int64_t n,
               const uint32_t* __restrict__ acc,
               const int32_t* __restrict__ lens, int Lmax, int aw,
               int alpha, int eos, int k, int indels, int segc, int halo,
               int64_t nseg, int32_t* __restrict__ out, int64_t cap) {
  // shared layout: [accept words of this pattern, Lmax x aw][column cells
  // 1 .. Lmax, one byte per thread]
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* acc_s = reinterpret_cast<uint32_t*>(smem);
  uint8_t* col = smem + static_cast<size_t>(Lmax) * aw * 4;
  const int p = blockIdx.y;
  const uint32_t* acc_p = acc + static_cast<int64_t>(p) * Lmax * aw;
  for (int i = threadIdx.x; i < Lmax * aw; i += blockDim.x) {
    acc_s[i] = acc_p[i];
  }
  __syncthreads();

  const int64_t seg = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (seg >= nseg) return;  // no block-wide sync below
  const int m = __ldg(lens + p);
  const int INF = k + 1;
  uint8_t* mycol = col + threadIdx.x;  // cell j at mycol[(j - 1) * kThreads]
  for (int j = 1; j <= m; ++j) mycol[(j - 1) * kThreads] = INF;
  int lact = 0;  // the last cell <= k; every cell past it holds INF

  const int64_t own0 = seg * segc;
  int64_t pos = own0 - halo;
  if (pos < 0) pos = 0;  // text before 0 reads as EOS: a fresh column
  const int64_t stop = own0 + segc < n ? own0 + segc : n;
  for (; pos < stop; ++pos) {
    const int c = __ldg(codes + pos);
    if (c == eos) {
      for (int j = 1; j <= lact; ++j) mycol[(j - 1) * kThreads] = INF;
      lact = 0;
      continue;
    }
    const bool in_alpha = c < alpha;
    const int cw = in_alpha ? c >> 5 : 0;
    const int cb = c & 31;
    int diag = 0;  // C[j - 1] of the previous column
    int up = 0;    // C'[j - 1] of this column
    int last = 0;
    for (int j = 1; j <= m; ++j) {
      // past lact + 1 the diagonal and insertion terms are INF: only a
      // deletion chain from C'[j - 1] can still reach <= k
      if (j > lact + 1 && (!indels || up >= k)) break;
      uint8_t* cell = mycol + (j - 1) * kThreads;
      const int o = *cell;
      const bool hit = in_alpha && ((acc_s[(j - 1) * aw + cw] >> cb) & 1u);
      int v = diag + (hit ? 0 : 1);
      if (indels) v = min(v, min(up, o) + 1);
      v = min(v, INF);
      *cell = static_cast<uint8_t>(v);
      diag = o;
      up = v;
      if (v <= k) last = j;
    }
    lact = last;
    if (lact == m && pos >= own0) {
      const int slot = atomicAdd(out, 1);
      if (slot < cap) {
        out[1 + slot] = static_cast<int32_t>(pos);
        out[1 + cap + slot] = p;
        out[1 + 2 * cap + slot] = up;
      }
    }
  }
}

}  // namespace

// Candidate triples of the Sellers scan into out[0 .. 1 + 3 cap): out[0]
// the true count (the caller zeroes it first), then the 0-based end
// positions, the pattern ids and the distances.  codes [>= n] uint8,
// acc [P, Lmax, aw] uint32 (bit c & 31 of word c >> 5: position j of
// pattern p accepts code c) and lens [P] int32 (each in [1, Lmax]) on the
// device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_sellers_scan(const void* codes, int64_t n, const void* acc,
                                const void* lens, int P, int Lmax, int aw,
                                int alpha, int eos, int k, int indels,
                                int segc, int halo, void* out, int64_t cap,
                                void* stream) {
  if (n < 1) return 0;
  if (P < 1 || P > 65535 || Lmax < 1 || aw < 1 || alpha < 1 ||
      alpha > 32 * aw || eos < 0 || k < 0 || k > 254 || segc < 1 ||
      halo < 0 || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(Lmax) * aw * 4 +
                      static_cast<size_t>(Lmax) * kThreads;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sellers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t nseg = (n + segc - 1) / segc;
  const dim3 grid(static_cast<unsigned>((nseg + kThreads - 1) / kThreads),
                  static_cast<unsigned>(P));
  sellers_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n,
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(lens),
      Lmax, aw, alpha, eos, k, indels, segc, halo, nseg,
      static_cast<int32_t*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
