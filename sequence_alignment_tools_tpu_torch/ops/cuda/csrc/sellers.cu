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
//     the threads per block follow Lmax: 128 while their columns and the
//     pattern's accept words fit (Lmax up to about 1,760 for DNA), then
//     64 and 32 (about 7,000).  Past that the column is tiled: its first
//     kTopCells cells stay in shared memory and the rest lives in a
//     device scratch buffer that the wrapper allocates (laid out
//     [cell][thread of the launch]); the accept words stay in shared
//     memory while they fit and are read from device memory past that.
//     Ukkonen's cutoff (below) keeps the live cells near the top of the
//     column, so the scratch part is touched only where a long stretch
//     of the pattern aligns with the text (each such stretch costs about
//     Lmax cells per character, as in shared memory);
//   - Ukkonen's cutoff: only cells up to the last one <= k, plus the
//     run of cells a deletion chain can still bring to <= k, are
//     updated; every other cell holds k + 1.  On random text that is
//     about k + 2 cells per character instead of the pattern length.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemMax = 232448;  // sm_90 per-block opt-in maximum
// cells of a tiled column kept in shared memory (32 KB a block)
constexpr int kTopCells = 256;

// The whole columns in shared memory: kT threads a block (128, or 64 and
// 32 for patterns whose 128 columns do not fit), cell j of a thread at
// col[(j - 1) * kT + threadIdx.x].
template <int kT>
__global__ void __launch_bounds__(kT)
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
  uint8_t* mycol = col + threadIdx.x;  // cell j at mycol[(j - 1) * kT]
  for (int j = 1; j <= m; ++j) mycol[(j - 1) * kT] = INF;
  int lact = 0;  // the last cell <= k; every cell past it holds INF

  const int64_t own0 = seg * segc;
  int64_t pos = own0 - halo;
  if (pos < 0) pos = 0;  // text before 0 reads as EOS: a fresh column
  const int64_t stop = own0 + segc < n ? own0 + segc : n;
  for (; pos < stop; ++pos) {
    const int c = __ldg(codes + pos);
    if (c == eos) {
      for (int j = 1; j <= lact; ++j) mycol[(j - 1) * kT] = INF;
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
      uint8_t* cell = mycol + (j - 1) * kT;
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

// A column past even 32 threads' shared memory: cells 1 .. kTopCells of
// each thread in shared memory as in sellers_kernel, cells past them in
// `scratch`, each thread's far cells contiguous (fstride bytes, 16-byte
// chunks moved as one uint4 through registers, so that a stretch of the
// pattern aligned with the text costs one load and one store per 16
// cells); the accept words in shared memory when acc_shared, else read
// from device memory.  The same DP as sellers_kernel, kept apart so that
// its shared-memory path compiles as it did.
__global__ void __launch_bounds__(kThreads)
sellers_tiled_kernel(const uint8_t* __restrict__ codes, int64_t n,
                     const uint32_t* __restrict__ acc,
                     const int32_t* __restrict__ lens, int Lmax, int aw,
                     int alpha, int eos, int k, int indels, int segc,
                     int halo, int64_t nseg, int32_t* __restrict__ out,
                     int64_t cap, uint4* __restrict__ scratch, int fstride,
                     int acc_shared) {
  // shared layout: [accept words, Lmax x aw (acc_shared)][top cells]
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* acc_s = reinterpret_cast<uint32_t*>(smem);
  const int p = blockIdx.y;
  const uint32_t* acc_p = acc + static_cast<int64_t>(p) * Lmax * aw;
  if (acc_shared) {
    for (int i = threadIdx.x; i < Lmax * aw; i += blockDim.x) {
      acc_s[i] = acc_p[i];
    }
    __syncthreads();
  }
  const uint32_t* accw = acc_shared ? acc_s : acc_p;

  const int64_t seg = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (seg >= nseg) return;  // no block-wide sync below
  const int m = __ldg(lens + p);
  const int INF = k + 1;
  const uint32_t inf4 = static_cast<uint32_t>(INF) * 0x01010101u;
  const int mt = m < kTopCells ? m : kTopCells;
  uint8_t* top =
      smem + (acc_shared ? static_cast<size_t>(Lmax) * aw * 4 : 0) +
      threadIdx.x;
  uint4* far = scratch + ((static_cast<int64_t>(p) * gridDim.x +
                           blockIdx.x) * kThreads + threadIdx.x) *
                             (fstride / 16);
  const int nfar = (m - mt + 15) / 16;  // 16-cell chunks past the top
  const uint4 inf_chunk = make_uint4(inf4, inf4, inf4, inf4);
  for (int j = 1; j <= mt; ++j) top[(j - 1) * kThreads] = INF;
  for (int q = 0; q < nfar; ++q) far[q] = inf_chunk;
  int lact = 0;

  const int64_t own0 = seg * segc;
  int64_t pos = own0 - halo;
  if (pos < 0) pos = 0;
  const int64_t stop = own0 + segc < n ? own0 + segc : n;
  for (; pos < stop; ++pos) {
    const int c = __ldg(codes + pos);
    if (c == eos) {
      for (int j = 1; j <= lact && j <= mt; ++j) top[(j - 1) * kThreads] = INF;
      for (int q = 0; kTopCells + 16 * q < lact; ++q) far[q] = inf_chunk;
      lact = 0;
      continue;
    }
    const bool in_alpha = c < alpha;
    const int cw = in_alpha ? c >> 5 : 0;
    const int cb = c & 31;
    int diag = 0;
    int up = 0;
    int last = 0;
    bool more = true;  // the walk did not stop inside the top cells
    for (int j = 1; j <= mt; ++j) {
      if (j > lact + 1 && (!indels || up >= k)) {
        more = false;
        break;
      }
      uint8_t* cell = top + (j - 1) * kThreads;
      const int o = *cell;
      const bool hit = in_alpha && ((accw[(j - 1) * aw + cw] >> cb) & 1u);
      int v = diag + (hit ? 0 : 1);
      if (indels) v = min(v, min(up, o) + 1);
      v = min(v, INF);
      *cell = static_cast<uint8_t>(v);
      diag = o;
      up = v;
      if (v <= k) last = j;
    }
    for (int q = 0; more && q < nfar; ++q) {
      const int j0 = kTopCells + 16 * q;  // cells j0 + 1 .. j0 + 16
      if (j0 + 1 > lact + 1 && (!indels || up >= k)) break;
      const uint4 ch = far[q];
      uint32_t wd[4] = {ch.x, ch.y, ch.z, ch.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = j0 + i + 1;
        if (more) {
          if (j > m || (j > lact + 1 && (!indels || up >= k))) {
            more = false;
          } else {
            const int sh = 8 * (i & 3);
            const int o = (wd[i >> 2] >> sh) & 255;
            const bool hit =
                in_alpha && ((accw[(j - 1) * aw + cw] >> cb) & 1u);
            int v = diag + (hit ? 0 : 1);
            if (indels) v = min(v, min(up, o) + 1);
            v = min(v, INF);
            wd[i >> 2] = (wd[i >> 2] & ~(255u << sh)) |
                         (static_cast<uint32_t>(v) << sh);
            diag = o;
            up = v;
            if (v <= k) last = j;
          }
        }
      }
      far[q] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
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

// The threads per block whose columns fit shared memory beside the accept
// words (128, 64 or 32), or 0 when even 32 do not.
int shared_threads(int Lmax, int aw) {
  const int64_t acc_bytes = static_cast<int64_t>(Lmax) * aw * 4;
  for (int t = kThreads; t >= 32; t /= 2) {
    if (acc_bytes + static_cast<int64_t>(Lmax) * t <= kSmemMax) return t;
  }
  return 0;
}

// Scratch bytes of one thread's far cells: Lmax - kTopCells, in whole
// 16-byte chunks.
int far_stride(int Lmax) { return (Lmax - kTopCells + 15) / 16 * 16; }

template <typename Kernel>
cudaError_t smem_attr(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Bytes of device scratch the launch needs for its columns: 0 when 32
// or more threads' columns fit shared memory, else far_stride(Lmax) per
// thread of the launch (P rows of ceil(nseg / 128) blocks of 128).
extern "C" int64_t sat_sellers_scratch(int64_t n, int P, int Lmax, int aw,
                                       int segc) {
  if (n < 1 || segc < 1 || P < 1 || Lmax < 1 || aw < 1) return 0;
  if (shared_threads(Lmax, aw) > 0) return 0;
  const int64_t nseg = (n + segc - 1) / segc;
  const int64_t blocks = (nseg + kThreads - 1) / kThreads;
  return static_cast<int64_t>(far_stride(Lmax)) * P * blocks * kThreads;
}

// Candidate triples of the Sellers scan into out[0 .. 1 + 3 cap): out[0]
// the true count (the caller zeroes it first), then the 0-based end
// positions, the pattern ids and the distances.  codes [>= n] uint8,
// acc [P, Lmax, aw] uint32 (bit c & 31 of word c >> 5: position j of
// pattern p accepts code c) and lens [P] int32 (each in [1, Lmax]) on the
// device; scratch holds sat_sellers_scratch(...) bytes (null when that is
// 0).  Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_sellers_scan(const void* codes, int64_t n, const void* acc,
                                const void* lens, int P, int Lmax, int aw,
                                int alpha, int eos, int k, int indels,
                                int segc, int halo, void* out, int64_t cap,
                                void* scratch, int64_t scratch_bytes,
                                void* stream) {
  if (n < 1) return 0;
  if (P < 1 || P > 65535 || Lmax < 1 || aw < 1 || alpha < 1 ||
      alpha > 32 * aw || eos < 0 || k < 0 || k > 254 || segc < 1 ||
      halo < 0 || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t need = sat_sellers_scratch(n, P, Lmax, aw, segc);
  if (need > 0 && (scratch == nullptr || scratch_bytes < need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nseg = (n + segc - 1) / segc;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const uint8_t*>(codes);
  const auto a = static_cast<const uint32_t*>(acc);
  const auto l = static_cast<const int32_t*>(lens);
  const auto o = static_cast<int32_t*>(out);
  const size_t acc_bytes = static_cast<size_t>(Lmax) * aw * 4;
  const int t = shared_threads(Lmax, aw);
  const int bt = t > 0 ? t : kThreads;
  const dim3 grid(static_cast<unsigned>((nseg + bt - 1) / bt),
                  static_cast<unsigned>(P));
  const size_t smem = acc_bytes + static_cast<size_t>(Lmax) * bt;
  cudaError_t err = cudaSuccess;
  if (t == kThreads) {
    err = smem_attr(sellers_kernel<kThreads>, smem);
    if (err == cudaSuccess) {
      sellers_kernel<kThreads><<<grid, kThreads, smem, s>>>(
          c, n, a, l, Lmax, aw, alpha, eos, k, indels, segc, halo, nseg, o,
          cap);
    }
  } else if (t == 64) {
    err = smem_attr(sellers_kernel<64>, smem);
    if (err == cudaSuccess) {
      sellers_kernel<64><<<grid, 64, smem, s>>>(c, n, a, l, Lmax, aw, alpha,
                                                eos, k, indels, segc, halo,
                                                nseg, o, cap);
    }
  } else if (t == 32) {
    err = smem_attr(sellers_kernel<32>, smem);
    if (err == cudaSuccess) {
      sellers_kernel<32><<<grid, 32, smem, s>>>(c, n, a, l, Lmax, aw, alpha,
                                                eos, k, indels, segc, halo,
                                                nseg, o, cap);
    }
  } else {
    const size_t top = static_cast<size_t>(kTopCells) * kThreads;
    const bool acc_shared = acc_bytes + top <= kSmemMax;
    const size_t tsmem = (acc_shared ? acc_bytes : 0) + top;
    err = smem_attr(sellers_tiled_kernel, tsmem);
    if (err == cudaSuccess) {
      sellers_tiled_kernel<<<grid, kThreads, tsmem, s>>>(
          c, n, a, l, Lmax, aw, alpha, eos, k, indels, segc, halo, nseg, o,
          cap, static_cast<uint4*>(scratch), far_stride(Lmax),
          acc_shared ? 1 : 0);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
