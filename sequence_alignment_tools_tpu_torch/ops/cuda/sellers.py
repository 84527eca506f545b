"""The Sellers k-edit scan of the filter engine.

Counterpart of ``sequence_alignment_tools_tpu/ops/sellers.py``'s
``_sellers_kernel`` + ``pallas_sellers_scan`` (and of the host rescan
``rescan_boundaries`` that served the TPU kernel's escapes), held to the
triples it implies:

    {(pos, p, d) : d = mindist(pos, p) <= k}

with ``mindist`` the distance that the XLA ``_sellers_block`` computes:
the semi-global edit distance of pattern p against some text substring
ending at position pos (the filter engine's boundary is ``pos + 1``),
capped at k + 1, with no error move on an EOS character and an insertion
chain of t characters only over t non-EOS characters.  Without indels
only substitutions count.

:func:`sellers_scan` launches ``csrc/sellers.cu`` (a block bit-parallel
scan: Myers' word recurrence with indels, bit-sliced mismatch counters
without) on a CUDA tensor and runs :func:`sellers_ref`, the row DP of
``_sellers_block`` in plain PyTorch, on a CPU tensor.  It serves the
pattern sets the Myers kernel does not take: a pattern longer than 31,
more words than the Myers kernel keeps in registers, a pattern of length
<= k, or no indels.  It takes any number of patterns (one launch per
block of :data:`PATTERN_BLOCK`, on the CPU one plain call per block) and
k up to :data:`MAX_K`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

# the kernel's counters without indels hold k + 1 in at most 16 bit planes
MAX_K = 65534
# the most patterns one launch takes (a grid row per pattern, gridDim.y);
# larger sets take one launch per block, the plain version one call
PATTERN_BLOCK = 65535
# the most device scratch one launch takes for the words of long patterns;
# past it the segments grow (fewer threads)
_SCRATCH_MAX = 1 << 30


@dataclass(frozen=True)
class SellersTables:
    """The Sellers operands of one pattern set on one device.

    ``acc``: [P, Lmax, aw] int32; bit ``c & 31`` of word ``c >> 5`` is set
    when position j of pattern p accepts text code c.  ``lens``: [P]
    int32.  ``alpha``: the text alphabet size.  ``peq``: the kernel's
    accept words, [P, ceil(Lmax / 32), alpha + 1] int32 (bit i of word b
    at code c set when position 32 b + i of pattern p accepts c; column
    ``alpha`` stands for every code past the alphabet and is zero), built
    from ``acc`` on the host when not given."""

    acc: torch.Tensor
    lens: torch.Tensor
    alpha: int
    peq: torch.Tensor | None = None

    def __post_init__(self):
        if self.peq is None:
            object.__setattr__(self, "peq", torch.from_numpy(peq_words(
                self.acc.cpu().numpy(), self.lens.cpu().numpy(),
                self.alpha)).to(self.acc.device))

    @property
    def P(self) -> int:
        return self.acc.shape[0]

    @property
    def Lmax(self) -> int:
        return self.acc.shape[1]

    @property
    def aw(self) -> int:
        return self.acc.shape[2]

    def to(self, device) -> SellersTables:
        return SellersTables(self.acc.to(device), self.lens.to(device),
                             self.alpha, self.peq.to(device))

    def blocks(self):
        """[(first pattern id, tables)] of consecutive blocks of at most
        :data:`PATTERN_BLOCK` patterns (views of these tables)."""
        if self.P <= PATTERN_BLOCK:
            return [(0, self)]
        return [(lo, SellersTables(self.acc[lo : lo + PATTERN_BLOCK],
                                   self.lens[lo : lo + PATTERN_BLOCK],
                                   self.alpha,
                                   self.peq[lo : lo + PATTERN_BLOCK]))
                for lo in range(0, self.P, PATTERN_BLOCK)]


def peq_words(acc: np.ndarray, lens: np.ndarray, alpha: int) -> np.ndarray:
    """The block bit-parallel kernel's accept words of ``acc`` [P, Lmax,
    aw] (see :class:`SellersTables`): [P, ceil(Lmax / 32), alpha + 1]
    int32, rows past each pattern's length zero."""
    acc = np.asarray(acc).view(np.uint32)
    P, Lmax, _aw = acc.shape
    W = -(-Lmax // 32)
    live = np.arange(W * 32)[None, :] < np.asarray(lens)[:, None]  # [P, 32W]
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    peq = np.zeros((P, W, alpha + 1), np.uint64)
    for c in range(alpha):
        bits = np.zeros((P, W * 32), np.uint64)
        bits[:, :Lmax] = (acc[:, :, c >> 5] >> np.uint32(c & 31)) & 1
        bits[~live] = 0
        peq[:, :, c] = (bits.reshape(P, W, 32) * weights).sum(axis=2)
    return peq.astype(np.uint32).view(np.int32)


def sellers_tables(tables) -> SellersTables:
    """:class:`SellersTables` (on the CPU) of a ``PatternTables``."""
    P, Lmax, alpha = tables.match.shape
    aw = -(-alpha // 32)
    acc = np.zeros((P, Lmax, aw), np.uint32)
    for c in range(alpha):
        acc[:, :, c >> 5] |= tables.match[:, :, c].astype(np.uint32) \
            << np.uint32(c & 31)
    return SellersTables(torch.from_numpy(acc.view(np.int32)),
                         torch.from_numpy(
                             np.asarray(tables.lengths, np.int32).copy()),
                         alpha)


def _sellers_rows(c: torch.Tensor, st: SellersTables, eos: int, k: int,
                  indels: bool) -> torch.Tensor:
    """D [P, W] int32: the capped Sellers distances of every pattern at
    every column of the window ``c`` [W] (the row DP of the XLA
    ``_sellers_block``; the column before the window counts as EOS)."""
    dev = c.device
    P, Lmax, aw = st.acc.shape
    W = c.numel()
    INF = k + 1
    iota = torch.arange(W, device=dev)
    at_eos = c == eos
    last_eos = torch.cummax(torch.where(at_eos, iota, -1), 0).values
    nrun = iota - last_eos
    allowed = [nrun >= t for t in range(k + 1)]
    live = c < st.alpha
    cw = torch.where(live, c >> 5, 0)
    cb = (c & 31).to(torch.int32)
    acc = st.acc.to(dev)
    lens = st.lens.to(dev).long()
    inf_col = torch.full((P, 1), INF, dtype=torch.int32, device=dev)
    D = torch.zeros((P, W), dtype=torch.int32, device=dev)
    for j in range(Lmax):
        ok = ((acc[:, j, :][:, cw] >> cb) & 1).bool() & live  # [P, W]
        sub = (~ok).to(torch.int32)
        diag = torch.cat([inf_col, D[:, :-1]], dim=1)
        base = torch.where(at_eos, INF, diag + sub)
        if indels:
            base = torch.minimum(base, torch.where(at_eos, INF, D + 1))
        base = torch.clamp(base, max=INF)
        out = base
        if indels:
            for t in range(1, k + 1):
                sh = torch.cat([inf_col.expand(P, t), base[:, :-t]], dim=1)
                out = torch.minimum(
                    out, torch.where(allowed[t], sh + t, INF))
        out = torch.clamp(out, max=INF)
        D = torch.where((j < lens)[:, None], out, D)
    return D


def sellers_ref(codes: torch.Tensor, n: int, st: SellersTables, eos: int,
                k: int, indels: bool, cap: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`sellers_scan`.

    The row ``[count, pos (cap), pid (cap), dist (cap)]`` int32 holds every
    triple of the Sellers contract over ``codes[:n]``; ``count`` is the
    true number, of which the first ``cap`` are kept.  The row DP runs
    over chunks of the text, each with a left halo of Lmax + k characters
    (text outside [0, n) reads as EOS), which makes every value <= k at
    the chunk's own positions exact."""
    dev = codes.device
    P, Lmax = st.P, st.Lmax
    halo = Lmax + k
    chunk = max((1 << 22) // max(P, 1), 4 * halo, 1024)
    found = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        lo = s - halo
        c = torch.full((e - lo,), eos, dtype=torch.long, device=dev)
        c0 = max(lo, 0)
        c[c0 - lo :] = codes[c0:e].long()
        D = _sellers_rows(c, st, eos, k, indels)[:, halo:]
        pi, ci = torch.nonzero(D <= k, as_tuple=True)
        found.append((ci + s, pi, D[pi, ci]))
    if found:
        pos, pid, dist = (torch.cat(x) for x in zip(*found))
    else:
        pos = pid = dist = torch.zeros(0, dtype=torch.long, device=dev)
    count = pos.numel()
    keep = min(count, cap)
    row = torch.zeros(1 + 3 * cap, dtype=torch.int32, device=dev)
    row[0] = count
    row[1 : 1 + keep] = pos[:keep].to(torch.int32)
    row[1 + cap : 1 + cap + keep] = pid[:keep].to(torch.int32)
    row[1 + 2 * cap : 1 + 2 * cap + keep] = dist[:keep].to(torch.int32)
    return row


def kernel_takes(st: SellersTables, k: int) -> bool:
    """Whether ``csrc/sellers.cu`` takes this pattern set and k: k <=
    ``MAX_K``, at least one pattern, each of at least one position, and
    alphabets of at most 256 codes.  Any number of patterns (a launch per
    block of ``PATTERN_BLOCK``) and any Lmax (the words past the first
    live in device scratch)."""
    return (0 <= k <= MAX_K and st.P >= 1 and st.alpha <= 256
            and bool((st.lens >= 1).all()))


def _merged(rows, cap: int) -> torch.Tensor:
    """One ``[count, pos (cap), pid (cap), dist (cap)]`` row of the rows
    of consecutive pattern blocks [(first pattern id, row)]: the counts
    summed, the kept triples concatenated (pattern ids rebased) and the
    first ``cap`` of them kept."""
    if len(rows) == 1:
        return rows[0][1]
    parts = []
    for lo, row in rows:
        m = min(int(row[0]), cap)
        parts.append((row[1 : 1 + m], row[1 + cap : 1 + cap + m] + lo,
                      row[1 + 2 * cap : 1 + 2 * cap + m]))
    pos, pid, dist = (torch.cat(x) for x in zip(*parts))
    keep = min(pos.numel(), cap)
    out = torch.zeros_like(rows[0][1])
    out[0] = sum(int(row[0]) for _lo, row in rows)
    out[1 : 1 + keep] = pos[:keep]
    out[1 + cap : 1 + cap + keep] = pid[:keep]
    out[1 + 2 * cap : 1 + 2 * cap + keep] = dist[:keep]
    return out


def sellers_scan(codes: torch.Tensor, n: int, st: SellersTables, eos: int,
                 k: int, indels: bool, cap: int,
                 segc: int | None = None) -> torch.Tensor:
    """Candidate triples of the Sellers scan of ``codes[:n]`` (see
    :func:`sellers_ref`): the int32 row ``[count, pos (cap), pid (cap),
    dist (cap)]``, triples in no order.

    ``codes`` uint8 [>= n]; ``st`` a :class:`SellersTables` on the same
    device; ``segc`` the text positions per thread (rounded up to 32;
    None: the kernel sizes the segments to fill whole waves of the card).
    On a CUDA tensor this launches ``csrc/sellers.cu`` on the current
    stream, once per block of :data:`PATTERN_BLOCK` patterns, every
    launch into one row and with one device scratch buffer for the words
    past each pattern's first (sized for a block, at most
    ``_SCRATCH_MAX`` bytes when the segments can grow), and counts each
    launch in ``sellers_scan.launches``; on a CPU tensor it is
    :func:`sellers_ref` per block, the rows merged.  Nothing here waits
    for the device."""
    if codes.device.type == "cpu":
        return _merged([(lo, sellers_ref(codes, n, b, eos, k, indels, cap))
                        for lo, b in st.blocks()], cap)
    if codes.device.type != "cuda":
        raise ValueError(f"sellers_scan: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 1 \
            or not codes.is_contiguous() or codes.numel() < n:
        raise ValueError(f"sellers_scan: codes must be contiguous uint8 "
                         f"[>= n], got {codes.dtype} {tuple(codes.shape)}, "
                         f"n {n}")
    for name, t in (("peq", st.peq), ("lens", st.lens)):
        if t.device != codes.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"sellers_scan: {name} must be contiguous "
                             "int32 on the codes' device")
    if not kernel_takes(st, k) or not 0 <= eos < 256 or cap < 1 \
            or n + st.Lmax + k >= 1 << 31:
        raise ValueError(f"sellers_scan: the kernel does not take P "
                         f"{st.P}, Lmax {st.Lmax}, k {k}, eos {eos}, cap "
                         f"{cap}, n {n}")
    from . import build

    lib = build.library("sellers")
    plan = (ctypes.c_int64 * 3)()
    blocks = st.blocks()
    with torch.cuda.device(codes.device):
        rc = lib.sat_sellers_plan(n, blocks[0][1].P, st.Lmax, st.alpha, k,
                                  int(indels), segc or 0, _SCRATCH_MAX, plan)
        if rc != 0:
            raise RuntimeError(f"sellers_scan plan failed: cudaError_t {rc}")
        segc, halo, nscratch = plan
        scratch = torch.empty(nscratch, dtype=torch.uint8,
                              device=codes.device)
        out = torch.zeros(1 + 3 * cap, dtype=torch.int32, device=codes.device)
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        for lo, b in blocks:
            rc = lib.sat_sellers_scan(
                codes.data_ptr(), n, b.peq.data_ptr(), b.lens.data_ptr(),
                b.P, lo, st.Lmax, st.alpha, eos, k, int(indels), segc, halo,
                out.data_ptr(), cap, scratch.data_ptr() if nscratch else None,
                nscratch, stream)
            if rc != 0:
                raise RuntimeError(
                    f"sellers_scan launch failed: cudaError_t {rc}")
            sellers_scan.launches += 1
    return out


sellers_scan.launches = 0
