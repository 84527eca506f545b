"""The Sellers row-DP k-edit scan of the filter engine.

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

:func:`sellers_scan` launches ``csrc/sellers.cu`` on a CUDA tensor and
runs :func:`sellers_ref`, the row DP of ``_sellers_block`` in plain
PyTorch, on a CPU tensor.  It serves the pattern sets the Myers kernel
does not take: a pattern longer than 31, more words than the Myers kernel
keeps in registers, a pattern of length <= k, or no indels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# the kernel keeps each DP cell in one byte, capped at k + 1
MAX_K = 254
# shared memory per block: the accept words and 128 columns of Lmax bytes
_SMEM_MAX = 232448
_THREADS = 128


@dataclass(frozen=True)
class SellersTables:
    """The Sellers operands of one pattern set on one device.

    ``acc``: [P, Lmax, aw] int32; bit ``c & 31`` of word ``c >> 5`` is set
    when position j of pattern p accepts text code c.  ``lens``: [P]
    int32.  ``alpha``: the text alphabet size."""

    acc: torch.Tensor
    lens: torch.Tensor
    alpha: int

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
                             self.alpha)


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


def sellers_segc(n: int, P: int, halo: int) -> int:
    """Text positions per segment: about 2^18 (segment, pattern) threads
    for a large scan, at least four halos each and at most 8192."""
    return int(min(max(n * P >> 18, 4 * halo, 64), 8192))


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
    """Whether ``csrc/sellers.cu`` takes this pattern set and k: byte
    cells, a grid row per pattern, and one block's shared memory holding
    the pattern's accept words and 128 columns of Lmax bytes."""
    smem = st.Lmax * st.aw * 4 + st.Lmax * _THREADS
    return (0 <= k <= MAX_K and st.P <= 65535 and smem <= _SMEM_MAX
            and bool((st.lens >= 1).all()))


def sellers_scan(codes: torch.Tensor, n: int, st: SellersTables, eos: int,
                 k: int, indels: bool, cap: int,
                 segc: int | None = None) -> torch.Tensor:
    """Candidate triples of the Sellers scan of ``codes[:n]`` (see
    :func:`sellers_ref`): the int32 row ``[count, pos (cap), pid (cap),
    dist (cap)]``, triples in no order.

    ``codes`` uint8 [>= n]; ``st`` a :class:`SellersTables` on the same
    device.  On a CUDA tensor this launches ``csrc/sellers.cu`` on the
    current stream and counts the launch in ``sellers_scan.launches``; on
    a CPU tensor it is :func:`sellers_ref`.  Nothing here waits for the
    device."""
    if codes.device.type == "cpu":
        return sellers_ref(codes, n, st, eos, k, indels, cap)
    if codes.device.type != "cuda":
        raise ValueError(f"sellers_scan: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 1 \
            or not codes.is_contiguous() or codes.numel() < n:
        raise ValueError(f"sellers_scan: codes must be contiguous uint8 "
                         f"[>= n], got {codes.dtype} {tuple(codes.shape)}, "
                         f"n {n}")
    for name, t in (("acc", st.acc), ("lens", st.lens)):
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
    halo = st.Lmax + k
    segc = segc or sellers_segc(n, st.P, halo)
    out = torch.zeros(1 + 3 * cap, dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.sat_sellers_scan(
            codes.data_ptr(), n, st.acc.data_ptr(), st.lens.data_ptr(),
            st.P, st.Lmax, st.aw, st.alpha, eos, k, int(indels), segc, halo,
            out.data_ptr(), cap, stream)
    if rc != 0:
        raise RuntimeError(f"sellers_scan launch failed: cudaError_t {rc}")
    sellers_scan.launches += 1
    return out


sellers_scan.launches = 0
