"""The Myers bit-vector k-edit scan of the filter engine.

Counterpart of ``sequence_alignment_tools_tpu/ops/pallas/myers_kernel.py``
(``_myers_kernel`` and its XLA epilogue ``pallas_myers_epilogue``), held
to the candidate contract, not to the TPU's layout:

    {(pos, p) : the semi-global Levenshtein distance of pattern p against
                some text substring ending at position pos is <= k}

(the filter engine's boundary is ``pos + 1``), with the Sellers EOS rule:
an EOS character resets the state to a fresh start and never ends a hit.
That gate relies on every pattern being longer than k.

:func:`myers_eqbits` is the port's copy of the JAX host layout builder:
patterns pair greedily into 32-bit words, field A at bits [0, la), a zero
guard bit at la (the add's carry dies there), field B from la + 1.
:func:`myers_pairs` launches ``csrc/myers.cu`` on a CUDA tensor (which
moves field B to the top of its word and keeps the scores biased by
-(k + 1); ``tests/test_torch_myers_words.py`` models that arithmetic) and
runs :func:`myers_pairs_ref`, the same recurrence over int64 words in
plain PyTorch, on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

# the kernel keeps at most this many 32-bit words of state per thread
MAX_WORDS = 32
# every field of a word holds at most this many pattern positions
MAX_FIELD = 31


def _s32(v: int) -> int:
    """Wrap an unsigned 32-bit mask to the signed int32 value."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def myers_eqbits(tables):
    """(eqwords, wordspec, lens, classes): the packed word layout, as the
    JAX package's ``myers_eqbits`` builds it.

    Patterns pair greedily (longest first, first fit) into int32 words
    when ``la + 1 + lb <= 32``.  ``eqwords[w][ci]`` is the combined accept
    mask of both fields for live class ``classes[ci]`` (codes other than
    EOS that some pattern accepts); ``wordspec[w] = (pa, pb)`` with
    ``pb = -1`` for a singleton."""
    t = tables
    classes = tuple(
        c for c in range(t.alpha)
        if c != t.eos_code and bool(np.any(t.match[:, :, c])))
    lens = tuple(int(t.lengths[p]) for p in range(t.P))

    def bits(p, c):
        b = 0
        for j in range(lens[p]):
            if t.match[p, j, c]:
                b |= 1 << j
        return b

    order = sorted(range(t.P), key=lambda p: -lens[p])
    used = [False] * t.P
    wordspec = []
    for i, pa in enumerate(order):
        if used[pa]:
            continue
        used[pa] = True
        mate = -1
        for pb in order[i + 1:]:
            if not used[pb] and lens[pa] + 1 + lens[pb] <= 32:
                mate = pb
                used[pb] = True
                break
        wordspec.append((pa, mate))
    eqwords = []
    for pa, pb in wordspec:
        row = []
        for c in classes:
            b = bits(pa, c)
            if pb >= 0:
                b |= bits(pb, c) << (lens[pa] + 1)
            row.append(_s32(b))
        eqwords.append(tuple(row))
    return tuple(eqwords), tuple(wordspec), lens, classes


@dataclass(frozen=True)
class MyersTables:
    """The Myers operands of one pattern set on one device.

    ``eq``: [256, nw] int32, the accept bits of word w for text code c
    (rows of codes no pattern accepts, EOS included, are 0).  ``words_np``:
    [nw, 4] int32 host array (pattern A, pattern B or -1, length A,
    length B or 0) per word.  ``Lmax``: the longest pattern."""

    eq: torch.Tensor
    words_np: np.ndarray
    Lmax: int

    @property
    def nw(self) -> int:
        return len(self.words_np)

    def to(self, device) -> MyersTables:
        return MyersTables(self.eq.to(device), self.words_np, self.Lmax)


def myers_tables(tables) -> MyersTables:
    """:class:`MyersTables` (on the CPU) of a ``PatternTables``."""
    eqwords, wordspec, lens, classes = myers_eqbits(tables)
    eq = np.zeros((256, len(wordspec)), np.int32)
    for w, row in enumerate(eqwords):
        for ci, c in enumerate(classes):
            eq[c, w] = row[ci]
    words = np.asarray([(pa, pb, lens[pa], lens[pb] if pb >= 0 else 0)
                        for pa, pb in wordspec], np.int32).reshape(-1, 4)
    return MyersTables(torch.from_numpy(eq), words, max(lens, default=1))


def myers_segc(n: int, halo: int) -> int:
    """Text positions per segment (one thread each): about 2^18 segments
    for a large scan, and at least four halos each."""
    return max(n >> 18, 4 * halo, 64) if n >> 18 < 4096 else 4096


def _word_consts(words: np.ndarray):
    """(ones, smask, top_a, top_b, la, lb) int64 arrays per word."""
    pa, pb, la, lb = (words[:, i].astype(np.int64) for i in range(4))
    pair = pb >= 0
    ones = (np.int64(1) << la) - 1
    ones = np.where(pair, ones | (((np.int64(1) << lb) - 1) << (la + 1)),
                    ones)
    smask = np.where(pair, ~(np.int64(1) << (la + 1)), np.int64(-1))
    top_b = np.where(pair, la + lb, 0)
    return ones, smask, la - 1, top_b, la, np.where(pair, lb, 1 << 30)


def myers_pairs_ref(codes: torch.Tensor, n: int, mt: MyersTables, eos: int,
                    k: int, cap: int, segc: int | None = None
                    ) -> torch.Tensor:
    """Plain PyTorch version of :func:`myers_pairs`.

    The row ``[count, pos (cap), pid (cap)]`` int32 holds every pair of the
    Myers contract over ``codes[:n]``; ``count`` is the true number, of
    which the first ``cap`` are kept.  The recurrence runs over int64
    words, vectorised over segments of ``segc`` positions and sequential
    over characters, each segment first walking a fresh-start halo of
    Lmax + k characters (positions outside [0, n) read as EOS)."""
    dev = codes.device
    halo = mt.Lmax + k
    segc = segc or myers_segc(n, halo)
    nseg = -(-n // segc)
    pad = torch.full((halo + nseg * segc,), eos, dtype=torch.uint8,
                     device=dev)
    pad[halo : halo + n] = codes[:n]
    text = pad.unfold(0, halo + segc, segc)  # [nseg, halo + segc]
    eq = mt.eq.to(dev).long() & 0xFFFFFFFF
    words = mt.words_np
    ones, smask, top_a, top_b, la, lb = (
        torch.from_numpy(a).to(dev) for a in _word_consts(words))
    pa = torch.from_numpy(words[:, 0].astype(np.int64)).to(dev)
    pb = torch.from_numpy(words[:, 1].astype(np.int64)).to(dev)
    pv = ones.expand(nseg, -1).clone()
    mv = torch.zeros_like(pv)
    sa = la.expand(nseg, -1).clone()
    sb = lb.expand(nseg, -1).clone()
    seg0 = torch.arange(nseg, device=dev) * segc
    found_p, found_w = [], []
    for j in range(halo + segc):
        c = text[:, j].long()
        e = eq[c]
        xv = e | mv
        xh = (((e & pv) + pv) ^ pv) | e
        ph = mv | ~(xh | pv)
        mh = pv & xh
        sa = sa + ((ph >> top_a) & 1) - ((mh >> top_a) & 1)
        sb = sb + ((ph >> top_b) & 1) - ((mh >> top_b) & 1)
        ph = (ph << 1) & smask
        mh = (mh << 1) & smask
        pv = (mh | ~(xv | ph)) & ones
        mv = (ph & xv) & ones
        at = (c == eos)[:, None]
        pv = torch.where(at, ones, pv)
        mv = torch.where(at, 0, mv)
        sa = torch.where(at, la, sa)
        sb = torch.where(at, lb, sb)
        if j < halo:
            continue
        pos = seg0 + (j - halo)
        ok = (pos < n)[:, None]
        for s, pid, live in ((sa, pa, None), (sb, pb, pb >= 0)):
            hit = (s <= k) & ok
            if live is not None:
                hit &= live[None, :]
            si, wi = torch.nonzero(hit, as_tuple=True)
            found_p.append(pos[si])
            found_w.append(pid[wi])
    pos = torch.cat(found_p) if found_p else torch.zeros(0, device=dev)
    pid = torch.cat(found_w) if found_w else torch.zeros(0, device=dev)
    count = pos.numel()
    keep = min(count, cap)
    row = torch.zeros(1 + 2 * cap, dtype=torch.int32, device=dev)
    row[0] = count
    row[1 : 1 + keep] = pos[:keep].to(torch.int32)
    row[1 + cap : 1 + cap + keep] = pid[:keep].to(torch.int32)
    return row


def _check(codes, n, mt, eos, k, cap):
    if codes.dtype != torch.uint8 or codes.dim() != 1 \
            or not codes.is_contiguous() or codes.numel() < n:
        raise ValueError(f"myers_pairs: codes must be contiguous uint8 "
                         f"[>= n], got {codes.dtype} {tuple(codes.shape)}, "
                         f"n {n}")
    if mt.eq.device != codes.device or mt.eq.dtype != torch.int32 \
            or tuple(mt.eq.shape) != (256, mt.nw):
        raise ValueError("myers_pairs: eq must be int32 [256, nw] on the "
                         "codes' device")
    if not 1 <= mt.nw <= MAX_WORDS:
        raise ValueError(f"myers_pairs: {mt.nw} words, the kernel keeps "
                         f"at most {MAX_WORDS}")
    lens = mt.words_np[:, 2:]
    pair = mt.words_np[:, 1] >= 0
    if lens[:, 0].max() > MAX_FIELD or lens[pair, 1].max(initial=0) \
            > MAX_FIELD:
        raise ValueError(f"myers_pairs: a pattern longer than {MAX_FIELD}")
    if min(lens[:, 0].min(), lens[pair, 1].min(initial=k + 1)) <= k:
        raise ValueError(f"myers_pairs: a pattern of length <= k = {k}")
    if not 0 <= eos < 256 or cap < 1 or n + mt.Lmax + k >= 1 << 31:
        raise ValueError(f"myers_pairs: bad eos {eos}, cap {cap} or n {n}")


def myers_pairs(codes: torch.Tensor, n: int, mt: MyersTables, eos: int,
                k: int, cap: int, segc: int | None = None) -> torch.Tensor:
    """Candidate pairs of the Myers scan of ``codes[:n]`` (see
    :func:`myers_pairs_ref`): the int32 row ``[count, pos (cap),
    pid (cap)]``, pairs in no order.

    ``codes`` uint8 [>= n]; ``mt`` a :class:`MyersTables` on the same
    device.  On a CUDA tensor this launches ``csrc/myers.cu`` on the
    current stream and counts the launch in ``myers_pairs.launches``; on a
    CPU tensor it is :func:`myers_pairs_ref`.  Nothing here waits for the
    device."""
    if codes.device.type == "cpu":
        return myers_pairs_ref(codes, n, mt, eos, k, cap, segc)
    if codes.device.type != "cuda":
        raise ValueError(f"myers_pairs: unsupported device {codes.device}")
    _check(codes, n, mt, eos, k, cap)
    from . import build

    lib = build.library("myers")
    if codes.data_ptr() % 16:
        # the kernel reads its text 16 bytes at a time
        codes = codes[:n].clone()
    halo = mt.Lmax + k
    segc = segc or myers_segc(n, halo)
    words = np.ascontiguousarray(mt.words_np, np.int32)
    out = torch.zeros(1 + 2 * cap, dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.sat_myers_pairs(
            codes.data_ptr(), n, mt.eq.data_ptr(),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), mt.nw,
            eos, k, segc, halo, out.data_ptr(), cap, stream)
    if rc != 0:
        raise RuntimeError(f"myers_pairs launch failed: cudaError_t {rc}")
    myers_pairs.launches += 1
    return out


myers_pairs.launches = 0
