"""The fused exact / k-mismatch scan: CUDA filter, then exact rescore.

Counterpart of ``sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py``:

- :func:`scan_occupancy` is the microblock filter, the "occupancy" emit
  of that module's ``_scan_kernel``.  On a CUDA tensor it launches the
  hand-written kernel ``csrc/scan_filter.cu`` (a bit-parallel k-mismatch
  filter over the operands of :func:`filter_tables`); on a CPU tensor it
  runs :func:`scan_occupancy_ref`, the plain PyTorch version of the same
  function, which the tests hold against the JAX package.
- :func:`scan_hits` is ``pallas_scan_hits``: filter, compaction of the
  candidate microblocks, window gather, exact one-hot rescore, compaction
  of the hits, and the same packed int32 row; :func:`rescore_hits` is
  all of it after the filter, so that an overflowed row re-runs over the
  occupancy it already has.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ...utils import trace
from ..compact import compact_mask

# the filter's microblock: one lane of a CUDA warp scores one microblock
MB = 32
# the kernel's mask rows: one per class while there are at most this many
# (or no more than the codes they use), else one per code
_DIRECT_ROWS = 64
_SMEM_MAX = 232448  # sm_90 shared memory per block (opt-in maximum)


def _nmb(n: int, MB: int) -> int:
    return max(-(-n // MB), 1)


def scan_occupancy_ref(codes: torch.Tensor, w: torch.Tensor,
                       thr: torch.Tensor, n: int, eos: int,
                       MB: int = MB) -> torch.Tensor:
    """Plain PyTorch version of :func:`scan_occupancy`: bool [nmb],
    ``nmb = ceil(n / MB)``; entry m is True iff some window start t in
    [MB*m, MB*m + MB) and some pattern p score
    ``sum_j w[j, text[t + j], p] >= thr[p]``, text past ``n`` read as
    ``eos``.  Scored in position chunks to bound the [chunk, P] scores."""
    Lmax, _alpha, P = w.shape
    nmb = _nmb(n, MB)
    npos = nmb * MB
    dev = codes.device
    text = torch.full((npos + Lmax - 1,), eos, dtype=torch.long, device=dev)
    text[:n] = codes[:n].long()
    w32 = w.to(torch.int32)
    thr32 = thr.to(torch.int32)
    hit = torch.empty(npos, dtype=torch.bool, device=dev)
    chunk = max((1 << 24) // max(P, 1) // MB * MB, MB)
    for s in range(0, npos, chunk):
        e = min(s + chunk, npos)
        score = torch.zeros(e - s, P, dtype=torch.int32, device=dev)
        for j in range(Lmax):
            score += w32[j][text[s + j : e + j]]
        hit[s:e] = (score >= thr32).any(dim=1)
    return hit.view(nmb, MB).any(dim=1)


@dataclass(frozen=True)
class FilterTables:
    """The operands of ``csrc/scan_filter.cu`` for one weight tensor.

    A class is a distinct nonempty set of codes that some (position,
    pattern) cell accepts (weight 1) or kills (a negative weight, which
    no window can outweigh).  ``ent`` [P, J, 2] int32: the accept and kill
    class of each cell, -1 for none; ``pat`` [P, 2] int32: ``jend |
    poisoned << 16`` (jend one past the last cell with an accept or kill
    set) and ``kp = jend - thr`` (the misses a window may have; < 0 never
    hits, >= jend hits unless killed).  The kernel builds one mask per
    row of ``bits`` [R, 8] int32 (bit ``c & 31`` of word ``c >> 5``: code
    c is in the row's set): in ``direct`` form row i is class i; else row
    i is one code, and class c is the OR of rows
    ``cls_rows[cls_off[c] : cls_off[c + 1]]``."""

    bits: torch.Tensor
    ent: torch.Tensor
    pat: torch.Tensor
    cls_off: torch.Tensor
    cls_rows: torch.Tensor
    direct: bool

    @property
    def R(self) -> int:
        return self.bits.shape[0]

    @property
    def P(self) -> int:
        return self.pat.shape[0]

    @property
    def J(self) -> int:
        return self.ent.shape[1]


def _filter_smem(J: int, R: int) -> int:
    """Shared-memory bytes of one warp's mask rows and the row bitsets
    (``scan_filter.cu``'s ``geometry``): 33 words per row and tile plus
    one per 32 halo positions, at an odd stride."""
    ws = (33 + (max(J - 1, 0) >> 5)) | 1
    return R * 32 + R * ws * 4


def _build_filter_tables(w: torch.Tensor, thr: torch.Tensor) -> FilterTables:
    Lmax, alpha, P = w.shape
    if alpha > 256 or thr.shape != (P,):
        raise ValueError(f"filter tables: alphabet {alpha} past 256 or "
                         f"thresholds {tuple(thr.shape)} for P {P}")
    wn = w.detach().cpu().numpy().astype(np.int32).transpose(2, 0, 1)
    tn = thr.detach().cpu().numpy().astype(np.int64)
    acc = wn == 1
    kill = wn < 0
    if ((wn != 0) & ~acc & ~kill).any():
        raise ValueError("scan filter: weights must be 0, 1 or a negative "
                         "poison")
    # a negative entry must sink any window that meets it: the other
    # positions add at most one each
    maxpos = acc.any(axis=2).sum(axis=1)
    floor = np.iinfo(np.int32).min
    least = np.where(kill, wn, floor).max(axis=(1, 2), initial=floor)
    weak = kill.any(axis=(1, 2)) & (maxpos + least.astype(np.int64) >= tn)
    if weak.any():
        raise ValueError(
            f"scan filter: pattern {int(np.flatnonzero(weak)[0])} has a "
            "negative weight that a window can outweigh")
    used = (acc | kill).any(axis=2)  # [P, Lmax]
    jend = np.where(used.any(axis=1), Lmax - np.argmax(used[:, ::-1], axis=1),
                    0)
    J = int(jend.max(initial=0))
    if J > 0xFFFF:
        raise ValueError(f"scan filter: patterns of {J} positions")
    nb = -(-alpha // 8)
    packed = np.zeros((P, J, 2, 32), np.uint8)
    packed[:, :, 0, :nb] = np.packbits(acc[:, :J], axis=-1,
                                       bitorder="little")
    packed[:, :, 1, :nb] = np.packbits(kill[:, :J], axis=-1,
                                       bitorder="little")
    packed = packed.reshape(-1, 32)
    live = packed.any(axis=1)
    keys = np.ascontiguousarray(packed[live]).view(
        np.dtype((np.void, 32))).ravel()
    uniq, inv = np.unique(keys, return_inverse=True)
    ids = np.full(len(packed), -1, np.int64)
    ids[live] = inv.ravel()
    sets = np.frombuffer(uniq.tobytes(), np.uint8).reshape(-1, 32)
    set_bits = np.unpackbits(sets, axis=1, bitorder="little").astype(bool)
    codes_used = np.flatnonzero(set_bits.any(axis=0))
    C = len(uniq)
    direct = C <= max(_DIRECT_ROWS, len(codes_used))
    if _filter_smem(J, C if direct else len(codes_used)) > _SMEM_MAX:
        direct = not direct
        if _filter_smem(J, C if direct else len(codes_used)) > _SMEM_MAX:
            raise ValueError(f"scan filter: {C} classes over "
                             f"{len(codes_used)} codes at {J} positions "
                             "exceed shared memory")
    if direct:
        row_sets = sets
        cls_off = np.zeros(0, np.int32)
        cls_rows = np.zeros(0, np.int32)
    else:
        row_of = np.full(256, -1, np.int64)
        row_of[codes_used] = np.arange(len(codes_used))
        one = np.zeros((len(codes_used), 256), bool)
        one[np.arange(len(codes_used)), codes_used] = True
        row_sets = np.packbits(one, axis=1, bitorder="little")
        ci, cc = np.nonzero(set_bits)
        cls_rows = row_of[cc].astype(np.int32)
        cls_off = np.searchsorted(ci, np.arange(C + 1)).astype(np.int32)
    bits = np.ascontiguousarray(row_sets, np.uint8).reshape(-1, 32).view(
        "<u4").astype(np.uint32).view(np.int32)
    kp = np.clip(jend - tn, -1, jend)
    poisoned = kill.any(axis=(1, 2))
    pat = np.stack([jend | (poisoned.astype(np.int64) << 16), kp], axis=1)
    dev = w.device

    def put(a):
        a = np.ascontiguousarray(a, np.int32)
        trace.count("upload.bytes", a.nbytes)
        return torch.from_numpy(a).to(dev)

    return FilterTables(bits=put(bits.reshape(-1, 8)),
                        ent=put(ids.reshape(P, J, 2)), pat=put(pat),
                        cls_off=put(cls_off), cls_rows=put(cls_rows),
                        direct=bool(direct))


_FT_CACHE: dict = {}


def filter_tables(w: torch.Tensor, thr: torch.Tensor) -> FilterTables:
    """The :class:`FilterTables` of weights ``w`` [Lmax, alpha, P] and
    thresholds ``thr`` [P], on their device, built once per pair of
    tensors (kept while both live).  Raises ``ValueError`` when ``w`` is
    not of the form the port's weight tables have: entries 0, 1 or
    negative, each negative entry low enough that no window meeting it
    reaches its pattern's threshold."""
    key = (id(w), id(thr))
    hit = _FT_CACHE.get(key)
    if hit is not None and hit[0]() is w and hit[1]() is thr:
        return hit[2]
    with trace.span("scan.tables"):
        ft = _build_filter_tables(w, thr)
    for k in [k for k, v in _FT_CACHE.items()
              if v[0]() is None or v[1]() is None]:
        del _FT_CACHE[k]
    _FT_CACHE[key] = (weakref.ref(w), weakref.ref(thr), ft)
    return ft


def scan_occupancy(codes: torch.Tensor, w: torch.Tensor, thr: torch.Tensor,
                   n: int, eos: int, MB: int = MB) -> torch.Tensor:
    """Microblock occupancy of the scan (see :func:`scan_occupancy_ref`).

    ``codes``: uint8 [>= n], every code < alpha; ``w``: int16
    [Lmax, alpha, P]; ``thr``: int32 [P]; ``eos``: the code read past
    ``n``.  On a CUDA tensor this launches ``csrc/scan_filter.cu`` on the
    current stream (``MB`` must be 32, one lane's word) over the
    :func:`filter_tables` of ``w`` and ``thr`` (which raises
    ``ValueError`` for weights not of the port's 0/1 + poison form) and
    counts the launch in ``launch.scan_occupancy``; on a CPU tensor it
    is :func:`scan_occupancy_ref`.  Either counts ``n`` in
    ``scan.positions``."""
    if codes.device.type == "cpu":
        trace.count("scan.positions", n)
        return scan_occupancy_ref(codes, w, thr, n, eos, MB)
    if codes.device.type != "cuda":
        raise ValueError(f"scan_occupancy: unsupported device {codes.device}")
    Lmax, alpha, P = w.shape
    if MB != 32:
        raise ValueError("the CUDA scan filter scores 32-position "
                         f"microblocks (one lane's word each), got MB={MB}")
    if codes.dtype != torch.uint8 or w.dtype != torch.int16 \
            or thr.dtype != torch.int32:
        raise TypeError("scan_occupancy wants uint8 codes, int16 weights "
                        f"and int32 thresholds, got {codes.dtype}, "
                        f"{w.dtype}, {thr.dtype}")
    if w.device != codes.device or thr.device != codes.device:
        raise ValueError("codes, weights and thresholds must share a device")
    if not (codes.is_contiguous() and w.is_contiguous()
            and thr.is_contiguous()):
        raise ValueError("scan_occupancy wants contiguous tensors")
    if thr.shape != (P,) or codes.dim() != 1 or codes.numel() < n:
        raise ValueError(f"bad shapes: codes {tuple(codes.shape)}, n {n}, "
                         f"w {tuple(w.shape)}, thr {tuple(thr.shape)}")
    if not 0 <= eos < alpha:
        raise ValueError(f"eos code {eos} outside the alphabet [0, {alpha})")
    ft = filter_tables(w, thr)
    from . import build

    lib = build.library("scan_filter")
    nmb = _nmb(n, MB)
    occ = torch.empty(nmb, dtype=torch.bool, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.sat_scan_occupancy(
            codes.data_ptr(), n, eos, ft.bits.data_ptr(), ft.R,
            ft.ent.data_ptr(), ft.pat.data_ptr(), ft.P, ft.J,
            ft.cls_off.data_ptr(), ft.cls_rows.data_ptr(), int(ft.direct),
            int(ft.R <= 8 and alpha <= 32), occ.data_ptr(), nmb, stream)
    if rc != 0:
        raise RuntimeError(f"scan_filter launch failed: cudaError_t {rc}")
    trace.count("launch.scan_occupancy")
    trace.count("scan.positions", n)
    return occ


def long_form(cap_mb: int, P: int, MB: int = MB) -> bool:
    """Whether the packed row carries mismatches in their own section
    (the hit index space needs more than 24 bits)."""
    return cap_mb * MB * P >= (1 << 24)


def scan_hits(codes: torch.Tensor, n: int, dt, eos: int, cap_mb: int,
              hit_cap: int, MB: int = MB) -> torch.Tensor:
    """The whole scan of ``codes[:n]`` as ONE packed int32 row, the layout
    of the JAX ``pallas_scan_hits``:

        [mb_count, hit_count, mb_idx (cap_mb), hits (hit_cap)]

    A hit flat-indexes [cap_mb, MB, P] row-major; while
    ``cap_mb * MB * P < 2**24`` each hit word is ``mism << 24 | idx``,
    otherwise ``hits`` holds the bare indices and a mismatch section
    (hit_cap) follows.  Overflow is ``mb_count > cap_mb`` or
    ``hit_count > hit_cap``.  ``dt`` is the scanner's
    :class:`..tables.DeviceTables`; nothing here waits for the device.
    It is :func:`rescore_hits` over the :func:`scan_occupancy` of the
    scan: a caller that keeps the occupancy can re-run the rescore alone
    with larger caps."""
    if n < 1:
        raise ValueError("scan_hits needs n >= 1")
    occ = scan_occupancy(codes, dt.weights16, dt.thresholds, n, eos, MB)
    return rescore_hits(occ, codes, n, dt, eos, cap_mb, hit_cap, MB)


def rescore_hits(occ: torch.Tensor, codes: torch.Tensor, n: int, dt,
                 eos: int, cap_mb: int, hit_cap: int,
                 MB: int = MB) -> torch.Tensor:
    """The stages of :func:`scan_hits` after the filter, over its
    occupancy ``occ`` (bool [ceil(n / MB)]): compaction of the candidate
    microblocks, window gather, exact one-hot rescore, compaction of the
    hits, and the packed row.  ``mb_count`` counts the whole of ``occ``
    at any cap; ``hit_count`` only the hits inside the first ``cap_mb``
    candidate microblocks.  The filter and the rescore test the same
    scores, so every candidate microblock holds a hit: with ``cap_mb``
    at least ``mb_count``, ``hit_count >= mb_count``."""
    if n < 1:
        raise ValueError("rescore_hits needs n >= 1")
    weights = dt.weights
    Lmax, alpha, P = weights.shape
    dev = codes.device
    nmb = occ.numel()
    mb_count, mb_idx = compact_mask(occ, cap_mb)

    # candidate windows, text past n read as EOS (as the JAX path's EOS
    # padding does)
    win_len = MB + Lmax - 1
    starts = torch.clamp(mb_idx, max=nmb - 1) * MB
    g = starts[:, None] + torch.arange(win_len, device=dev)[None, :]
    wins = torch.where(g < n, codes[torch.clamp(g, max=n - 1)].long(), eos)
    sub_idx = (torch.arange(MB, device=dev)[:, None]
               + torch.arange(Lmax, device=dev)[None, :])
    sub = wins[:, sub_idx]  # [cap_mb, MB, Lmax]
    # exact rescore as one float32 product: 0/1 one-hots times integer
    # weights, so every score is an exact integer
    im2col = torch.zeros(cap_mb * MB, Lmax * alpha, dtype=torch.float32,
                         device=dev)
    cols = sub.reshape(cap_mb * MB, Lmax) + torch.arange(
        0, Lmax * alpha, alpha, device=dev)[None, :]
    im2col.scatter_(1, cols, 1.0)
    scores = im2col @ weights.reshape(Lmax * alpha, P)  # [cap_mb*MB, P]
    valid = torch.repeat_interleave(mb_idx < nmb, MB)[:, None]
    hit = (scores >= dt.thresholds[None, :]) & valid
    hit_count, hit_idx = compact_mask(hit, hit_cap)
    sflat = torch.cat([scores.reshape(-1),
                       torch.zeros(1, dtype=scores.dtype, device=dev)])
    mism = torch.clamp(dt.lengths[hit_idx % P]
                       - sflat[hit_idx].to(torch.int32), 0, 127)
    head = torch.stack([mb_count, hit_count]).to(torch.int32)
    mb_idx = mb_idx.to(torch.int32)
    hit_idx = hit_idx.to(torch.int32)
    if not long_form(cap_mb, P, MB):
        return torch.cat([head, mb_idx, (mism << 24) | hit_idx])
    return torch.cat([head, mb_idx, hit_idx, mism])
