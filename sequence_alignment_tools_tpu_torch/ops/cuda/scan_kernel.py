"""The fused exact / k-mismatch scan: CUDA filter, then exact rescore.

Counterpart of ``sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py``:

- :func:`scan_occupancy` is the microblock filter, the "occupancy" emit
  of that module's ``_scan_kernel``.  On a CUDA tensor it launches the
  hand-written kernel ``csrc/scan_filter.cu``; on a CPU tensor it runs
  :func:`scan_occupancy_ref`, the plain PyTorch version of the same
  function, which the tests hold against the JAX package.
- :func:`scan_hits` is ``pallas_scan_hits``: filter, compaction of the
  candidate microblocks, window gather, exact one-hot rescore, compaction
  of the hits, and the same packed int32 row.
"""

from __future__ import annotations

import torch

from ..compact import compact_mask

# the filter's microblock: one CUDA warp scores one microblock
MB = 32


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


def scan_occupancy(codes: torch.Tensor, w: torch.Tensor, thr: torch.Tensor,
                   n: int, eos: int, MB: int = MB) -> torch.Tensor:
    """Microblock occupancy of the scan (see :func:`scan_occupancy_ref`).

    ``codes``: uint8 [>= n], every code < alpha; ``w``: int16
    [Lmax, alpha, P]; ``thr``: int32 [P]; ``eos``: the code read past
    ``n``.  On a CUDA tensor this launches ``csrc/scan_filter.cu`` on the
    current stream (``MB`` must be 32, one warp) and counts the launch in
    ``scan_occupancy.launches``; on a CPU tensor it is
    :func:`scan_occupancy_ref`."""
    if codes.device.type == "cpu":
        return scan_occupancy_ref(codes, w, thr, n, eos, MB)
    if codes.device.type != "cuda":
        raise ValueError(f"scan_occupancy: unsupported device {codes.device}")
    Lmax, alpha, P = w.shape
    if MB != 32:
        raise ValueError("the CUDA scan filter scores 32-position "
                         f"microblocks (one warp each), got MB={MB}")
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
    from . import build

    lib = build.library("scan_filter")
    nmb = _nmb(n, MB)
    occ = torch.empty(nmb, dtype=torch.bool, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.sat_scan_occupancy(
            codes.data_ptr(), n, w.data_ptr(), thr.data_ptr(),
            Lmax, alpha, P, eos, occ.data_ptr(), nmb, stream)
    if rc != 0:
        raise RuntimeError(f"scan_filter launch failed: cudaError_t {rc}")
    scan_occupancy.launches += 1
    return occ


scan_occupancy.launches = 0


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
    :class:`..tables.DeviceTables`; nothing here waits for the device."""
    if n < 1:
        raise ValueError("scan_hits needs n >= 1")
    weights = dt.weights
    Lmax, alpha, P = weights.shape
    dev = codes.device
    occ = scan_occupancy(codes, dt.weights16, dt.thresholds, n, eos, MB)
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
