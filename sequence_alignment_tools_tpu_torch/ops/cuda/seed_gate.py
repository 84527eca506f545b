"""The gated seed scan of the pigeonhole (k > 0) engines.

Counterpart of ``pallas_scan_gated_slots`` in
``sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py``, held to the
hit stream of ``ConvScanner.scan_gated``, not to the TPU's slot layout:

- :func:`seed_gate` enumerates every exact seed hit in the candidate
  microblocks and keeps those that pass the extension gate.  On a CUDA
  tensor it launches the hand-written kernel ``csrc/seed_gate.cu`` (a
  bit-parallel enumeration over :func:`.scan_kernel.filter_tables` of the
  seed weights, then the gate DP over a per-warp queue of hits); on a CPU
  tensor it runs :func:`seed_gate_ref`, the plain PyTorch version.
- :func:`gated_hits` is the whole pipeline: the scan filter over the
  seed tables (:func:`.scan_kernel.scan_occupancy`), compaction of the
  candidate microblocks, then :func:`seed_gate`, in one packed int32 row.
"""

from __future__ import annotations

import torch

from ...utils import trace
from ..compact import compact_mask
from ..gate import gate_ok_ref
from .scan_kernel import MB, filter_tables, scan_occupancy

# the widest gate band the kernel keeps in registers (2 * 8 + 1 cells)
MAX_BAND = 8


def seed_gate_ref(codes: torch.Tensor, n: int, dt, mb_count: torch.Tensor,
                  mb_idx: torch.Tensor, gt, eos: int, indels: bool,
                  cap: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`seed_gate`.

    The row ``[count, anchors (cap), sids (cap)]`` int32 holds every pair
    (anchor = t + len[s], sid = s) such that seed s of ``dt`` matches
    exactly at window start t < n (text past ``n`` read as ``eos``), t lies
    in one of the microblocks ``mb_idx[:min(mb_count, cap_mb)]`` (32
    starts each), and ``gate_ok_ref`` passes (anchor, s); ``count`` is the
    true number of pairs, of which the first ``cap`` are kept.  Here they
    come in (t, s) order; the kernel's order is free."""
    dev = codes.device
    Lmax, _alpha, S = dt.weights16.shape
    live = min(int(mb_count), mb_idx.numel())
    starts = (mb_idx[:live, None] * MB
              + torch.arange(MB, device=dev)[None, :]).reshape(-1)
    starts = starts[starts < n]
    w32 = dt.weights16.to(torch.int32)
    thr = dt.thresholds.to(torch.int32)
    lengths = dt.lengths.long()
    found_a, found_s = [], []
    chunk = max((1 << 24) // max(S, 1), 1)
    for c0 in range(0, starts.numel(), chunk):
        st = starts[c0 : c0 + chunk]
        g = st[:, None] + torch.arange(Lmax, device=dev)[None, :]
        win = torch.where(g < n, codes[g.clamp(max=n - 1)].long(), eos)
        score = torch.zeros(st.numel(), S, dtype=torch.int32, device=dev)
        for j in range(Lmax):
            score += w32[j][win[:, j]]
        ci, si = torch.nonzero(score >= thr[None, :], as_tuple=True)
        found_a.append(st[ci] + lengths[si])
        found_s.append(si)
    anchors = torch.cat(found_a) if found_a else torch.zeros(
        0, dtype=torch.long, device=dev)
    sids = torch.cat(found_s) if found_s else torch.zeros(
        0, dtype=torch.long, device=dev)
    ok = gate_ok_ref(codes, anchors, sids, gt, indels, n)
    anchors, sids = anchors[ok], sids[ok]
    count = anchors.numel()
    keep = min(count, cap)
    row = torch.zeros(1 + 2 * cap, dtype=torch.int32, device=dev)
    row[0] = count
    row[1 : 1 + keep] = anchors[:keep].to(torch.int32)
    row[1 + cap : 1 + cap + keep] = sids[:keep].to(torch.int32)
    return row


def _check(codes, n, dt, mb_count, mb_idx, gt, eos, cap):
    w, thr, lengths = dt.weights16, dt.thresholds, dt.lengths
    Lmax, alpha, S = w.shape
    tensors = {"codes": (codes, torch.uint8), "weights": (w, torch.int16),
               "thresholds": (thr, torch.int32),
               "lengths": (lengths, torch.int32),
               "mb_count": (mb_count, torch.int64),
               "mb_idx": (mb_idx, torch.int64),
               "gate bits": (gt.bits, torch.int32),
               "gate glen": (gt.glen, torch.int32),
               "gate gdir": (gt.gdir, torch.int32)}
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"seed_gate: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if t.device != codes.device:
            raise ValueError(f"seed_gate: {name} lies on {t.device}, the "
                             f"codes on {codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"seed_gate: {name} must be contiguous")
    if (codes.dim() != 1 or codes.numel() < n or n < 1
            or thr.shape != (S,) or lengths.shape != (S,)
            or mb_count.numel() != 1 or mb_idx.dim() != 1
            or gt.bits.shape != (S, gt.Lg) or gt.glen.shape != (S,)
            or gt.gdir.shape != (S,)):
        raise ValueError(
            f"seed_gate: bad shapes: codes {tuple(codes.shape)}, n {n}, "
            f"weights {tuple(w.shape)}, gate bits {tuple(gt.bits.shape)}")
    if not 0 <= eos < alpha:
        raise ValueError(f"eos code {eos} outside the alphabet [0, {alpha})")
    if gt.band > MAX_BAND:
        raise ValueError(f"seed_gate: gate band {gt.band} exceeds the "
                         f"kernel's {MAX_BAND}")
    if cap < 1 or n + Lmax >= 1 << 31:
        raise ValueError(f"seed_gate: cap {cap} < 1 or n {n} past int32 "
                         "anchors")


def seed_gate(codes: torch.Tensor, n: int, dt, mb_count: torch.Tensor,
              mb_idx: torch.Tensor, gt, eos: int, indels: bool,
              cap: int) -> torch.Tensor:
    """Gate survivors of the exact seed hits in the candidate microblocks
    (see :func:`seed_gate_ref`): the int32 row ``[count, anchors (cap),
    sids (cap)]``, survivors in no order.

    ``codes`` uint8 [>= n]; ``dt`` the seed scanner's
    :class:`..tables.DeviceTables` (k = 0, no poison); ``mb_count`` the
    one-element int64 count and ``mb_idx`` [cap_mb] int64 of
    :func:`..compact.compact_mask` over the seed filter's occupancy (the
    count is read on the device); ``gt`` a :class:`..gate.GateTables` on
    the same device.  On a CUDA tensor this launches ``csrc/seed_gate.cu``
    on the current stream over the :func:`.scan_kernel.filter_tables` of
    the seed weights (which raises ``ValueError`` for weights not of the
    port's 0/1 + poison form) and counts the launch in
    ``launch.seed_gate``; on a CPU tensor it is :func:`seed_gate_ref`."""
    if codes.device.type == "cpu":
        return seed_gate_ref(codes, n, dt, mb_count, mb_idx, gt, eos,
                             indels, cap)
    if codes.device.type != "cuda":
        raise ValueError(f"seed_gate: unsupported device {codes.device}")
    _check(codes, n, dt, mb_count, mb_idx, gt, eos, cap)
    from . import build

    ft = filter_tables(dt.weights16, dt.thresholds)
    lib = build.library("seed_gate")
    if codes.data_ptr() % 4:
        # the kernel stages its text 4 bytes at a time
        codes = codes[:n].clone()
    Lmax = dt.weights16.shape[0]
    out = torch.zeros(1 + 2 * cap, dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.sat_seed_gate(
            codes.data_ptr(), n, eos, ft.bits.data_ptr(), ft.R,
            ft.ent.data_ptr(), ft.pat.data_ptr(), ft.P, ft.J,
            ft.cls_off.data_ptr(), ft.cls_rows.data_ptr(), int(ft.direct),
            dt.lengths.data_ptr(), Lmax, mb_count.data_ptr(),
            mb_idx.data_ptr(), mb_idx.numel(), gt.bits.data_ptr(),
            gt.glen.data_ptr(), gt.gdir.data_ptr(), gt.Lg, gt.k, gt.band,
            int(indels), out.data_ptr(), cap, stream)
    if rc != 0:
        raise RuntimeError(f"seed_gate launch failed: cudaError_t {rc}")
    trace.count("launch.seed_gate")
    return out


def gated_hits(codes: torch.Tensor, n: int, dt, gt, eos: int, indels: bool,
               cap_mb: int, cap: int) -> torch.Tensor:
    """The gated seed scan of ``codes[:n]`` as ONE packed int32 row:

        [mb_count, surv_count, anchors (cap), sids (cap)]

    ``mb_count`` counts the seed filter's candidate microblocks (overflow
    when > ``cap_mb``), ``surv_count`` the gate survivors (overflow when
    > ``cap``); the survivors are (anchor = seed end, 0-based seed id)
    pairs in no order.  ``gt`` carries k and the band.  Nothing here waits
    for the device."""
    occ = scan_occupancy(codes, dt.weights16, dt.thresholds, n, eos)
    mb_count, mb_idx = compact_mask(occ, cap_mb)
    row = seed_gate(codes, n, dt, mb_count, mb_idx, gt, eos, indels, cap)
    return torch.cat([mb_count.reshape(1).to(torch.int32), row])
