"""Exact and k-mismatch multi-pattern scan over a flat code array.

Port of ``sequence_alignment_tools_tpu/ops/conv_scan.py::ConvScanner``:
the same constructor, attributes, candidate contract and route ladder.
A candidate is ``(end, pattern_index_0based, mismatches)``; a scan yields
them ordered by (window start, pattern), where

    score(t, p) = sum_j W[j, text[t + j], p]  >=  lengths[p] - k

with ``W`` the conv weights (EOS poison under ``poison_eos``).

``scan`` takes the first rung that applies, in the JAX order:

1. stream-whole: arrays past ``_RESIDENT_MAX`` (or memory-mapped past
   ``_STREAM_BLOCK``) scan as halo'd blocks through :meth:`scan_stream`;
2. sharded: not ported (ROADMAP queue 1 item 11), raises;
3. host: the native shift-and machine (:class:`.host_scan.HostShiftAnd`,
   the port's copy of the JAX package's) for small scans;
4. radix census for dense exact seeds: not ported (ROADMAP queue 1
   item 3), raises;
5. the fused device route for every other scan, at any length, pattern
   length and alphabet: :func:`.cuda.scan_kernel.scan_hits` (CUDA filter
   kernel, compaction, exact rescore) in one packed row per scan, with
   cap pre-sizing and an overflow retry.  Pattern sets past ``_PBLOCK``
   (pattern-blocked, ROADMAP queue 1 item 3) raise.

The JAX scanner's other device routes (the XLA block path, the bit-plane
and seam modes for wide alphabets) are layouts for the TPU; the CUDA
filter scores any alphabet up to 256 codes and any pattern length, so the
port has this one device route and none of the knobs that chose between
routes (``use_pallas``, ``pallas_interpret``, ``block``, ``cap``).

The pigeonhole (k > 0) engines scan their exact seeds through the gated
route instead (:meth:`ConvScanner.scan_gated`, :meth:`scan_gated_stream`):
the same filter, then :func:`.cuda.seed_gate.seed_gate`, which enumerates
every seed hit in the candidate microblocks and keeps the extension gate's
survivors.  It names every seed at every start, so the JAX route's escape
list (multi-seed starts, EOS windows, slot overflows rescanned on the
host) and its slot, chain and fold machinery have no counterpart.
"""

from __future__ import annotations

import os
import weakref
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from .cuda.scan_kernel import long_form, scan_hits
from .cuda.seed_gate import gated_hits
from .tables import device_tables


class ConvScanner:
    """Block-streaming exact / k-mismatch scanner over a flat code array.

    Yields candidates as (end_position, pattern_index_0based, mismatches),
    globally ordered by (window_start, pattern).
    """

    _MB = 32
    _PBLOCK = 2048  # largest pattern set one fused scan takes
    # candidate-buffer floors; _expected_hits raises them up front and
    # overflow retries grow them stickily
    _cap_mb = 128
    _hit_cap = 512
    # streaming memory model: arrays past the residency bound scan as
    # halo'd blocks
    _STREAM_BLOCK = 1 << 24
    _RESIDENT_MAX = 1 << 28
    _STREAM_DEPTH = 256  # blocks queued ahead of the one being decoded

    # per-block progress callback (frac in (0, 1]), attached by the model
    progress = None
    # only None is supported: a mesh means the sharded rungs
    mesh = None
    # tri-state: None = auto (small scans), False = never, True = whenever
    # the native machine can represent the patterns
    use_host = None

    def __init__(self, tables, k: int = 0, poison_eos: bool | None = None,
                 device=None):
        self.tables = tables
        self.k = k
        if poison_eos is None:
            poison_eos = k > 0
        self.poison_eos = poison_eos
        self.device = resolve_device(device)
        self._dt = None
        self._dev_c = None
        self._host_scanner = None
        self._radix_ok_c = None
        self._routes_done = None
        self._gt_dev = None

    def _tables_dev(self):
        if self._dt is None:
            self._dt = device_tables(self.tables, self.k, self.poison_eos,
                                     self.device)
        return self._dt

    @property
    def _eos(self) -> int:
        # a code >= 0 (as the JAX fused route pads)
        return max(int(self.tables.eos_code), 0)

    def _route(self, msg: str) -> None:
        """Name the route taken, once per scanner, as a '-v' line
        (verbose mode or SAT_ROUTE_VERBOSE=1)."""
        if self.progress is None and not os.environ.get(
                "SAT_ROUTE_VERBOSE"):
            return
        if self._routes_done is None:
            self._routes_done = set()
        if msg in self._routes_done:
            return
        self._routes_done.add(msg)
        from ..utils.log import timestamp

        timestamp("Route: " + msg)

    def _check_mesh(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "sharded scans over a device mesh are not ported yet "
                "(ROADMAP queue 1 item 11)")

    def _device_form(self, codes) -> torch.Tensor:
        """uint8 device copy of a host code array, kept for the last array
        seen (a resident database is uploaded once)."""
        ent = self._dev_c
        if ent is not None and ent[0]() is codes:
            return ent[1]
        arr = np.ascontiguousarray(codes, dtype=np.uint8)
        if not arr.flags.writeable:
            arr = arr.copy()
        dev = torch.from_numpy(arr).to(self.device)
        self._dev_c = (weakref.ref(codes), dev)
        return dev

    # -- candidate-buffer sizing --------------------------------------------

    def _expected_hits(self, n: int) -> float:
        """Crude expected candidate count on random text: n * P /
        alpha^(Lmin-k).  Steers the route choice and initial caps."""
        t = self.tables
        lmin = int(t.lengths.min()) if len(t.lengths) else 1
        eff = max(lmin - self.k, 1)
        sigma = max(t.alpha - 1, 2)  # alphabet minus the EOS code
        try:
            return float(n) * t.P / float(sigma) ** eff
        except OverflowError:
            return 0.0

    def _presize(self, n: int) -> tuple[int, int]:
        est = int(self._expected_hits(n) * 4) + 1
        if est > self._hit_cap:
            self._hit_cap = 1 << (est - 1).bit_length()
        if est > self._cap_mb:
            nmb = max(n // self._MB, 1)
            self._cap_mb = 1 << (min(est, nmb) - 1).bit_length()
        return self._cap_mb, self._hit_cap

    # -- the fused device route ---------------------------------------------

    def _check_fused(self) -> None:
        t = self.tables
        if t.P > self._PBLOCK:
            raise NotImplementedError(
                "pattern-blocked scans (P = %d > %d) are not ported yet "
                "(ROADMAP queue 1 item 3)" % (t.P, self._PBLOCK))

    def _dispatch(self, codes_dev, n: int, cap_mb: int, hit_cap: int):
        return scan_hits(codes_dev, n, self._tables_dev(), self._eos,
                         cap_mb, hit_cap, self._MB)

    def _decode_packed(self, packed, codes_dev, n: int, caps=None):
        """Decode a fetched packed row, retrying with larger caps on
        overflow."""
        cap_mb, hit_cap = caps or (self._cap_mb, self._hit_cap)
        mb_count, hit_count = int(packed[0]), int(packed[1])
        if mb_count > cap_mb or hit_count > hit_cap:
            yield from self._redispatch(codes_dev, n, mb_count, hit_count)
            return
        mb_idx = packed[2 : 2 + cap_mb]
        hits = packed[2 + cap_mb : 2 + cap_mb + hit_cap]
        if not long_form(cap_mb, self.tables.P, self._MB):
            hit_idx = hits & 0x00FFFFFF
            hit_mism = hits >> 24
        else:
            hit_idx = hits
            hit_mism = packed[2 + cap_mb + hit_cap :]
        yield from self._emit(hit_count, mb_idx, hit_idx, hit_mism, n)

    def _redispatch(self, codes_dev, n: int, mb_count: int, hit_count: int):
        """Overflow retry: grow the caps past the observed true counts,
        rescan and decode; caps grow monotonically, so it terminates."""
        cap_mb = max(self._cap_mb,
                     1 << int(max(mb_count, 1) - 1).bit_length())
        hit_cap = max(self._hit_cap,
                      1 << int(max(hit_count, 1) - 1).bit_length())
        self._cap_mb, self._hit_cap = cap_mb, hit_cap
        packed = self._dispatch(codes_dev, n, cap_mb, hit_cap)
        yield from self._decode_packed(packed.cpu().numpy(), codes_dev, n,
                                       (cap_mb, hit_cap))

    def _emit(self, hit_count: int, mb_idx, hit_idx, hit_mism, n: int):
        """Yield (end, pid, mism) tuples from the live result sections."""
        if hit_count == 0:
            return
        t = self.tables
        P = t.P
        MB = self._MB
        idx = hit_idx[:hit_count].astype(np.int64)
        ms = hit_mism[:hit_count]
        slot = idx // (MB * P)
        win = (idx // P) % MB
        pid = idx % P
        starts = mb_idx[slot].astype(np.int64) * MB + win
        keep = starts < n
        starts, pid, ms = starts[keep], pid[keep], ms[keep]
        ends = starts + t.lengths[pid]
        for e, p, m in zip(ends, pid, ms):
            yield int(e), int(p), int(m)

    def _scan_fused(self, codes):
        n = len(codes)
        if n == 0:
            return
        codes_dev = self._device_form(codes)
        caps = self._presize(n)
        packed = self._dispatch(codes_dev, n, *caps)
        yield from self._decode_packed(packed.cpu().numpy(), codes_dev, n,
                                       caps)

    def scan_stream(self, blocks, depth: int | None = None):
        """Pipelined scan over an iterator of flat code arrays.

        Block i + 1 ... i + depth are dispatched before block i's result
        is read: each block's packed row is copied to pinned host memory
        without blocking and an event marks its completion, so the host
        decodes block i while the device scans the blocks behind it.
        Yields (block_index, hits_list) in order."""
        if depth is None:
            depth = self._STREAM_DEPTH
        depth = max(int(depth), 1)
        self._check_mesh()
        self._check_fused()
        pending = deque()
        for i, codes in enumerate(blocks):
            n = len(codes)
            if n == 0:
                pending.append((i, None, None, None, 0, None))
            else:
                dev = self._device_form(codes)
                caps = (self._cap_mb, self._hit_cap)
                packed = self._dispatch(dev, n, *caps)
                host, ev = self._to_host(packed)
                pending.append((i, host, ev, dev, n, caps))
            if len(pending) >= depth:
                yield self._drain(pending.popleft())
        while pending:
            yield self._drain(pending.popleft())

    @staticmethod
    def _to_host(packed: torch.Tensor):
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _drain(self, item):
        i, host, ev, dev, n, caps = item
        if host is None:
            return i, []
        if ev is not None:
            ev.synchronize()
        return i, list(self._decode_packed(host.numpy(), dev, n, caps))

    # -- the gated route (pigeonhole k > 0 engines) --------------------------

    # The gated route's candidate-microblock cap is every microblock of the
    # scan: it only sizes compact_mask's index buffer on the device (8 bytes
    # per 32 positions, never fetched), so the filter's list cannot
    # overflow and a new scanner's first scan runs once.  The survivor cap
    # sizes the row the host fetches: it starts small and an overflow
    # retry grows it stickily.
    _gsurv_cap = 1 << 12

    def _gated_caps(self, n: int) -> tuple[int, int]:
        return max(-(-n // self._MB), 1), self._gsurv_cap

    def gated_available(self, n: int) -> bool:
        """Whether :meth:`scan_gated` takes a seed scan of ``n``
        positions: every scan of at most ``_PBLOCK`` seeds over a resident
        array that the host rung does not take."""
        return (self.mesh is None and self.tables.P <= self._PBLOCK
                and n <= self._RESIDENT_MAX and not self._host_eligible(n))

    def _gate_dev(self, gt):
        """``gt`` on the scanner's device, kept for the last gate seen."""
        if self._gt_dev is None or self._gt_dev[0] is not gt:
            self._gt_dev = (gt, gt.to(self.device))
        return self._gt_dev[1]

    def _gated_dispatch(self, codes_dev, n: int, gt_dev, indels: bool,
                        caps):
        return gated_hits(codes_dev, n, self._tables_dev(), gt_dev,
                          self._eos, indels, *caps)

    def _gated_decode(self, packed, codes_dev, n: int, gt_dev, indels: bool,
                      caps):
        """(anchors int64, sids int32) from a fetched gated row, retrying
        with the survivor cap grown past the true count on overflow."""
        count = int(packed[1])
        if count > caps[1]:
            self._gsurv_cap = max(self._gsurv_cap,
                                  1 << (count - 1).bit_length())
            caps = (caps[0], self._gsurv_cap)
            packed = self._gated_dispatch(codes_dev, n, gt_dev, indels, caps)
            return self._gated_decode(packed.cpu().numpy(), codes_dev, n,
                                      gt_dev, indels, caps)
        cap = caps[1]
        return (packed[2 : 2 + count].astype(np.int64),
                packed[2 + cap : 2 + cap + count].astype(np.int32))

    def _gated_gate(self, gate, k: int):
        self._check_mesh()
        self._check_fused()
        gt = gate.t if hasattr(gate, "t") else gate
        if gt.k != k:
            raise ValueError(f"gate tables built for k={gt.k}, scan asks "
                             f"k={k}")
        self._route("gated CUDA seed scan + extension gate"
                    if self.device.type == "cuda"
                    else "gated seed scan (plain PyTorch on the CPU)")
        return self._gate_dev(gt)

    def scan_gated(self, codes: np.ndarray, gate, indels: bool, k: int):
        """One gated seed scan: (anchors [C] int64, sids [C] int32), every
        exact seed hit (anchor = seed end position, sid 0-based) that
        passes the extension gate ``gate`` (a :class:`..gate.GateTables`
        or :class:`..gate.ExtendGate`), in no order."""
        _i, anchors, sids = next(self.scan_gated_stream([codes], gate,
                                                        indels, k))
        return anchors, sids

    def scan_gated_stream(self, blocks, gate, indels: bool, k: int,
                          depth: int | None = None):
        """Pipelined :meth:`scan_gated` over an iterator of flat code
        arrays, with :meth:`scan_stream`'s transport: block i + 1 ... i +
        depth are dispatched before block i's row is read from pinned
        host memory behind its event.  Yields (block_index, anchors, sids)
        in order."""
        depth = max(int(depth or self._STREAM_DEPTH), 1)
        gt_dev = self._gated_gate(gate, k)
        pending = deque()
        for i, codes in enumerate(blocks):
            n = len(codes)
            if n == 0:
                pending.append((i, None, None, None, 0, None))
            else:
                dev = self._device_form(codes)
                caps = self._gated_caps(n)
                packed = self._gated_dispatch(dev, n, gt_dev, indels, caps)
                host, ev = self._to_host(packed)
                pending.append((i, host, ev, dev, n, caps))
            if len(pending) >= depth:
                yield self._gated_drain(pending.popleft(), gt_dev, indels)
        while pending:
            yield self._gated_drain(pending.popleft(), gt_dev, indels)

    def _gated_drain(self, item, gt_dev, indels: bool):
        i, host, ev, dev, n, caps = item
        if host is None:
            return i, np.zeros(0, np.int64), np.zeros(0, np.int32)
        if ev is not None:
            ev.synchronize()
        return (i,) + self._gated_decode(host.numpy(), dev, n, gt_dev,
                                         indels, caps)

    # -- host machine --------------------------------------------------------

    def _host_eligible(self, n: int) -> bool:
        """Route to the native shift-and machine when the scan is small
        enough that fixed device costs dominate."""
        if self.use_host is False:
            return False
        if self.use_host is None and (self.k > 4 or n > (1 << 26)):
            return False
        if os.environ.get("SAT_HOST_SCAN", "1") == "0":
            return False
        if self._host_scanner is None:
            from .host_scan import HostShiftAnd

            self._host_scanner = HostShiftAnd(
                self.tables, self.k, self.poison_eos)
        return self._host_scanner.available()

    def _radix_eligible(self) -> bool:
        """Literal (wildcard-free) patterns whose codes fit an int64
        base-alpha register (the radix census's precondition)."""
        if self._radix_ok_c is not None:
            return self._radix_ok_c
        t = self.tables
        ok = t.Lmax * np.log2(max(t.alpha, 2)) < 62
        if ok:
            cols = np.arange(t.pat_codes.shape[1])[None, :]
            live = cols < t.lengths[:, None]
            ok = not bool((np.asarray(t.pat_codes) < 0)[live].any())
        self._radix_ok_c = ok
        return ok

    # -- streaming whole arrays ----------------------------------------------

    def _stream_whole(self, codes) -> bool:
        n = len(codes)
        if n > self._RESIDENT_MAX:
            return True
        return isinstance(codes, np.memmap) and n > self._STREAM_BLOCK

    def _scan_flat_stream(self, codes):
        """Whole-array scan in streamed halo'd blocks: a window belongs to
        the block holding its start, so the rebased per-block streams
        concatenate to the global (window-start, pattern) order."""
        t = self.tables
        halo = t.Lmax - 1 + self.k
        B = self._STREAM_BLOCK
        n = len(codes)
        lengths = t.lengths
        mm = getattr(codes, "_mmap", None) \
            if getattr(codes, "offset", 1) == 0 else None

        def blocks():
            import mmap as _mmap

            drop = mm if hasattr(_mmap, "MADV_DONTNEED") else None
            pg = _mmap.PAGESIZE
            for s in range(0, n, B):
                yield np.ascontiguousarray(codes[s : s + B + halo])
                if drop is not None:
                    try:
                        lo = s // pg * pg
                        drop.madvise(_mmap.MADV_DONTNEED, lo,
                                     min(s + B + halo, n) - lo)
                    except (ValueError, OSError):
                        drop = None

        nblocks = -(-n // B)
        for i, hits in self.scan_stream(blocks(), depth=4):
            base = i * B
            for end, pid, m in hits:
                if end - int(lengths[pid]) < B:  # halo starts: next block
                    yield end + base, pid, m
            if self.progress:
                self.progress((i + 1) / nblocks)

    # -- the route ladder ----------------------------------------------------

    def scan(self, codes: np.ndarray):
        """Iterate candidate tuples over the whole array (host generator)."""
        self._check_mesh()
        if self._stream_whole(codes):
            self._route("streamed block scan (DB >> RAM)")
            yield from self._scan_flat_stream(codes)
            return
        n = len(codes)
        est = self._expected_hits(n)
        nmb = max(n // self._MB, 1)
        if self._host_eligible(n):
            self._route("native shift-and host machine "
                        "(one-shot latency path)")
            yield from self._host_scanner.scan(
                codes, cap_hint=int(est * 4) + 1024)
            if self.progress:
                self.progress(1.0)
            return
        if (self.k == 0 and n >= (1 << 18)
                and (est * 4 >= nmb or self.tables.P > self._PBLOCK)
                and self._radix_eligible()):
            raise NotImplementedError(
                "the host radix census for dense exact seeds is not ported "
                "yet (ROADMAP queue 1 item 3)")
        self._check_fused()
        self._route("fused CUDA scan pipeline"
                    if self.device.type == "cuda"
                    else "fused scan pipeline (plain PyTorch on the CPU)")
        yield from self._scan_fused(codes)
        if self.progress:
            self.progress(1.0)
