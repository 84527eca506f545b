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
2. sharded: under a mesh of more than one entry (``mesh``, attached by
   the model layer), every scan of at most ``_PBLOCK`` patterns runs the
   fused route (rung 6) per position shard
   (:func:`..parallel.shard.sharded_pallas_scan_hits`); explicit
   multi-device intent wins over the host rung, as in the JAX ladder.
   Larger pattern sets take rungs 4 and 5 unsharded on the scanner's
   device, and the route line says so;
3. host: the native shift-and machine (:class:`.host_scan.HostShiftAnd`,
   the port's copy of the JAX package's) for small scans;
4. census, for dense exact seeds and for literal pattern sets past
   ``_PBLOCK`` (k = 0, n >= 2^18): one base-alpha window code and one hash
   probe per window start and distinct pattern length, whatever the
   number of patterns.  On a CUDA device :func:`.cuda.slots.scan_slots`
   (the kernel ``seed_slots.cu``); on the CPU the native threaded
   mer-hash census (``native/shift_and.cpp::sat_mer_scan``), or, with the
   host machines off, the plain version of ``scan_slots``.  The JAX
   scanner ran this rung on the host only;
5. pattern-blocked, for pattern sets past ``_PBLOCK`` that the census
   does not take (wildcards, gapped-seed templates): one fused pass per
   ``_PBLOCK`` patterns over the same resident text, all dispatched
   before any row is fetched;
6. the fused device route for every other scan, at any length, pattern
   length and alphabet: :func:`.cuda.scan_kernel.scan_hits` (CUDA filter
   kernel, compaction, exact rescore) in one packed row per scan, with
   cap pre-sizing and an overflow retry.

The JAX scanner's other device routes (the XLA block path, the bit-plane
and seam modes for wide alphabets) are layouts for the TPU; the CUDA
filter scores any alphabet up to 256 codes and any pattern length, so the
port has this one device route and none of the knobs that chose between
routes (``use_pallas``, ``pallas_interpret``, ``block``, ``cap``).

The pigeonhole (k > 0) engines scan their exact seeds through the gated
route instead (:meth:`ConvScanner.scan_gated`, :meth:`scan_gated_stream`):
the same filter, then :func:`.cuda.seed_gate.seed_gate`, which enumerates
every seed hit in the candidate microblocks and keeps the extension gate's
survivors.  Past ``_PBLOCK`` seeds the gated route is the census and the
slot gate instead (:func:`.cuda.slots.slot_gated_hits`: ``seed_slots.cu``,
then ``gate_slots.cu`` over the slot list, which stays on the device).
Both name every seed at every start, so the JAX route's escape list
(multi-seed starts, EOS windows, slot overflows rescanned on the host) and
its chain and fold machinery have no counterpart.

Importing this module imports no torch: the host rungs (the native
shift-and machine, the native census) run without it, and the device
rungs import torch, the kernels' wrappers and the device tables when
they first run.  ``device`` is resolved then too (:class:`..device.
LazyDevice`); the host rungs never read it.
"""

from __future__ import annotations

import os
import weakref
from collections import deque
from typing import TYPE_CHECKING

import numpy as np

from ..device import LazyDevice, device_type
from .tables import GATE_ALPHA

if TYPE_CHECKING:
    import torch

    from .cuda.slots import MerTables


_DEV_CACHE: dict = {}


def device_form(codes, device: torch.device) -> torch.Tensor:
    """uint8 copy of a host code array on ``device``, cached across
    scanner instances by the array's identity and the device: engines
    rebuild scanners per run (xmers per batch, allvall per chunk), and a
    resident database must not re-pay the host->device transfer.  The
    entry drops with the host array (weakref finalizer); the copy holds
    no reference to the array, on the CPU too.  A memory-mapped or
    read-only array is copied once on the host first.  ``uploads``
    counts the copies made.

    The copy lives as long as the host array, not as long as a scanner:
    a streaming caller should not hold on to the block views it has
    scanned, or every block's copy stays resident.  ``cuda`` and
    ``cuda:<current device>`` name one entry."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (id(codes), device)
    ent = _DEV_CACHE.get(key)
    if ent is not None and ent[0]() is codes:
        return ent[1]
    arr = np.ascontiguousarray(codes, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    dev = torch.from_numpy(arr).to(device, copy=arr is codes)
    device_form.uploads += 1
    try:
        ref = weakref.ref(codes)
    except TypeError:  # an object without weak references: not cached
        return dev
    weakref.finalize(codes, _DEV_CACHE.pop, key, None)
    _DEV_CACHE[key] = (ref, dev)
    return dev


device_form.uploads = 0


def scan_hits(*args):
    """:func:`.cuda.scan_kernel.scan_hits`, the fused route's kernel and
    glue, imported at the first call (this module imports no torch)."""
    from .cuda.scan_kernel import scan_hits as fused

    return fused(*args)


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
    # a parallel.shard.Mesh attached by the model layer (auto_mesh:
    # SAT_MESH, or every GPU when more than one is visible); scans route
    # through the sharded rungs while the fused route would serve them
    mesh = None
    # tri-state: None = auto (small scans), False = never, True = whenever
    # the native machine can represent the patterns
    use_host = None
    # the torch.device of the device rungs, resolved on their first read
    device = LazyDevice()

    def __init__(self, tables, k: int = 0, poison_eos: bool | None = None,
                 device=None):
        self.tables = tables
        self.k = k
        if poison_eos is None:
            poison_eos = k > 0
        self.poison_eos = poison_eos
        self._device_arg = device
        self._dt = None
        self._host_scanner = None
        self._radix_ok_c = None
        self._routes_done = None
        self._gt_dev = None
        self._by_len_c = None
        self._mer_tables_c = None
        self._mer_dev_c = None
        self._mer_outbuf_c = None
        self._mer_gpack_c = None
        self._mer_pack_cc = None
        self._pblock_subs_c = None
        self._dt_more = None

    def _tables_dev(self):
        if self._dt is None:
            from .tables import device_tables

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

    def _sharded_capable(self) -> bool:
        """Whether the scans run per position shard: a mesh of more than
        one entry and a pattern set the fused route takes.  (The JAX
        scanner also required Lmax <= 128, a TPU envelope that the one
        device route does not have.)"""
        return (self.mesh is not None and self.mesh.size > 1
                and self.tables.P <= self._PBLOCK)

    def _unsharded(self) -> str:
        """The route line's note for a rung that runs unsharded under a
        mesh."""
        if self.mesh is None or self.mesh.size <= 1:
            return ""
        return "; unsharded on %s under a %d-entry mesh" % (
            self.device, self.mesh.size)

    def _tables_on(self, device: torch.device):
        """The device tables on ``device``: the scanner's own, or a copy
        per other device of its mesh."""
        dt = self._tables_dev()
        if dt.weights.device == device:
            return dt
        if self._dt_more is None:
            self._dt_more = {}
        if device not in self._dt_more:
            from .tables import device_tables

            self._dt_more[device] = device_tables(
                self.tables, self.k, self.poison_eos, device)
        return self._dt_more[device]

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

    def _dispatch(self, codes_dev, n: int, cap_mb: int, hit_cap: int):
        return scan_hits(codes_dev, n, self._tables_on(codes_dev.device),
                         self._eos, cap_mb, hit_cap, self._MB)

    def _decode_packed(self, packed, codes_dev, n: int, caps=None):
        """Decode a fetched packed row, retrying with larger caps on
        overflow."""
        cap_mb, hit_cap = caps or (self._cap_mb, self._hit_cap)
        mb_count, hit_count = int(packed[0]), int(packed[1])
        if mb_count > cap_mb or hit_count > hit_cap:
            yield from self._redispatch(codes_dev, n, mb_count, hit_count)
            return
        from .cuda.scan_kernel import long_form

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
        codes_dev = device_form(codes, self.device)
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
        if self._sharded_capable():
            from ..parallel.shard import sharded_scan_stream

            self._route("sharded pipelined scan stream over %d devices"
                        % self.mesh.size)
            yield from sharded_scan_stream(self, blocks, self.mesh, depth)
            return
        if self.tables.P > self._PBLOCK:
            # huge pattern sets stream block by block through the census
            # or the pattern-blocked scan (itself pipelined across passes)
            for i, codes in enumerate(blocks):
                yield i, list(self.scan(codes))
            return
        pending = deque()
        for i, codes in enumerate(blocks):
            n = len(codes)
            if n == 0:
                pending.append((i, None, None, None, 0, None))
            else:
                dev = device_form(codes, self.device)
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
        import torch

        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(packed.device))
        return host, ev

    def _drain(self, item):
        i, host, ev, dev, n, caps = item
        if host is None:
            return i, []
        if ev is not None:
            ev.synchronize()
        return i, list(self._decode_packed(host.numpy(), dev, n, caps))

    # -- the gated route (pigeonhole k > 0 engines) --------------------------

    # The fused route's candidate-microblock cap is every microblock of the
    # scan: it only sizes compact_mask's index buffer on the device (8 bytes
    # per 32 positions, never fetched), so the filter's list cannot
    # overflow and a new scanner's first scan runs once.  The slots route's
    # slot cap sizes the slot list, which stays on the device: it starts
    # from the expected seed hits on random text plus a few hits per seed.
    # The survivor cap sizes the row the host fetches: it starts small (on
    # the slots route at two survivors per seed) and an overflow retry
    # grows either cap stickily.
    _gsurv_cap = 1 << 12
    _slot_cap = 1 << 12
    _CAP_MAX = 1 << 29  # a row [count, cap, cap] keeps int32 offsets

    @staticmethod
    def _pow2(x: int) -> int:
        return 1 << (max(int(x), 1) - 1).bit_length()

    def _slot_cap_for(self, n: int) -> int:
        want = int(self._expected_hits(n) * 1.25) + 4 * self.tables.P
        self._slot_cap = min(max(self._slot_cap, self._pow2(want)),
                             self._CAP_MAX)
        return self._slot_cap

    def _slots_caps(self, n: int) -> tuple[int, int]:
        self._gsurv_cap = min(
            max(self._gsurv_cap, self._pow2(2 * self.tables.P)),
            self._CAP_MAX)
        return self._slot_cap_for(n), self._gsurv_cap

    def _gated_caps(self, n: int, slots: bool = False) -> tuple[int, int]:
        if slots:
            return self._slots_caps(n)
        return max(-(-n // self._MB), 1), self._gsurv_cap

    def census_on_device(self) -> bool:
        """Whether a census runs through :func:`.cuda.slots.scan_slots` on
        the scanner's device: always on a CUDA device, and on the CPU only
        with the host machines off (its plain version, for the tests)."""
        return (device_type(self._device_arg) == "cuda"
                or self.use_host is False
                or os.environ.get("SAT_HOST_SCAN", "1") == "0")

    def _slots_ok(self) -> bool:
        return self._radix_eligible() and self.census_on_device()

    def gate_alphabet_ok(self) -> bool:
        """Whether the extension gate's tables (:class:`..gate.GateTables`)
        can hold this alphabet: fewer than ``GATE_ALPHA`` codes."""
        return self.tables.alpha < GATE_ALPHA

    def gated_available(self, n: int) -> bool:
        """Whether :meth:`scan_gated` takes a seed scan of ``n``
        positions: every scan over a resident array that the host rung
        does not take (under a mesh the sharded route takes it instead),
        of at most ``_PBLOCK`` seeds (the fused route) or of more literal
        seeds on a device census (the slots route), over an alphabet the
        gate tables hold."""
        host = not self._sharded_capable() and self._host_eligible(n)
        return (n <= self._RESIDENT_MAX and self.gate_alphabet_ok()
                and not host
                and (self.tables.P <= self._PBLOCK or self._slots_ok()))

    def _gate_on(self, gt, device: torch.device):
        """``gt`` on ``device``, kept for the last gate seen (one copy
        per device of the mesh)."""
        if self._gt_dev is None or self._gt_dev[0] is not gt:
            self._gt_dev = (gt, {})
        per = self._gt_dev[1]
        if device not in per:
            per[device] = gt.to(device)
        return per[device]

    def _gate_dev(self, gt):
        """``gt`` on the scanner's device."""
        return self._gate_on(gt, self.device)

    def _gated_dispatch(self, codes_dev, n: int, gt, indels: bool,
                        caps, slots: bool):
        gt_dev = self._gate_on(gt, codes_dev.device)
        if slots:
            from .cuda.slots import slot_gated_hits

            return slot_gated_hits(codes_dev, n, self._mer_dev(), gt_dev,
                                   indels, *caps)
        from .cuda.seed_gate import gated_hits

        return gated_hits(codes_dev, n, self._tables_on(codes_dev.device),
                          gt_dev, self._eos, indels, *caps)

    def _gated_decode(self, packed, codes_dev, n: int, gt, indels: bool,
                      caps, slots: bool):
        """(anchors int64, sids int32) from a fetched gated row, retrying
        with the overflowed cap grown past its true count."""
        first, count = int(packed[0]), int(packed[1])
        if first > caps[0] or count > caps[1]:
            if max(first, count) > self._CAP_MAX or min(first, count) < 0:
                raise RuntimeError(
                    f"gated scan: {first} seed hits, {count} survivors "
                    f"exceed one row ({self._CAP_MAX}); scan in blocks")
            if slots:
                self._slot_cap = max(self._slot_cap, self._pow2(first))
            self._gsurv_cap = max(self._gsurv_cap, self._pow2(count))
            caps = self._gated_caps(n, slots)
            packed = self._gated_dispatch(codes_dev, n, gt, indels, caps,
                                          slots)
            return self._gated_decode(packed.cpu().numpy(), codes_dev, n,
                                      gt, indels, caps, slots)
        cap = caps[1]
        return (packed[2 : 2 + count].astype(np.int64),
                packed[2 + cap : 2 + cap + count].astype(np.int32))

    def _gated_gate(self, gate, k: int, slots: bool):
        """The gate's :class:`..gate.GateTables`, checked against the scan
        and its route named."""
        gt = gate.t if hasattr(gate, "t") else gate
        if gt.k != k:
            raise ValueError(f"gate tables built for k={gt.k}, scan asks "
                             f"k={k}")
        if slots and not self._slots_ok():
            raise ValueError(
                "gated scan of %d seeds (> %d) needs literal seeds and a "
                "device census: ask gated_available first"
                % (self.tables.P, self._PBLOCK))
        on = "plain PyTorch, CPU"
        if self.device.type == "cuda":
            on = ("CUDA: seed_slots.cu + gate_slots.cu" if slots
                  else "CUDA: scan_filter.cu + seed_gate.cu")
        if self._sharded_capable():
            self._route("gated seed scan + extension gate (%s) sharded over "
                        "%d devices" % (on, self.mesh.size))
        else:
            self._route(("gated seed census + slot gate (%d seeds; %s%s)"
                         % (self.tables.P, on, self._unsharded())) if slots
                        else "gated seed scan + extension gate (%s)" % on)
        return gt

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
        host memory behind its event.  At most ``_PBLOCK`` seeds take the
        fused route (filter, ``seed_gate``), more take the slots route
        (``scan_slots``, ``gate_slots``).  Yields (block_index, anchors,
        sids) in order.  Under a mesh the fused route runs per position
        shard (:func:`..parallel.shard.sharded_gated_stream`)."""
        if self._sharded_capable():
            from ..parallel.shard import sharded_gated_stream

            return sharded_gated_stream(self, blocks, gate, indels, k,
                                        self.mesh,
                                        depth or self._STREAM_DEPTH)
        return self._gated_stream(blocks, gate, indels, k, depth,
                                  self.tables.P > self._PBLOCK)

    def _gated_stream(self, blocks, gate, indels: bool, k: int, depth,
                      slots: bool):
        depth = max(int(depth or self._STREAM_DEPTH), 1)
        gt = self._gated_gate(gate, k, slots)
        pending = deque()
        for i, codes in enumerate(blocks):
            n = len(codes)
            if n == 0:
                pending.append((i, None, None, None, 0, None))
            else:
                dev = device_form(codes, self.device)
                caps = self._gated_caps(n, slots)
                packed = self._gated_dispatch(dev, n, gt, indels, caps,
                                              slots)
                host, ev = self._to_host(packed)
                pending.append((i, host, ev, dev, n, caps))
            if len(pending) >= depth:
                yield self._gated_drain(pending.popleft(), gt, indels,
                                        slots)
        while pending:
            yield self._gated_drain(pending.popleft(), gt, indels, slots)

    def _gated_drain(self, item, gt, indels: bool, slots: bool):
        i, host, ev, dev, n, caps = item
        if host is None:
            return i, np.zeros(0, np.int64), np.zeros(0, np.int32)
        if ev is not None:
            ev.synchronize()
        return (i,) + self._gated_decode(host.numpy(), dev, n, gt,
                                         indels, caps, slots)

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

    # -- the census (dense exact seeds, huge literal pattern sets) -----------

    def _census_eligible(self, n: int) -> bool:
        """The census rung's routing test: an exact scan of at least 2^18
        positions whose seeds are dense (the two-level filter would fire
        on nearly every microblock) or number more than ``_PBLOCK``, over
        literal patterns."""
        est = self._expected_hits(n)
        nmb = max(n // self._MB, 1)
        return (self.k == 0 and n >= (1 << 18)
                and (est * 4 >= nmb or self.tables.P > self._PBLOCK)
                and self._radix_eligible())

    def _by_len(self):
        """{length: [(code, pid0)]}: the base-alpha code of every pattern,
        by pattern length, built once per scanner."""
        if self._by_len_c is None:
            t = self.tables
            alpha = t.alpha
            by_len: dict[int, list] = {}
            lens = t.lengths.astype(np.int64)
            pc = np.asarray(t.pat_codes, np.int64)
            for L in np.unique(lens):
                L = int(L)
                sel = np.flatnonzero(lens == L)
                codes_L = np.zeros(len(sel), np.int64)
                for j in range(L):
                    codes_L = codes_L * alpha + pc[sel, j]
                by_len[L] = list(zip(codes_L.tolist(), sel.tolist()))
            self._by_len_c = by_len
        return self._by_len_c

    def _mer_tables(self):
        """{length: (keys, head, enext, epid, tsize, bloom, bloom_bits,
        head4, enext4, bit4)}: one open-addressing hash table per pattern
        length (4x load-factor headroom, duplicate codes chained), built
        once per scanner.  The native census and the device census
        (:class:`.cuda.slots.MerTables`) probe the same tables; the bloom
        prefilter and the direct-address sidecar serve the native one."""
        if self._mer_tables_c is not None:
            return self._mer_tables_c
        t = self.tables
        tabs = {}
        for L, entries in self._by_len().items():
            P_L = len(entries)
            tsize = 1 << max(int(np.ceil(np.log2(4 * P_L + 1))), 4)
            keys = np.full(tsize, ~np.uint64(0), np.uint64)
            head = np.full(tsize, -1, np.int32)
            enext = np.full(P_L, -1, np.int32)
            epid = np.zeros(P_L, np.int32)
            GOLD = 0x9E3779B97F4A7C15
            U64 = (1 << 64) - 1
            mask = tsize - 1
            # bloom prefilter sized to the pattern count: about 2^5 bits
            # per key keep its false positives near 3% while it stays
            # cache-resident
            bloom_bits = min(max(19, P_L.bit_length() + 5), 26)
            bloom = np.zeros(1 << (bloom_bits - 6), np.uint64)
            GOLD2 = 0xC2B2AE3D27D4EB4F
            bshift = 64 - bloom_bits
            for e, (c, pi) in enumerate(entries):
                epid[e] = pi
                b = ((c * GOLD2) & U64) >> bshift
                bloom[b >> 6] |= np.uint64(1 << (b & 63))
                slot = (((c * GOLD) & U64) >> 32) & mask
                while keys[slot] != ~np.uint64(0) \
                        and keys[slot] != np.uint64(c):
                    slot = (slot + 1) & mask
                if keys[slot] == ~np.uint64(0):
                    keys[slot] = np.uint64(c)
                    head[slot] = e
                else:  # duplicate code: push onto the chain
                    enext[e] = head[slot]
                    head[slot] = e
            # direct-address sidecar for base-4 (DNA) classes with
            # 2L <= 22 index bits: head4[code4] replaces the bloom test,
            # the key compare and the open-addressing walk
            # (shift_and.cpp::mer_scan_range_d4)
            head4 = enext4 = bit4 = None
            if 2 * L <= 22 and P_L:
                pids_L = np.fromiter((pi for _, pi in entries), np.int64,
                                     P_L)
                dig = np.asarray(t.pat_codes, np.int64)[pids_L, :L]
                if (dig >= 0).all() and (dig < 4).all():
                    code4 = np.zeros(P_L, np.int64)
                    for j in range(L):
                        code4 = (code4 << 2) | dig[:, j]
                    head4 = np.full(1 << (2 * L), -1, np.int32)
                    enext4 = np.full(P_L, -1, np.int32)
                    for e, c4 in enumerate(code4.tolist()):
                        enext4[e] = head4[c4]
                        head4[c4] = e
                    # exact presence bitmap (4^L bits): the sweep tests
                    # it instead of touching the head table per position
                    packed = np.packbits(head4 >= 0, bitorder="little")
                    if len(packed) % 8:
                        packed = np.concatenate(
                            [packed, np.zeros(8 - len(packed) % 8,
                                              np.uint8)])
                    bit4 = np.ascontiguousarray(packed).view(np.uint64)
            tabs[L] = (keys, head, enext, epid, tsize, bloom, bloom_bits,
                       head4, enext4, bit4)
        self._mer_tables_c = tabs
        return tabs

    def _mer_dev(self) -> MerTables:
        """The census tables on the scanner's device, built once."""
        if self._mer_dev_c is None:
            from .cuda.slots import MerTables

            self._mer_dev_c = MerTables(
                self._mer_tables(), self._by_len(), self.tables.lengths,
                self.tables.alpha).to(self.device)
        return self._mer_dev_c

    def _mer_native(self, codes: np.ndarray, n: int, sort: bool = True,
                    gate=None):
        """(ends, pids0) arrays through the native threaded mer-hash scan
        (``native/shift_and.cpp::sat_mer_scan``), or None when the library
        is unavailable.  ``gate`` is the optional inline prefix extension
        gate (``mer_gate_pass``): per pattern (dir, prefix codes, len), and
        (G, k, band), a superset filter evaluated on the scan threads."""
        import ctypes

        from ..native import load_shift_and_lib

        lib = load_shift_and_lib()
        if lib is None or not hasattr(lib, "sat_mer_scan"):
            return None
        t = self.tables
        tabs = self._mer_tables()
        codes8 = np.ascontiguousarray(np.asarray(codes, np.uint8))
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_u64p = ctypes.POINTER(ctypes.c_uint64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i8p = ctypes.POINTER(ctypes.c_int8)
        if gate is not None:
            gdir, gpref, gglen, gG, gk, gband = gate
            # the per-pattern gate metadata in ONE uint64 per pattern when
            # it fits (G <= 6, so k <= 2): one cache line per gated
            # candidate instead of three
            # (shift_and.cpp::mer_gate_pass_packed)
            gpack = None
            if gG <= 6:
                cached = self._mer_gpack_c
                if cached is not None and cached[0] is gdir:
                    gpack = cached[1]
                else:
                    d64 = np.where(gdir > 0, 1,
                                   np.where(gdir < 0, 2, 0)).astype(
                                       np.uint64)
                    g64 = d64 | (gglen.astype(np.uint64) << np.uint64(2))
                    pref = gpref.reshape(-1, gG).astype(np.uint64)
                    for j in range(gG):
                        g64 |= pref[:, j] << np.uint64(16 + 8 * j)
                    gpack = np.ascontiguousarray(g64)
                    self._mer_gpack_c = (gdir, gpack)
            gate_args = (gdir.ctypes.data_as(c_i8p),
                         gpref.ctypes.data_as(c_u8p),
                         gglen.ctypes.data_as(c_u8p), gG, gk, gband,
                         gpack.ctypes.data_as(c_u64p)
                         if gpack is not None else None)
        else:
            gate_args = (None, None, None, 0, 0, 0, None)
        d4fn = getattr(lib, "sat_mer_scan_d4", None)
        all_s, all_p = [], []
        for L, (keys, head, enext, epid, tsize, bloom,
                bloom_bits, head4, enext4, bit4) in tabs.items():
            if n < L:
                continue
            # direct-address walk when the class has a base-4 table and
            # the gate (if any) rides the packed record
            use_d4 = (d4fn is not None and head4 is not None
                      and (gate is None or gate_args[6] is not None))
            if use_d4:
                pack, bad = self._mer_pack(codes8, n)
            cap = max(4 * len(epid) + (n >> 6), 1 << 14)
            while True:
                # reused across scans (a fresh pair costs page faults)
                buf = self._mer_outbuf_c
                if buf is None or len(buf[0]) < cap:
                    buf = (np.empty(cap, np.int64), np.empty(cap, np.int32))
                    self._mer_outbuf_c = buf
                out_s, out_p = buf
                if use_d4:
                    total = d4fn(
                        codes8.ctypes.data_as(c_u8p),
                        pack.ctypes.data_as(c_u8p),
                        bad.ctypes.data_as(c_i64p), len(bad), n, L,
                        head4.ctypes.data_as(c_i32p),
                        enext4.ctypes.data_as(c_i32p),
                        epid.ctypes.data_as(c_i32p),
                        bit4.ctypes.data_as(c_u64p),
                        gate_args[4], gate_args[5], gate_args[6], 0,
                        out_s.ctypes.data_as(c_i64p),
                        out_p.ctypes.data_as(c_i32p), cap)
                else:
                    total = lib.sat_mer_scan(
                        codes8.ctypes.data_as(c_u8p), n, L, t.alpha,
                        keys.ctypes.data_as(c_u64p),
                        head.ctypes.data_as(c_i32p),
                        enext.ctypes.data_as(c_i32p),
                        epid.ctypes.data_as(c_i32p), tsize,
                        bloom.ctypes.data_as(c_u64p), bloom_bits,
                        *gate_args, 0,
                        out_s.ctypes.data_as(c_i64p),
                        out_p.ctypes.data_as(c_i32p), cap)
                if total < 0:
                    return None
                if total <= cap:
                    break
                cap = 1 << (int(total) - 1).bit_length()
            # copy out of the reused buffer: the next length class's
            # native call overwrites it
            all_s.append(out_s[: int(total)].copy())
            all_p.append(out_p[: int(total)].astype(np.int64))
        if not all_s:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        starts = np.concatenate(all_s)
        pids = np.concatenate(all_p)
        if sort:
            order = np.lexsort((pids, starts))
            starts, pids = starts[order], pids[order]
        ends = starts + t.lengths[pids].astype(np.int64)
        return ends, pids

    def _mer_pack(self, codes8, n):
        """(pack, bad) for the direct-address census walk: the 2-bit
        MSB-first packed text (padded so the native 8-byte loads never run
        off the end) and the sorted positions of codes >= 4 (EOS and
        ambiguity codes, which base-4 masking would alias).  Kept for the
        last array OBJECT seen (a fresh array may reuse a freed buffer's
        address)."""
        cached = self._mer_pack_cc
        if cached is not None and cached[0] is codes8 and cached[1] == n:
            return cached[2], cached[3]
        m = (n + 3) // 4
        padded = np.zeros(4 * m, np.uint8)
        padded[:n] = codes8[:n]
        q = (padded & 3).reshape(m, 4)
        pack = np.concatenate([
            (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3],
            np.zeros(16, np.uint8)])
        pack = np.ascontiguousarray(pack)
        bad = np.flatnonzero(codes8[:n] >= 4).astype(np.int64)
        self._mer_pack_cc = (codes8, n, pack, bad)
        return pack, bad

    def _census_device(self, codes, n: int, sort: bool):
        """(ends, pids0) int64 arrays of every exact hit through
        :func:`.cuda.slots.scan_slots` on the scanner's device.  The true
        count comes back first; an overflow is one re-launch with a cap
        past it.  Only the live part of the row is fetched."""
        from .cuda.slots import scan_slots

        dev = device_form(codes, self.device)
        mt = self._mer_dev()
        while True:
            cap = self._slot_cap_for(n)
            row = scan_slots(dev, n, mt, cap)
            count = int(row[0])
            if not 0 <= count <= self._CAP_MAX:
                raise RuntimeError(f"census: {count} hits exceed one row "
                                   f"({self._CAP_MAX}); scan in blocks")
            if count <= cap:
                break
            self._slot_cap = self._pow2(count)
        starts = row[1 : 1 + count].cpu().numpy().astype(np.int64)
        pids = row[1 + cap : 1 + cap + count].cpu().numpy().astype(np.int64)
        if sort:
            order = np.lexsort((pids, starts))
            starts, pids = starts[order], pids[order]
        return starts + self.tables.lengths[pids].astype(np.int64), pids

    def _scan_radix_arrays(self, codes, n: int, sort: bool = True,
                           gate=None):
        """(ends, pids0) int64 arrays of every exact hit, in (window-start,
        pattern) order unless ``sort`` is False: the device census, or on
        the CPU the native census (with its inline ``gate``), or numpy."""
        t = self.tables
        if self.census_on_device():
            self._route("census kernel (%d patterns; %s%s)" % (
                t.P, "CUDA: seed_slots.cu" if self.device.type == "cuda"
                else "plain PyTorch, CPU", self._unsharded()))
            return self._census_device(codes, n, sort)
        native = self._mer_native(codes, n, sort=sort, gate=gate)
        if native is not None:
            self._route("native threaded mer-hash census "
                        "(%d patterns%s)" % (t.P, self._unsharded()))
            return native
        self._route("host radix-code census (numpy)")
        cN = np.asarray(codes).astype(np.int64)
        all_starts, all_pids = [], []
        for L, entries in self._by_len().items():
            if n < L:
                continue
            ids = cN[: n - L + 1].copy()
            for j in range(1, L):
                ids *= t.alpha
                ids += cN[j : j + n - L + 1]
            entries = sorted(entries)
            scodes = np.fromiter((c for c, _ in entries), np.int64,
                                 len(entries))
            spids = np.fromiter((p for _, p in entries), np.int64,
                                len(entries))
            uniq, first = np.unique(scodes, return_index=True)
            pos = np.minimum(np.searchsorted(uniq, ids), len(uniq) - 1)
            starts = np.nonzero(uniq[pos] == ids)[0]
            ci = pos[starts]
            # one emission per matching pattern: identical patterns fan out
            counts = np.diff(np.append(first, len(scodes)))
            for rep in range(int(counts.max(initial=1))):
                sel = counts[ci] > rep
                if not sel.any():
                    break
                all_starts.append(starts[sel])
                all_pids.append(spids[first[ci[sel]] + rep])
        if not all_starts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        starts = np.concatenate(all_starts)
        pids = np.concatenate(all_pids)
        order = np.lexsort((pids, starts))
        starts, pids = starts[order], pids[order]
        return starts + t.lengths[pids].astype(np.int64), pids

    def _scan_radix(self, codes: np.ndarray):
        """The census as a candidate stream, in (window-start, pattern)
        order."""
        ends, pids = self._scan_radix_arrays(codes, len(codes))
        e_l = ends.tolist()
        yield from zip(e_l, pids.tolist(), [0] * len(e_l))

    def census_serves(self, codes) -> bool:
        """Whether the census rung of :meth:`scan` serves this scan (what
        :meth:`scan_seed_arrays` answers for): a resident array that the
        host rung does not take, and the census's routing test."""
        n = len(codes)
        return (not self._stream_whole(codes) and not self._host_eligible(n)
                and self._census_eligible(n))

    def scan_seed_arrays(self, codes: np.ndarray, sort: bool = True,
                         gate=None, ext_gate=None):
        """(ends, pids0) int64 arrays when the census serves this scan
        (the routing test of :meth:`scan`'s census rung); None otherwise,
        and callers iterate :meth:`scan`.  Skips the per-hit tuple stream.

        A gate drops hits whose extension cannot succeed (a superset
        filter; ``sort`` then orders what is left).  Each route takes its
        own: the native census the inline prefix gate ``gate`` (the spec
        of ``PrimerMatchModel._census_gate``), the device census
        ``ext_gate`` (an :class:`..gate.ExtendGate`), run by
        ``gate_slots`` over the slot list on the device before anything is
        fetched."""
        if not self.census_serves(codes):
            return None
        n = len(codes)
        if (ext_gate is not None and self.census_on_device()
                and self.gate_alphabet_ok()):
            _i, ends, pids = next(self._gated_stream(
                [codes], ext_gate, ext_gate.indels, ext_gate.t.k, 1, True))
            pids = pids.astype(np.int64)
            if sort:
                starts = ends - self.tables.lengths[pids]
                order = np.lexsort((pids, starts))
                ends, pids = ends[order], pids[order]
            return ends, pids
        return self._scan_radix_arrays(codes, n, sort=sort, gate=gate)

    # -- pattern-blocked outer loop (P > _PBLOCK) ----------------------------

    def _pblock_subs(self):
        """Sub-scanners over table slices of at most ``_PBLOCK`` patterns,
        built once per scanner (their converged caps persist)."""
        if self._pblock_subs_c is None:
            from .tables import PatternTables

            t = self.tables
            subs = []
            for off in range(0, t.P, self._PBLOCK):
                sl = slice(off, min(off + self._PBLOCK, t.P))
                st = PatternTables(
                    match=t.match[sl], lengths=t.lengths[sl],
                    pat_codes=t.pat_codes[sl], Lmax=t.Lmax,
                    alpha=t.alpha, eos_code=t.eos_code,
                    code_chars=t.code_chars,
                )
                sub = ConvScanner(st, k=self.k, poison_eos=self.poison_eos,
                                  device=self.device)
                sub.use_host = False
                subs.append((off, sub))
            self._pblock_subs_c = subs
        return self._pblock_subs_c

    def _scan_pblocked(self, codes: np.ndarray):
        """Pattern-blocked fused scan: ALL passes are dispatched before any
        row is fetched (the device queues them back to back and each row's
        copy to pinned memory runs behind its pass), then the hits merge
        to the global (window-start, pattern) order."""
        codes_dev = device_form(codes, self.device)
        n = len(codes)
        pending = []
        for off, sub in self._pblock_subs():
            caps = sub._presize(n)
            host, ev = self._to_host(sub._dispatch(codes_dev, n, *caps))
            pending.append((off, sub, host, ev, caps))
        out = []
        for off, sub, host, ev, caps in pending:
            if ev is not None:
                ev.synchronize()
            lens = sub.tables.lengths
            for end, p0, m in sub._decode_packed(host.numpy(), codes_dev, n,
                                                 caps):
                out.append((end - int(lens[p0]), off + p0, end, m))
        out.sort()
        for _start, pid, end, m in out:
            yield end, pid, m

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
        if self._stream_whole(codes):
            self._route(
                "streamed block scan (DB >> RAM)"
                + (", sharded over %d devices" % self.mesh.size
                   if self._sharded_capable() else ""))
            yield from self._scan_flat_stream(codes)
            return
        if self._sharded_capable():
            # explicit multi-device intent wins over the host rung: every
            # shard runs the fused route
            from ..parallel.shard import sharded_pallas_scan_hits

            self._route("fused %s scan pipeline sharded over %d devices"
                        % ("CUDA (scan_filter.cu)"
                           if self.device.type == "cuda"
                           else "plain PyTorch", self.mesh.size))
            yield from sharded_pallas_scan_hits(self, codes, self.mesh)
            if self.progress:
                self.progress(1.0)
            return
        n = len(codes)
        est = self._expected_hits(n)
        if self._host_eligible(n):
            self._route("native shift-and host machine "
                        "(one-shot latency path%s)" % self._unsharded())
            yield from self._host_scanner.scan(
                codes, cap_hint=int(est * 4) + 1024)
            if self.progress:
                self.progress(1.0)
            return
        if self._census_eligible(n):
            # dense exact seeds (the pigeonhole and hash engines) fire on
            # nearly every microblock, which degenerates the two-level
            # filter, and past _PBLOCK patterns the filter costs a pass
            # per block: one code and one probe per start beat both
            yield from self._scan_radix(codes)
            if self.progress:
                self.progress(1.0)
            return
        if self.tables.P > self._PBLOCK:
            self._route("pattern-blocked scan pipeline (%d patterns, %d "
                        "blocks%s)" % (self.tables.P,
                                       -(-self.tables.P // self._PBLOCK),
                                       self._unsharded()))
            yield from self._scan_pblocked(codes)
            if self.progress:
                self.progress(1.0)
            return
        self._route("fused CUDA scan pipeline (scan_filter.cu)"
                    if self.device.type == "cuda"
                    else "fused scan pipeline (plain PyTorch on the CPU)")
        yield from self._scan_fused(codes)
        if self.progress:
            self.progress(1.0)
