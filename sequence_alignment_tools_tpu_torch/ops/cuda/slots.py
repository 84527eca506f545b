"""The unfused seed pipeline of the many-pattern path: seed slots, then
the slot gate.

Counterparts of ``pallas_scan_slots`` and ``pallas_gate_slots`` in
``sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py``, held to their
outputs where the scanner consumes them, not to the TPU's slot layout:

- :func:`scan_slots` finds every exact hit of a literal seed set of any
  size: the device census.  A window start costs one rolled base-alpha
  code per distinct seed length, a test of a presence filter and, where
  that passes, one hash probe (:class:`MerTables`), whatever the number
  of seeds.  On a CUDA tensor it launches the hand-written kernel
  ``csrc/seed_slots.cu``; on a CPU tensor it runs :func:`scan_slots_ref`,
  the plain PyTorch version.
- :func:`gate_slots` keeps the slots whose extension gate passes
  (``csrc/gate_slots.cu``; :func:`gate_slots_ref` on a CPU tensor) and
  returns the row :func:`.seed_gate.seed_gate` returns.
- :func:`slot_gated_hits` is the pipeline of the two, in one packed row.

Both rows are ``[count, column (cap), column (cap)]`` int32 with the true
count kept, entries in no order, and no escapes: every seed of every
start is named.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..gate import gate_ok_ref
from .seed_gate import MAX_BAND

# the most distinct seed lengths one launch takes (the kernel keeps the
# class table in shared memory)
MAX_CLASSES = 64
_REF_CHUNK = 1 << 22
# the census tables' hash multiplier (conv_scan.py::_mer_tables)
GOLD = 0x9E3779B97F4A7C15
# the presence filter: about 16 bits a key, 2^10 to 2^20 bits (at most
# 128 KB of the kernel's shared memory)
_FILTER_BITS = (10, 20)
# accept words of the first rows in a seed's gate record (gate_slots.cu)
REC_ROWS = 5
_REC_CACHE: dict = {}


def presence_filter(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """The census kernel's presence filter of the table keys ``keys``
    (uint64 codes): ``(words, fbits)``, ``words`` int32 [2^fbits / 32]
    with bits ``h >> (64 - fbits)`` and ``(h >> (64 - 2 fbits)) mod
    2^fbits`` set for ``h = key * GOLD mod 2^64`` of every key, so no key
    is ever filtered out."""
    keys = np.asarray(keys, np.uint64)
    fbits = int(np.clip(int(16 * len(keys)).bit_length(), *_FILTER_BITS))
    h = keys * np.uint64(GOLD)
    bits = np.zeros(1 << fbits, bool)
    bits[(h >> np.uint64(64 - fbits)).astype(np.int64)] = True
    bits[((h >> np.uint64(64 - 2 * fbits))
          & np.uint64((1 << fbits) - 1)).astype(np.int64)] = True
    words = np.packbits(bits, bitorder="little").view("<u4")
    return words.astype(np.uint32).view(np.int32), fbits


class MerTables:
    """The seed set of a census as per-length hash tables.

    Built from the host tables of ``ConvScanner._mer_tables`` (one
    open-addressing table per distinct seed length L: ``keys`` uint64 with
    all ones for an empty slot, ``head`` the first entry of a key's chain,
    ``enext`` the chain, ``epid`` the 0-based seed id of an entry) and the
    entries' codes (``ConvScanner._by_len``: per L the (base-alpha code,
    seed id) of every entry), concatenated in ascending L with the entry
    indices rebased:

    - ``cls`` [C, 3] int64: (L, table size - 1, slot offset);
    - ``keys`` [sum of sizes] int64 (the uint64 bit patterns), ``head``
      [same] int32, ``enext`` [P] int32, ``epid`` [P] int32;
    - ``lengths`` [P] int32, the seed lengths by seed id;
    - ``filt`` [2^fbits / 32] int32, the kernel's presence filter of every
      key (:func:`presence_filter`), and ``fbits``;
    - for the plain version, per class the sorted distinct codes
      ``ukeys``, their chain bounds ``ufirst`` into ``spid``, the seed ids
      sorted by (code, id).

    All tensors lie on one device (:meth:`to` moves them)."""

    def __init__(self, host_tabs: dict, by_len: dict, lengths: np.ndarray,
                 alpha: int):
        if not host_tabs or len(host_tabs) > MAX_CLASSES:
            raise ValueError(f"{len(host_tabs)} seed lengths: the census "
                             f"takes 1 to {MAX_CLASSES}")
        self.alpha = int(alpha)
        self.lens = sorted(int(L) for L in host_tabs)
        self.Lmax = self.lens[-1]
        cls, keys, head, enext, epid, plain = [], [], [], [], [], []
        slot_off = ent_off = 0
        for L in self.lens:
            k_L, h_L, n_L, p_L, tsize = host_tabs[L][:5]
            cls.append((L, tsize - 1, slot_off))
            keys.append(np.asarray(k_L, np.uint64).view(np.int64))
            head.append(np.where(h_L >= 0, h_L + ent_off, -1))
            enext.append(np.where(n_L >= 0, n_L + ent_off, -1))
            epid.append(np.asarray(p_L))
            code_of = np.fromiter((c for c, _ in by_len[L]), np.int64,
                                  len(p_L))
            order = np.lexsort((p_L, code_of))
            ukeys, first = np.unique(code_of[order], return_index=True)
            plain.append((
                torch.from_numpy(ukeys.astype(np.int64)),
                torch.from_numpy(np.append(first, len(p_L)).astype(np.int64)),
                torch.from_numpy(np.asarray(p_L)[order].astype(np.int64))))
            slot_off += tsize
            ent_off += len(p_L)
        self.P = ent_off
        self.cls = torch.tensor(cls, dtype=torch.int64)
        self.keys = torch.from_numpy(np.concatenate(keys))
        self.head = torch.from_numpy(np.concatenate(head).astype(np.int32))
        self.enext = torch.from_numpy(np.concatenate(enext).astype(np.int32))
        self.epid = torch.from_numpy(np.concatenate(epid).astype(np.int32))
        self.lengths = torch.from_numpy(np.asarray(lengths, np.int32).copy())
        keys_u = self.keys.numpy().view(np.uint64)
        filt, self.fbits = presence_filter(keys_u[keys_u != ~np.uint64(0)])
        self.filt = torch.from_numpy(filt)
        self.plain = plain

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def to(self, device) -> MerTables:
        """A copy whose tensors lie on ``device``."""
        out = object.__new__(MerTables)
        out.__dict__.update(self.__dict__)
        for name in ("cls", "keys", "head", "enext", "epid", "lengths",
                     "filt"):
            setattr(out, name, getattr(self, name).to(device))
        out.plain = [tuple(t.to(device) for t in c) for c in self.plain]
        return out


def _row(first: torch.Tensor, second: torch.Tensor, cap: int) -> torch.Tensor:
    """``[count, first (cap), second (cap)]`` int32 from two equal-length
    columns: the true count, and the first ``cap`` entries."""
    count = first.numel()
    keep = min(count, cap)
    row = torch.zeros(1 + 2 * cap, dtype=torch.int32, device=first.device)
    row[0] = count
    row[1 : 1 + keep] = first[:keep].to(torch.int32)
    row[1 + cap : 1 + cap + keep] = second[:keep].to(torch.int32)
    return row


def scan_slots_ref(codes: torch.Tensor, n: int, mt: MerTables,
                   cap: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scan_slots`.

    The row ``[count, starts (cap), sids (cap)]`` int32 holds every pair
    (window start t, 0-based seed id s) such that seed s equals
    ``codes[t : t + len[s]]`` and ``t + len[s] <= n``; ``count`` is the
    true number of pairs, of which the first ``cap`` are kept.  Here they
    come by length class, then (t, s); the kernel's order is free.  Per
    class the window codes are rolled in int64 and looked up in the
    class's sorted distinct seed codes."""
    dev = codes.device
    found_t, found_s = [], []
    for L, (ukeys, ufirst, spid) in zip(mt.lens, mt.plain):
        for c0 in range(0, n - L + 1, _REF_CHUNK):
            m = min(_REF_CHUNK, n - L + 1 - c0)
            c = codes[c0 : c0 + m + L - 1].long()
            ids = c[:m].clone()
            for j in range(1, L):
                ids = ids * mt.alpha + c[j : j + m]
            pos = torch.searchsorted(ukeys, ids).clamp(max=ukeys.numel() - 1)
            local = torch.nonzero(ukeys[pos] == ids).reshape(-1)
            ci = pos[local]
            reps = ufirst[ci + 1] - ufirst[ci]
            total = int(reps.sum())
            ends = torch.cumsum(reps, 0)
            within = torch.arange(total, device=dev) - torch.repeat_interleave(
                ends - reps, reps)
            found_t.append(torch.repeat_interleave(local, reps) + c0)
            found_s.append(
                spid[torch.repeat_interleave(ufirst[ci], reps) + within])
    empty = torch.zeros(0, dtype=torch.long, device=dev)
    return _row(torch.cat(found_t) if found_t else empty,
                torch.cat(found_s) if found_s else empty, cap)


def _check_common(name: str, codes: torch.Tensor, n: int, cap: int,
                  Lmax: int, tensors: dict) -> None:
    for label, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got {t.dtype}")
        if t.device != codes.device:
            raise ValueError(f"{name}: {label} lies on {t.device}, the "
                             f"codes on {codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if codes.dim() != 1 or codes.numel() < n or n < 1:
        raise ValueError(f"{name}: codes {tuple(codes.shape)} shorter than "
                         f"n {n}, or n < 1")
    if cap < 1 or 1 + 2 * cap >= 1 << 31 or n + Lmax >= 1 << 31:
        raise ValueError(f"{name}: cap {cap} outside [1, 2^30), or n {n} "
                         "past int32 positions")


def scan_slots(codes: torch.Tensor, n: int, mt: MerTables,
               cap: int) -> torch.Tensor:
    """Every exact hit of the seed set ``mt`` in ``codes[:n]`` (see
    :func:`scan_slots_ref`): the int32 row ``[count, starts (cap), sids
    (cap)]``, hits in no order, the true count kept.

    ``codes`` uint8 [>= n]; ``mt`` a :class:`MerTables` on the same
    device.  On a CUDA tensor this launches ``csrc/seed_slots.cu`` on the
    current stream and counts the launch in ``scan_slots.launches``; on a
    CPU tensor it is :func:`scan_slots_ref`."""
    if codes.device.type == "cpu":
        return scan_slots_ref(codes, n, mt, cap)
    if codes.device.type != "cuda":
        raise ValueError(f"scan_slots: unsupported device {codes.device}")
    _check_common("scan_slots", codes, n, cap, mt.Lmax, {
        "codes": (codes, torch.uint8), "cls": (mt.cls, torch.int64),
        "keys": (mt.keys, torch.int64), "head": (mt.head, torch.int32),
        "enext": (mt.enext, torch.int32), "epid": (mt.epid, torch.int32),
        "filt": (mt.filt, torch.int32)})
    if mt.head.shape != mt.keys.shape or mt.enext.shape != mt.epid.shape:
        raise ValueError("scan_slots: table shapes disagree")
    from . import build

    lib = build.library("seed_slots")
    out = torch.empty(1 + 2 * cap, dtype=torch.int32, device=codes.device)
    out[0] = 0
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.sat_seed_slots(
            codes.data_ptr(), n, mt.alpha, mt.cls.data_ptr(), len(mt.lens),
            mt.Lmax, mt.keys.data_ptr(), mt.head.data_ptr(),
            mt.enext.data_ptr(), mt.epid.data_ptr(), mt.filt.data_ptr(),
            mt.fbits, out.data_ptr(), cap, stream)
    if rc != 0:
        raise RuntimeError(f"seed_slots launch failed: cudaError_t {rc}")
    scan_slots.launches += 1
    return out


scan_slots.launches = 0


def gate_slots_ref(codes: torch.Tensor, n: int, slots: torch.Tensor,
                   lengths: torch.Tensor, gt, indels: bool,
                   cap: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`gate_slots`.

    From the slot row ``[count, starts (cap_in), sids (cap_in)]`` the row
    ``[count, anchors (cap), sids (cap)]`` int32 of the kept slots
    (anchor = start + len[sid]) for which ``gate_ok_ref`` passes, in slot
    order; ``count`` is the true number of survivors, of which the first
    ``cap`` are kept."""
    cap_in = (slots.numel() - 1) // 2
    live = min(int(slots[0]), cap_in)
    sids = slots[1 + cap_in : 1 + cap_in + live].long()
    anchors = slots[1 : 1 + live].long() + lengths[sids].long()
    ok = torch.cat([gate_ok_ref(codes, anchors[c0 : c0 + _REF_CHUNK // 16],
                                sids[c0 : c0 + _REF_CHUNK // 16], gt, indels,
                                n)
                    for c0 in range(0, live, _REF_CHUNK // 16)]
                   or [torch.zeros(0, dtype=torch.bool, device=codes.device)])
    return _row(anchors[ok], sids[ok], cap)


def seed_records(lengths: torch.Tensor, gt) -> torch.Tensor:
    """The gate kernel's per-seed records: int32 [S, 8] on ``gt``'s
    device, row s = (seed length, glen, gdir, the accept words of
    extension rows 1 to :data:`REC_ROWS`, 0 past ``Lg``), 32 bytes a seed,
    so one aligned sector holds all a slot needs to start its gate.  Built
    once per pair of tensors (kept while both live)."""
    key = (id(lengths), id(gt.bits))
    hit = _REC_CACHE.get(key)
    if hit is not None and hit[0]() is lengths and hit[1]() is gt.bits:
        return hit[2]
    S = lengths.numel()
    rec = torch.zeros((S, 8), dtype=torch.int32, device=gt.bits.device)
    rec[:, 0] = lengths
    rec[:, 1] = gt.glen
    rec[:, 2] = gt.gdir
    rows = min(REC_ROWS, gt.Lg)
    rec[:, 3 : 3 + rows] = gt.bits[:, :rows]
    for k in [k for k, v in _REC_CACHE.items()
              if v[0]() is None or v[1]() is None]:
        del _REC_CACHE[k]
    _REC_CACHE[key] = (weakref.ref(lengths), weakref.ref(gt.bits), rec)
    return rec


def gate_slots(codes: torch.Tensor, n: int, slots: torch.Tensor,
               lengths: torch.Tensor, gt, indels: bool,
               cap: int) -> torch.Tensor:
    """Gate survivors of a slot row (see :func:`gate_slots_ref`): the
    int32 row ``[count, anchors (cap), sids (cap)]``, survivors in no
    order, the true count kept: the row :func:`.seed_gate.seed_gate`
    returns.

    ``codes`` uint8 [>= n]; ``slots`` the row of :func:`scan_slots` (its
    count is read on the device); ``lengths`` [S] int32 seed lengths;
    ``gt`` a :class:`..gate.GateTables` on the same device.  On a CUDA
    tensor this launches ``csrc/gate_slots.cu`` on the current stream
    (its instance for the band, ``gt.band`` with indels and 0 without,
    over :func:`seed_records`) and counts the launch in
    ``gate_slots.launches``; on a CPU tensor it is
    :func:`gate_slots_ref`."""
    if codes.device.type == "cpu":
        return gate_slots_ref(codes, n, slots, lengths, gt, indels, cap)
    if codes.device.type != "cuda":
        raise ValueError(f"gate_slots: unsupported device {codes.device}")
    S = lengths.numel()
    _check_common("gate_slots", codes, n, cap, gt.Lg, {
        "codes": (codes, torch.uint8), "slots": (slots, torch.int32),
        "lengths": (lengths, torch.int32), "gate bits": (gt.bits, torch.int32),
        "gate glen": (gt.glen, torch.int32),
        "gate gdir": (gt.gdir, torch.int32)})
    cap_in = (slots.numel() - 1) // 2
    if (slots.dim() != 1 or cap_in < 1 or slots.numel() != 1 + 2 * cap_in
            or gt.bits.shape != (S, gt.Lg) or gt.glen.shape != (S,)
            or gt.gdir.shape != (S,)):
        raise ValueError(
            f"gate_slots: bad shapes: slots {tuple(slots.shape)}, lengths "
            f"{tuple(lengths.shape)}, gate bits {tuple(gt.bits.shape)}")
    if gt.band > MAX_BAND:
        raise ValueError(f"gate_slots: gate band {gt.band} exceeds the "
                         f"kernel's {MAX_BAND}")
    from . import build

    rec = seed_records(lengths, gt)
    lib = build.library("gate_slots")
    out = torch.empty(1 + 2 * cap, dtype=torch.int32, device=codes.device)
    out[0] = 0
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.sat_gate_slots(
            codes.data_ptr(), n, slots.data_ptr(), cap_in, rec.data_ptr(),
            gt.bits.data_ptr(), gt.Lg, gt.k, gt.band if indels else 0,
            out.data_ptr(), cap, stream)
    if rc != 0:
        raise RuntimeError(f"gate_slots launch failed: cudaError_t {rc}")
    gate_slots.launches += 1
    return out


gate_slots.launches = 0


def slot_gated_hits(codes: torch.Tensor, n: int, mt: MerTables, gt,
                    indels: bool, slot_cap: int, cap: int) -> torch.Tensor:
    """The gated seed scan of ``codes[:n]`` through the two kernels, as
    ONE packed int32 row with the layout of :func:`.seed_gate.gated_hits`:

        [slot_count, surv_count, anchors (cap), sids (cap)]

    ``slot_count`` counts the exact seed hits (overflow when >
    ``slot_cap``: some slots were never gated), ``surv_count`` the gate
    survivors (overflow when > ``cap``).  The slot list stays on the
    device.  Nothing here waits for the device."""
    slots = scan_slots(codes, n, mt, slot_cap)
    row = gate_slots(codes, n, slots, mt.lengths, gt, indels, cap)
    return torch.cat([slots[:1], row])
