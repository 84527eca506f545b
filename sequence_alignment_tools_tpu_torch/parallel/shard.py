"""Position sharding of the scans over a mesh of devices.

Port of ``sequence_alignment_tools_tpu/parallel/shard.py``, over
``torch.device``s in place of ``jax.sharding``.  The contract is the JAX
one:

- the flat code array is cut along positions into ``mesh.size`` equal
  shards of ``shard_len = ceil(n / size)`` positions, padded with EOS
  (:func:`shard_codes`);
- each shard is scanned, with its halo, by the scanner's own
  single-device route and its CUDA kernels (the fused route
  ``scan_filter.cu``, the gated route ``scan_filter.cu`` +
  ``seed_gate.cu``, Sellers ``sellers.cu``), one launch per shard;
- a hit belongs to exactly one shard: the one holding its window start
  (fused, streamed and gated routes) or its end (Sellers);
- the per-shard hits are rebased to global positions and concatenated
  in shard order, which is the unsharded scan's global order.

A shard scans only the live part of its row (the positions inside
``[0, n)``), so text outside the array reads as the unsharded scan reads
it (EOS for the filters, the out-of-range sentinel for the gate, the
text-start column for Sellers at position 0), and every position a hit
owned by the shard depends on lies inside its halos.  Every shard is
dispatched before any row is read.

The JAX shards ride ``shard_map`` and one ``all_gather``; here one
process drives every device of a 1-D mesh, and the 2-D node x GPU mesh
of :mod:`.multihost` gathers across processes with ``torch.distributed``.
A mesh may repeat a device (``make_mesh(["cuda:0"] * 4)``, or N entries
of the CPU): that is how one card, and the CPU in the tests, carry N
shards.
"""

from __future__ import annotations

import math
import os
import weakref
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from ..ops.conv_scan import device_form
from .devcache import devcount_cache_path, read_devcount


def _normal(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ordered list of devices and how the shards map onto them.

    ``devices``: the devices THIS process drives, one shard each, in
    shard order (a device may repeat).  ``shape``: ``(size,)`` for the
    1-D mesh, ``(hosts, chips)`` for the 2-D one.  ``group``: the
    ``torch.distributed`` process group of the host axis, or None when
    one process drives every shard.  ``size``: the number of shards over
    all processes (the JAX ``mesh.devices.size``).  Rank r of the group
    drives the flat shards ``r * len(devices)`` onward."""

    def __init__(self, devices, axis_names=("data",), shape=None,
                 group=None):
        self.devices = tuple(_normal(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None \
            else (len(self.devices),)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match its "
                             f"axes {self.axis_names}")
        self.size = math.prod(self.shape)
        self.group = group
        self.first = 0
        procs = 1
        if group is not None:
            import torch.distributed as dist

            self.first = dist.get_rank(group) * len(self.devices)
            procs = dist.get_world_size(group)
        if len(self.devices) * procs != self.size:
            raise ValueError(
                f"{len(self.devices)} devices in each of {procs} processes "
                f"do not make a mesh of shape {self.shape}")

    def local(self):
        """[(flat shard index, device)] of the shards this process
        drives."""
        return [(self.first + c, d) for c, d in enumerate(self.devices)]

    def _key(self):
        return (self.devices, self.shape, self.first)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self._key() == other._key()
                and self.group is other.group)

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axes={self.axis_names}, shape={self.shape})")


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """1-D mesh over ``devices`` (default: every device of the CLI's
    platform, :func:`probe_devices`); entries may repeat."""
    if devices is None:
        devices = probe_devices()
    return Mesh(devices, (axis,))


def _platform(device=None) -> str:
    return torch.device(device if device is not None
                        else os.environ.get("SAT_DEVICE", "cuda")).type


def probe_devices(device=None) -> list[torch.device]:
    """The visible devices of the platform of ``device`` (default
    ``SAT_DEVICE``): every GPU (``torch.cuda.device_count()``, which
    creates no CUDA context), or the one CPU device."""
    if _platform(device) == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def auto_mesh(axis: str = "data", device=None) -> Mesh | None:
    """The mesh the CLI tools scan over, or None for the single-device
    path (the JAX ``SAT_MESH`` semantics; ``device`` names the platform,
    default ``SAT_DEVICE``):

    - ``SAT_MESH`` 0, 1, ``off`` or ``none``: None;
    - ``SAT_MESH=N`` (N > 1): the first N GPUs, exiting when fewer are
      visible; on the CPU platform N entries of the CPU device;
    - unset or ``auto``: every GPU when more than one is visible, never
      on the CPU.

    Auto mode reads the GPU count from the cache of :mod:`.devcache`
    while it is fresh, and probes (and rewrites it) otherwise."""
    spec = os.environ.get("SAT_MESH", "auto").strip().lower()
    if spec in ("0", "1", "off", "none"):
        return None
    cpu = _platform(device) == "cpu"
    if spec in ("", "auto"):
        if cpu:
            return None
        got = read_devcount()
        if got is not None and got[1] and got[0] <= 1:
            return None
        devices = probe_devices(device)
        try:
            with open(devcount_cache_path(), "w") as f:
                f.write(str(len(devices)))
        except OSError:
            pass
        return make_mesh(devices, axis) if len(devices) > 1 else None
    n = int(spec)
    if n <= 1:
        return None
    if cpu:
        return make_mesh([torch.device("cpu")] * n, axis)
    devices = probe_devices(device)
    if len(devices) < n:
        raise SystemExit(
            f"SAT_MESH={n} but only {len(devices)} devices visible")
    return make_mesh(devices[:n], axis)


def shard_codes(codes: np.ndarray, mesh: Mesh, halo: int, eos_code: int,
                left: int = 0):
    """(rows, shard_len): this process's rows of the overlapped layout.

    The array is padded with ``eos_code`` to ``mesh.size * shard_len``
    positions; row i (uint8, on its mesh device) holds the global
    positions ``[i * shard_len - left, (i + 1) * shard_len + halo)``, EOS
    outside ``[0, n)``.  With ``left = 0`` this is the JAX layout (a right
    halo, materialized by overlapping slices).  Each row is filled on its
    device and its text copied there straight from the host array, one
    upload a row, counted in ``device_form.uploads``."""
    codes = np.asarray(codes)
    n = len(codes)
    shard = -(-n // mesh.size)
    width = left + shard + halo
    rows = []
    for i, dev in mesh.local():
        lo = i * shard - left
        row = torch.full((width,), eos_code, dtype=torch.uint8, device=dev)
        a, b = max(lo, 0), min(lo + width, n)
        if b > a:
            part = np.ascontiguousarray(codes[a:b], dtype=np.uint8)
            if not part.flags.writeable:  # a read-only or mapped array
                part = part.copy()
            row[a - lo : b - lo].copy_(torch.from_numpy(part))
        rows.append(row)
        device_form.uploads += 1
    return rows, shard


class _Shard(NamedTuple):
    index: int            # flat shard index
    codes: torch.Tensor   # the live part of the row, on its device
    n: int                # its length
    base: int             # global position of codes[0]
    own: tuple            # global positions [lo, hi) the shard owns


_SHARDS_CACHE: dict = {}


def _shards_form(codes, mesh: Mesh, halo: int, eos: int, left: int = 0):
    """This process's shards of ``codes`` on the mesh (``shard_codes``
    and the uploads), cached by the host array's identity and the mesh
    (as ``ops.conv_scan.device_form`` caches one upload): a serving
    stream re-scans the same resident database every run and must not
    re-shard or re-upload it.  The entry drops with the array.  Shards
    wholly past the end of the array are left out.  A left halo is
    rounded up to 16 positions, so that shard 0's live part (which starts
    there) stays 16-byte aligned for the kernels' wide text loads."""
    left = -(-left // 16) * 16
    key = (id(codes), mesh, halo, left, eos)
    ent = _SHARDS_CACHE.get(key)
    if ent is not None and ent[0]() is codes:
        return ent[1]
    n = len(codes)
    rows, shard = shard_codes(codes, mesh, halo, eos, left)
    shards = []
    for (i, _dev), row in zip(mesh.local(), rows):
        lo = i * shard - left
        a, b = max(0, -lo), min(row.numel(), n - lo)
        if b > a:
            shards.append(_Shard(i, row[a:b], b - a, lo + a,
                                 (i * shard, min((i + 1) * shard, n))))
    try:
        ref = weakref.ref(codes)
    except TypeError:  # an object without weak references: not cached
        return shards
    weakref.finalize(codes, _SHARDS_CACHE.pop, key, None)
    _SHARDS_CACHE[key] = (ref, shards)
    return shards


def _one_process(mesh: Mesh) -> None:
    if mesh.group is not None:
        raise ValueError("a mesh across processes takes the functions of "
                         "parallel.multihost")


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _agree(values, group) -> list[int]:
    """``values`` reduced (MAX) over the process group, or as they are
    without one."""
    if group is None:
        return [int(v) for v in values]
    import torch.distributed as dist

    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


# -- the plain scores (the JAX one-hot products, no kernel) ----------------


def _plain_hits(row: torch.Tensor, weights, thresholds, alpha: int):
    """hit [B, P] bool of every window start of ``row`` (B = len - Lmax +
    1): the float32 score ``sum_j W[j, row[b + j], p]`` by gathers, at
    least the threshold."""
    w = torch.as_tensor(weights).to(row.device, torch.float32)
    thr = torch.as_tensor(thresholds).to(row.device, torch.float32)
    Lmax, a, P = w.shape
    if a != alpha:
        raise ValueError(f"weights over {a} codes, alpha {alpha}")
    B = row.numel() - Lmax + 1
    idx = row.long()
    acc = torch.zeros(max(B, 0), P, dtype=torch.float32, device=row.device)
    for j in range(Lmax):
        acc += w[j][idx[j : j + B]]
    return acc >= thr[None, :]


def sharded_scan_counts(shards, weights, thresholds, lengths, alpha: int,
                        mesh: Mesh) -> torch.Tensor:
    """Per-pattern hit counts [P] (int64, on the CPU) over the rows of
    :func:`shard_codes` (the ``patcount`` reduction,
    primer_match.cc:1236-1247): every window start of each row scored
    by :func:`_plain_hits`, the counts summed over the shards, and over
    the processes of the mesh's group (``all_reduce``).  ``lengths`` is
    unused, as in the JAX function."""
    P = int(torch.as_tensor(thresholds).numel())
    total = torch.zeros(P, dtype=torch.int64)
    for row in shards:
        total += _plain_hits(row, weights, thresholds, alpha).sum(0).cpu()
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total


def sharded_scan_hits(shards, weights, thresholds, lengths, alpha: int,
                      mesh: Mesh, cap: int = 4096):
    """The global hit list of the rows of :func:`shard_codes`:
    (counts [n_dev] int32, starts [n_dev, cap], pids [n_dev, cap]) on the
    CPU, unused slots -1.  Shard i's starts are rebased by ``i * B`` (B
    its window starts: the shard length when the halo is Lmax - 1), so
    the rows concatenate in position order."""
    _one_process(mesh)
    counts, starts, pids = [], [], []
    for i, row in enumerate(shards):
        hit = _plain_hits(row, weights, thresholds, alpha)
        B, P = hit.shape
        (idx,) = torch.nonzero(hit.reshape(-1), as_tuple=True)
        counts.append(int(idx.numel()))
        idx = idx[:cap].cpu()
        s = torch.full((cap,), -1, dtype=torch.int32)
        p = torch.full((cap,), -1, dtype=torch.int32)
        s[: idx.numel()] = (idx // P + i * B).to(torch.int32)
        p[: idx.numel()] = (idx % P).to(torch.int32)
        starts.append(s)
        pids.append(p)
    return (torch.tensor(counts, dtype=torch.int32), torch.stack(starts),
            torch.stack(pids))


# -- the fused route, per shard --------------------------------------------


def _owned_hits(scanner, shard: _Shard, hits):
    """(end, pid, mism) of ``hits`` (shard-local) that the shard owns by
    window start, rebased to global positions."""
    lengths = scanner.tables.lengths
    lo, hi = shard.own
    for end, pid, mism in hits:
        end += shard.base
        if lo <= end - int(lengths[pid]) < hi:
            yield end, pid, mism


def _fused_hits(scanner, codes, mesh: Mesh) -> list:
    """This process's hits of the fused route over its shards, in global
    positions and shard order.  Every shard is dispatched before any row
    is read; when a shard overflows, the caps grow past the largest true
    count (agreed over the group first, so that every process re-launches
    together) and every shard runs again."""
    t = scanner.tables
    shards = _shards_form(codes, mesh, t.Lmax - 1 + scanner.k, scanner._eos)
    nmax = max((s.n for s in shards), default=0)
    while True:
        caps = scanner._presize(nmax) if nmax \
            else (scanner._cap_mb, scanner._hit_cap)
        caps = _agree(caps, mesh.group)
        scanner._cap_mb, scanner._hit_cap = caps
        packed = [scanner._dispatch(s.codes, s.n, *caps) for s in shards]
        rows = [p.cpu().numpy() for p in packed]
        need = _agree((max((int(r[0]) for r in rows), default=0),
                       max((int(r[1]) for r in rows), default=0)),
                      mesh.group)
        if need[0] <= caps[0] and need[1] <= caps[1]:
            break
        scanner._cap_mb = max(caps[0], _pow2(need[0]))
        scanner._hit_cap = max(caps[1], _pow2(need[1]))
    out = []
    for s, row in zip(shards, rows):
        out.extend(_owned_hits(scanner, s, scanner._decode_packed(
            row, s.codes, s.n, tuple(caps))))
    return out


def sharded_pallas_scan_hits(scanner, codes: np.ndarray, mesh: Mesh):
    """The fused scan pipeline (``ops/cuda/scan_kernel.scan_hits``:
    ``scan_filter.cu``, compaction, exact rescore) over the mesh: each
    shard scans its positions plus a right halo of ``Lmax - 1 + k``, a
    window is owned by the shard holding its start, and the rebased rows
    concatenate in shard order.  Yields (end, pid, mism) in global
    positions, in the unsharded scan's (window start, pattern) order."""
    _one_process(mesh)
    yield from _fused_hits(scanner, codes, mesh)


def sharded_scan_stream(scanner, blocks, mesh: Mesh, depth: int = 32):
    """The pipelined scan (``ConvScanner.scan_stream``) over the mesh:
    every block is sharded (right halo ``Lmax - 1 + k``) and each shard
    dispatched without a sync; each shard's packed row is copied to
    pinned host memory behind an event, and block i is decoded while
    the ``depth`` blocks behind it run.  A shard that overflows runs
    again with the caps grown (stickily).  Yields (block_index,
    hits_list), hits (end, pid, mism) in block-local positions, in the
    unsharded stream's order.  A resident block (the same array object
    every run) is sharded and uploaded once."""
    _one_process(mesh)
    t = scanner.tables
    halo = t.Lmax - 1 + scanner.k
    depth = max(int(depth), 1)

    def drain(item):
        i, items, caps = item
        out = []
        for s, host, ev in items:
            if ev is not None:
                ev.synchronize()
            out.extend(_owned_hits(scanner, s, scanner._decode_packed(
                host.numpy(), s.codes, s.n, caps)))
        return i, out

    pending = deque()
    for i, codes in enumerate(blocks):
        caps = (scanner._cap_mb, scanner._hit_cap)
        items = []
        if len(codes):
            for s in _shards_form(codes, mesh, halo, scanner._eos):
                host, ev = scanner._to_host(
                    scanner._dispatch(s.codes, s.n, *caps))
                items.append((s, host, ev))
        pending.append((i, items, caps))
        if len(pending) >= depth:
            yield drain(pending.popleft())
    while pending:
        yield drain(pending.popleft())


# -- the gated route (pigeonhole k > 0 seeds), per shard -------------------


def gated_halos(scanner, gt) -> tuple[int, int]:
    """(left, right) halos of a gated seed scan: a seed owned by a shard
    starts inside it; its window reaches ``Lmax`` right, and the gate's
    window of ``Lg + band`` positions reads right of the seed's end
    (lmatch) or left of its start (rmatch, from ``start - 1``)."""
    span = gt.Lg + gt.band
    return span, scanner.tables.Lmax + span


def sharded_gated_slots(scanner, gt, indels: bool, k: int,
                        codes: np.ndarray, mesh: Mesh):
    """One gated seed scan over the mesh: the port's gated route
    (``scan_filter.cu`` + ``seed_gate.cu``) per shard, with the halos of
    :func:`gated_halos`.  A candidate is owned by the shard holding its
    seed's window start.  Output contract of ``ConvScanner.scan_gated``:
    (anchors int64, sids int32) in global positions, in no order."""
    _i, anchors, sids = next(sharded_gated_stream(
        scanner, [codes], gt, indels, k, mesh, depth=1))
    return anchors, sids


def sharded_gated_stream(scanner, blocks, gate, indels: bool, k: int,
                         mesh: Mesh, depth: int = 24):
    """The streamed form of :func:`sharded_gated_slots` (the serving
    posture of the pigeonhole engines): run i + 1's shards are dispatched
    before run i's rows are read, each row copied to pinned host memory
    behind an event; an overflowing shard runs again with its cap grown.
    Yields (i, anchors, sids) in order, per run equal to
    ``ConvScanner.scan_gated``.  A resident database is sharded and
    uploaded once."""
    _one_process(mesh)
    gt = scanner._gated_gate(gate, k, False)
    left, right = gated_halos(scanner, gt)
    lengths = scanner.tables.lengths
    depth = max(int(depth), 1)

    def drain(item):
        i, items = item
        anchors, sids = [np.zeros(0, np.int64)], [np.zeros(0, np.int32)]
        for s, host, ev, caps in items:
            if ev is not None:
                ev.synchronize()
            a, sid = scanner._gated_decode(host.numpy(), s.codes, s.n, gt,
                                           indels, caps, False)
            a = a + s.base
            start = a - lengths[sid]
            own = (start >= s.own[0]) & (start < s.own[1])
            anchors.append(a[own])
            sids.append(sid[own])
        return i, np.concatenate(anchors), np.concatenate(sids)

    pending = deque()
    for i, codes in enumerate(blocks):
        items = []
        if len(codes):
            for s in _shards_form(codes, mesh, right, scanner._eos, left):
                caps = scanner._gated_caps(s.n, False)
                host, ev = scanner._to_host(scanner._gated_dispatch(
                    s.codes, s.n, gt, indels, caps, False))
                items.append((s, host, ev, caps))
        pending.append((i, items))
        if len(pending) >= depth:
            yield drain(pending.popleft())
    while pending:
        yield drain(pending.popleft())


# -- Sellers, per shard -----------------------------------------------------


def sharded_sellers_scan(scanner, codes: np.ndarray, mesh: Mesh):
    """The k-edit Sellers candidate scan (``sellers.cu``) over the mesh:
    each shard scans its positions after a LEFT halo of ``Lmax + k``
    (every alignment of at most k edits ending in the shard starts
    inside it; shard 0 starts at the text's start, as the unsharded
    scan does), and a candidate belongs to the shard holding its end.
    Yields (end, pid, mindist) per shard in (end, pattern) order, which
    over the shards is the order of ``SellersScanner.scan``."""
    _one_process(mesh)
    t = scanner.tables
    eos = max(int(t.eos_code), 0)
    shards = _shards_form(codes, mesh, 0, eos, t.Lmax + scanner.k)
    launched = []
    for s in shards:
        cap = scanner._cap("sellers", s.n)
        launched.append((s, cap, scanner._dispatch("sellers", s.codes, s.n,
                                                   cap)))
    for s, cap, row in launched:
        pos, pids, dist = scanner._decode("sellers", row.cpu().numpy(),
                                          s.codes, s.n, cap)
        pos = pos + s.base
        own = (pos >= s.own[0]) & (pos < s.own[1])
        ends, pids, dist = pos[own] + 1, pids[own], dist[own]
        order = np.lexsort((pids, ends))
        for e, p, d in zip(ends[order].tolist(), pids[order].tolist(),
                           dist[order].tolist()):
            yield e, p, d

