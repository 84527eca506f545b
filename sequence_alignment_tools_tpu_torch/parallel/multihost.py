"""Multi-process bring-up and the 2-D node x GPU mesh.

Port of ``sequence_alignment_tools_tpu/parallel/multihost.py`` over
``torch.distributed``.  The flat coordinate space stays one: it is
sharded over a 2-D mesh whose "host" axis is the ranks of the process
group and whose "chip" axis is each rank's local devices.  Every rank
holds the full flat array (as every JAX process does) and builds and
scans only its own shards, with the single-device routes and their CUDA
kernels; counts are summed in-process and then ``all_reduce``d, and the
hit lists are ``all_gather``ed, so that every rank yields the same
global stream.

The transport is gloo over host tensors.  What crosses processes is
small (a count vector, the decoded hit lists), and the per-shard decode
fetches the rows to the host in any case; NCCL cannot put two ranks on
one GPU, which is the only multi-rank form a one-card machine has.  The
kernels run on each rank's own devices either way.  Every collective
carries the process group's timeout (:func:`init_distributed`), so a
rank that never arrives fails the run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from .shard import Mesh, _fused_hits, probe_devices, shard_codes


def init_distributed(timeout: float = 600.0) -> tuple[int, int]:
    """Guarded multi-process bring-up; returns (rank, world size).

    Joins a gloo process group once when a coordinator is configured:
    ``SAT_COORDINATOR`` (``host:port``) with ``SAT_NUM_PROCESSES`` and
    ``SAT_PROCESS_ID``, or ``torchrun``'s ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``.  Idempotent.  With no
    coordinator it is a no-op returning (0, 1) that creates no process
    group and touches no GPU, so every CLI tool may call it at start.
    ``timeout`` (seconds) bounds every collective of the group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    coord = env.get("SAT_COORDINATOR")
    if coord:
        init = dict(init_method=f"tcp://{coord}",
                    world_size=int(env.get("SAT_NUM_PROCESSES", "1")),
                    rank=int(env.get("SAT_PROCESS_ID", "0")))
    elif env.get("MASTER_ADDR") and env.get("RANK") is not None \
            and env.get("WORLD_SIZE"):
        init = dict(init_method="env://")
    else:
        return 0, 1
    dist.init_process_group(
        "gloo", timeout=datetime.timedelta(seconds=timeout), **init)
    return dist.get_rank(), dist.get_world_size()


def make_host_chip_mesh(n_hosts: int | None = None, devices=None) -> Mesh:
    """The ("host", "chip") mesh.  ``devices``: this rank's chip axis
    (default every device of the CLI's platform, entries may repeat).
    In a process group the host axis is its ranks (``n_hosts``, if given,
    must equal the world size); without one, ``n_hosts`` (default 1)
    splits ``devices`` into rows that this one process drives, the
    single-process form of the same mesh."""
    import torch.distributed as dist

    if devices is None:
        devices = probe_devices()
    devices = list(devices)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_hosts not in (None, world):
            raise ValueError(f"n_hosts {n_hosts} in a group of {world}")
        return Mesh(devices, ("host", "chip"), (world, len(devices)),
                    dist.group.WORLD)
    n_hosts = n_hosts or 1
    if len(devices) % n_hosts:
        raise ValueError(f"{len(devices)} devices in {n_hosts} rows")
    return Mesh(devices, ("host", "chip"),
                (n_hosts, len(devices) // n_hosts))


def shard_codes_2d(codes: np.ndarray, mesh: Mesh, halo: int,
                   eos_code: int):
    """(rows, shard_len): the position shards over the host x chip grid,
    in flat (host, chip) order, with the 1-D layout's right halo (a
    window belongs to the shard holding its start).  Each rank builds
    and uploads only its own rows."""
    if len(mesh.shape) != 2:
        raise ValueError(f"a 2-D mesh, got shape {mesh.shape}")
    return shard_codes(codes, mesh, halo, eos_code)


def sharded_scan_counts_2d(shards, weights, thresholds, lengths,
                           alpha: int, mesh: Mesh) -> torch.Tensor:
    """Per-pattern hit counts [P] (int64, CPU) over the 2-D mesh, equal
    on every rank: this rank's rows scored as in
    :func:`.shard.sharded_scan_counts`, summed, then ``all_reduce`` over
    the host axis (only the [P] vector crosses processes)."""
    from .shard import sharded_scan_counts

    return sharded_scan_counts(shards, weights, thresholds, lengths, alpha,
                               mesh)


def _all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [m_r, w] int64 rows, concatenated in rank order: the
    lengths first, then the rows padded to the longest."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    m = torch.tensor([local.shape[0]], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, m, group=group)
    longest = max(int(s) for s in sizes)
    if longest == 0:  # every rank agrees: nothing to gather
        return local
    pad = torch.zeros(longest, local.shape[1], dtype=torch.int64)
    pad[: local.shape[0]] = local
    parts = [torch.zeros_like(pad) for _ in range(world)]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[: int(s)] for p, s in zip(parts, sizes)])


def sharded_pallas_scan_hits_2d(scanner, codes: np.ndarray, mesh: Mesh):
    """The fused scan pipeline over the 2-D mesh: each rank scans its
    shards (``scan_filter.cu`` per shard, caps agreed over the ranks
    before any re-launch), decodes and rebases them, and the hit lists
    are gathered in rank order, which is position order.  Yields the
    same global (end, pid, mism) stream as
    :func:`.shard.sharded_pallas_scan_hits`, on every rank."""
    hits = _fused_hits(scanner, codes, mesh)
    if mesh.group is None:
        yield from hits
        return
    local = torch.tensor(hits, dtype=torch.int64).reshape(-1, 3)
    for end, pid, mism in _all_gather_rows(local, mesh.group).tolist():
        yield end, pid, mism

