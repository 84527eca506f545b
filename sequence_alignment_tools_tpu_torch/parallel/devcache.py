"""A look at the on-disk device-count cache that touches no GPU.

Port of ``sequence_alignment_tools_tpu/parallel/devcache.py``.
``shard.auto_mesh`` caches the host's GPU COUNT so that a known
single-GPU machine answers "no mesh" from a file.  A host-routed one-shot
CLI run (the native machines) then never asks the CUDA driver how many
devices it has.  This module answers the only question the model build
needs ("is this certainly the no-mesh posture?") with the standard
library; anything else falls through to ``auto_mesh``.

The cache is keyed by the node and ``SAT_DEVICE`` (the platform the CLI
runs on), in the process's temporary directory.
"""

from __future__ import annotations

import os
import tempfile
import time

STALE_S = 600  # auto_mesh re-probes a count older than this


def devcount_cache_path() -> str:
    key = "%s_%s" % (os.uname().nodename,
                     os.environ.get("SAT_DEVICE", "cuda"))
    key = "".join(c if c.isalnum() else "_" for c in key)
    return os.path.join(tempfile.gettempdir(), "sat_torch_devcount_" + key)


def read_devcount() -> tuple[int, bool] | None:
    """(cached count, fresh) or None when there is no readable cache."""
    path = devcount_cache_path()
    try:
        with open(path) as f:
            cached = int(f.read().strip())
        fresh = (time.time() - os.path.getmtime(path)) <= STALE_S
    except (OSError, ValueError):
        return None
    return cached, fresh


def peek_no_mesh() -> bool:
    """True when ``auto_mesh`` would certainly return ``None``:
    ``SAT_MESH`` disabled (0, 1, off, none), or auto mode with a FRESH
    cached count of at most one GPU (a stale cache falls through, so
    that ``auto_mesh`` probes again)."""
    spec = os.environ.get("SAT_MESH", "auto").strip().lower()
    if spec in ("0", "1", "off", "none"):
        return True
    if spec not in ("", "auto"):
        return False
    got = read_devcount()
    return got is not None and got[0] <= 1 and got[1]
