"""Device-side index compaction: the scan pipelines' hit emission.

:func:`compact_mask` keeps the contract of the JAX package's
``ops/compact.compact_mask``: the first ``cap`` set positions of a flat
boolean mask, ascending, padded with ``mask.numel()``, plus the total
count (overflow is ``count > cap``).  It is one cumsum and one scatter,
with shapes fixed by ``cap``: nothing in it waits for the device, so a
caller can queue the next scan behind it.
"""

from __future__ import annotations

import torch


def compact_mask(mask: torch.Tensor, cap: int):
    """``(count, idx)`` for a flat bool ``mask``: ``count`` the number of
    set entries (0-d int64 tensor), ``idx`` [cap] int64 the first ``cap``
    set positions in ascending order, padded with ``mask.numel()``."""
    m = mask.reshape(-1)
    n = m.numel()
    dev = m.device
    rank = torch.cumsum(m, 0, dtype=torch.int64)
    count = rank[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    rank = rank - 1
    # set positions within the cap go to their rank; everything else to
    # the spill slot ``cap``, which is cut off below
    slot = torch.where(m & (rank < cap), rank, cap)
    idx = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=dev))
    return count, idx[:cap]
