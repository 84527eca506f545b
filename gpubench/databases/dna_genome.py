"""A genome of random bases: ``positions`` codes over ``alphabet`` in
entries of ``entry_length`` (the last one shorter)."""

from __future__ import annotations

import numpy as np
import torch

from . import EOS_CHAR, Database, generator


def build(cfg: dict, seed: int, device) -> Database:
    n, entry = int(cfg["positions"]), int(cfg["entry_length"])
    table = (cfg["alphabet"] + EOS_CHAR).encode()
    eos_at = np.arange(0, n, entry + 1, dtype=np.int64)
    starts = eos_at + 1
    lengths = np.minimum(entry, n - starts)
    g = generator(seed, device)
    codes = torch.randint(0, len(cfg["alphabet"]), (n,), generator=g,
                          device=device, dtype=torch.uint8)
    codes[torch.as_tensor(eos_at, device=device)] = len(table) - 1
    return Database(codes.cpu().numpy(), table, starts, lengths)
