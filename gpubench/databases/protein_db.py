"""A protein database of ``entries`` sequences that hold ``residues``
residues in all, at the composition of ``residue_percent``.

The lengths are gamma-shaped (``length_gamma_shape``), scaled so that
they add up to ``residues`` exactly: one multiset for every seed, each
seed's in its own order.  The residues are drawn independently."""

from __future__ import annotations

import numpy as np
import torch

from . import EOS_CHAR, Database, generator


def lengths_of(cfg: dict) -> np.ndarray:
    """The entries' lengths, at least 1 each, adding up to ``residues``."""
    n, total = int(cfg["entries"]), int(cfg["residues"])
    q = np.random.default_rng(0).gamma(float(cfg["length_gamma_shape"]),
                                       1.0, n)
    scaled = q * ((total - n) / q.sum())
    lengths = 1 + np.floor(scaled).astype(np.int64)
    short = total - int(lengths.sum())          # 0 <= short < n
    lengths[np.argsort(np.floor(scaled) - scaled)[:short]] += 1
    return lengths


def build(cfg: dict, seed: int, device) -> Database:
    alphabet = cfg["alphabet"]
    table = (alphabet + EOS_CHAR).encode()
    lengths = np.random.default_rng(seed).permutation(lengths_of(cfg))
    n, total = len(lengths), int(lengths.sum())
    starts = np.cumsum(lengths) - lengths + np.arange(1, n + 1)
    freq = torch.tensor([cfg["residue_percent"][c] for c in alphabet],
                        dtype=torch.float64)
    cdf = (torch.cumsum(freq, 0) / freq.sum()).to(torch.float32).to(device)
    g = generator(seed, device)
    body = torch.searchsorted(
        cdf, torch.rand(total, generator=g, device=device))
    eos = torch.zeros(total + n, dtype=torch.bool, device=device)
    eos[torch.as_tensor(starts - 1, device=device)] = True
    codes = torch.full((total + n,), len(table) - 1, dtype=torch.uint8,
                       device=device)
    codes[~eos] = body.clamp_(max=len(alphabet) - 1).to(torch.uint8)
    return Database(codes.cpu().numpy(), table, starts.astype(np.int64),
                    lengths)
