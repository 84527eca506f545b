"""Databases of the benchmark's configurations, made in memory from the
seed: the bulk on the device with a seeded ``torch.Generator``, the few
per-entry numbers with numpy, then copied to the host once.

A configuration file (``configs/<config>.json``) names its ``kind``; the
module ``databases/<kind>.py`` makes it with ``build(cfg, seed, device)``.
A later configuration of a new kind adds that module and edits none.
Every database is laid out as the suite's normalized form is: an
end-of-sequence code before each entry.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

EOS_CHAR = "\n"


@dataclass
class Database:
    """Codes over ``table`` (the last code is the end of sequence), with
    each entry's first position and length."""

    codes: np.ndarray
    table: bytes
    entry_starts: np.ndarray
    entry_lengths: np.ndarray

    @property
    def eos(self) -> int:
        return len(self.table) - 1

    def __len__(self) -> int:
        return int(self.codes.shape[0])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def build(cfg: dict, seed: int, device) -> Database:
    """The database of configuration ``cfg`` for ``seed``."""
    kind = importlib.import_module(f"{__name__}.{cfg['kind']}")
    return kind.build(cfg, seed, device)
