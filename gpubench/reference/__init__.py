"""The plain reference that decides ``correct``: torch and numpy only.

A traffic file's ``search`` names the search (``engine``) and its
parameters; the module ``reference/<engine>.py`` gives, with
``answer(ref, search, patterns)``, the hits the search should report for
one query, from the database's codes and the query's pattern strings
alone.  A later search of a new engine adds that module and edits none.
The traffic file's ``control`` lists the parameters that the control
changes, which breaks one guarantee of the configuration.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


class Reference:
    """The database on ``device`` once, then :meth:`answer` per query."""

    def __init__(self, codes: np.ndarray, table: bytes, device):
        self.codes = codes
        self.table = table
        self.eos = len(table) - 1
        self.codes_t = torch.as_tensor(codes, device=device)

    def answer(self, search: dict, patterns: list[str]) -> np.ndarray:
        """Sorted (end, pattern id, edits) rows."""
        engine = importlib.import_module(f"{__name__}.{search['engine']}")
        return engine.answer(self, search, patterns)


def compare(got: np.ndarray, want: np.ndarray) -> tuple[int, int]:
    """(missing, extra): rows of ``want`` absent from ``got`` and rows of
    ``got`` absent from ``want``, counted as multisets."""
    def counts(rows):
        keys, n = np.unique(rows.reshape(-1, 3), axis=0, return_counts=True)
        return {tuple(k): c for k, c in zip(keys.tolist(), n.tolist())}

    g, w = counts(got), counts(want)
    missing = sum(max(c - g.get(k, 0), 0) for k, c in w.items())
    extra = sum(max(c - w.get(k, 0), 0) for k, c in g.items())
    return missing, extra
