"""Multiplex PCR primer panels, a new panel each query.

A query is ``pairs_per_query`` primer pairs (as many sizes as the range
holds, spread evenly).  Each primer is read from a database site drawn
uniformly over the positions, its length spread evenly over
``pattern_length``; the second primer of a pair is read from the other
strand, as a reverse primer is (the reverse complement of its site).
Set-up draws every query's sites and lengths; a query's strings are read
when it is sent.  Off-target sites are those the database holds: no
copies are planted.
"""

from __future__ import annotations

import numpy as np

from ..databases import Database
from . import Query, bytes_seconds, letters_at, pieces, size_schedule

_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def sites(db: Database, lengths: np.ndarray,
          rng: np.random.Generator) -> np.ndarray:
    """A start for each length, uniform over the database's positions,
    the site lying inside one entry."""
    ends = db.entry_starts + db.entry_lengths
    out = np.empty(len(lengths), np.int64)
    todo = np.arange(len(lengths))
    while len(todo):
        s = rng.integers(0, len(db) - lengths[todo])
        e = np.searchsorted(db.entry_starts, s, side="right") - 1
        ok = (e >= 0) & (s + lengths[todo] <= ends[np.maximum(e, 0)])
        out[todo[ok]] = s[ok]
        todo = todo[~ok]
    return out


class Mix:
    def __init__(self, spec: dict, db: Database, seed: int, device):
        rng = np.random.default_rng([seed, 1])
        lo, hi = spec["pairs_per_query"]
        self.sizes = 2 * size_schedule(lo, hi, hi - lo + 1,
                                       int(spec["max_queries"]), rng)
        self.db = db
        self.length_range = spec["pattern_length"]
        self.lengths, self.starts = self._draw(int(self.sizes.sum()), rng)

    def _draw(self, count: int, rng: np.random.Generator):
        lo, hi = self.length_range
        lengths = size_schedule(lo, hi, hi - lo + 1, count, rng)
        return lengths, sites(self.db, lengths, rng)

    def _panel(self, lengths, starts) -> Query:
        pats = pieces(*letters_at(self.db, starts, lengths))
        pats[1::2] = [p.translate(_COMPLEMENT)[::-1] for p in pats[1::2]]
        return Query(pats)

    def queries(self):
        at = 0
        for m in self.sizes:
            yield self._panel(self.lengths[at:at + m], self.starts[at:at + m])
            at += m

    def warmup(self) -> list[Query]:
        rng = np.random.default_rng(0)
        return [self._panel(*self._draw(int(m), rng))
                for m in sorted({self.sizes.min(), self.sizes.max()})]


def least_seconds(db: Database, search: dict, patterns: list[str],
                  hits: int) -> float:
    """Bytes alone: the genome at 2 bits a base, the primers, the hits."""
    return bytes_seconds(len(db), len(db.table) - 1, patterns,
                         int(search["k"]), hits)
