"""Peptides as a mass spectrometry run identifies them, a new run each
query.

Set-up digests the database: a cut after each ``cleave_after`` residue
that is not followed by ``not_before``, and at every entry's ends.  The
pieces of at least ``min_length`` residues and at most ``max_mass_da``
(monoisotopic, with the water) make the peptide pool.  A query is
``patterns_per_query`` distinct pool pieces; with ``il_ambiguous`` each I
or L of a peptide is read as either, at random, since the two have one
mass and a spectrum does not tell them apart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..databases import Database
from . import Query, bytes_seconds, letters_at, pieces, size_schedule

# monoisotopic residue masses, Da
RESIDUE_MASS = {
    "G": 57.02146, "A": 71.03711, "S": 87.03203, "P": 97.05276,
    "V": 99.06841, "T": 101.04768, "C": 103.00919, "L": 113.08406,
    "I": 113.08406, "N": 114.04293, "D": 115.02694, "Q": 128.05858,
    "K": 128.09496, "E": 129.04259, "M": 131.04049, "H": 137.05891,
    "F": 147.06841, "R": 156.10111, "Y": 163.06333, "W": 186.07931,
}
WATER = 18.01056


def digest(db: Database, spec: dict, device):
    """(starts, lengths) of the pool's pieces, as numpy arrays."""
    table = db.table.decode()
    c = torch.as_tensor(db.codes, device=device)
    cut = torch.zeros(len(db) + 1, dtype=torch.bool, device=device)
    nxt = torch.cat([c[1:], c.new_full((1,), db.eos)])
    for ch in spec["cleave_after"]:
        cut[1:] |= (c == table.index(ch)) & (nxt != table.index(
            spec["not_before"]))
    eos = c == db.eos
    cut[:-1] |= eos          # a piece never starts on an EOS
    cut[1:] |= eos           # nor runs past one
    cut[0] = cut[-1] = True
    del nxt
    mass = torch.tensor([RESIDUE_MASS.get(ch, 0.0) for ch in table],
                        dtype=torch.float64, device=device)
    cum = torch.zeros(len(db) + 1, dtype=torch.float64, device=device)
    torch.cumsum(mass[c.long()], 0, out=cum[1:])
    bounds = torch.nonzero(cut).flatten()
    s, e = bounds[:-1], bounds[1:]
    ok = (((e - s) >= int(spec["min_length"]))
          & (cum[e] - cum[s] + WATER <= float(spec["max_mass_da"]))
          & ~eos[s])
    return s[ok].cpu().numpy(), (e - s)[ok].cpu().numpy()


class Mix:
    def __init__(self, spec: dict, db: Database, seed: int, device):
        rng = np.random.default_rng([seed, 1])
        self.db = db
        self.starts, self.lengths = digest(db, spec, device)
        lo, hi = spec["patterns_per_query"]
        self.sizes = size_schedule(lo, hi, int(spec["size_steps"]),
                                   int(spec["max_queries"]), rng)
        self.il = bool(spec.get("il_ambiguous"))
        self.rng = np.random.default_rng([seed, 2])

    def _query(self, m: int, rng: np.random.Generator) -> Query:
        pick = np.unique(rng.integers(0, len(self.starts), m + m // 8 + 8))
        while len(pick) < m:
            pick = np.union1d(pick, rng.integers(0, len(self.starts), m))
        pick = rng.permutation(pick)[:m]
        res, cut = letters_at(self.db, self.starts[pick], self.lengths[pick])
        if self.il:
            flip = np.isin(res, (ord("I"), ord("L"))) \
                & (rng.random(len(res)) < 0.5)
            res = np.where(flip, ord("I") + ord("L") - res, res)
        return Query(pieces(res, cut))

    def queries(self):
        for m in self.sizes:
            yield self._query(int(m), self.rng)

    def warmup(self) -> list[Query]:
        rng = np.random.default_rng(0)
        return [self._query(int(m), rng)
                for m in sorted({self.sizes.min(), self.sizes.max()})]


def least_seconds(db: Database, search: dict, patterns: list[str],
                  hits: int) -> float:
    """Bytes alone: the proteins and the peptides at log2 of the letters
    the search tells apart (I and L one letter under ``charmap`` 2), the
    hits."""
    alphabet = db.table.decode()[:-1]
    letters = len(alphabet) - (1 if int(search.get("charmap", 0)) == 2
                               and "I" in alphabet and "L" in alphabet
                               else 0)
    return bytes_seconds(len(db), letters, patterns, int(search["k"]), hits)
