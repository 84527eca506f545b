"""Reference of ``primer_match`` / ``peptide_scan`` at k = 0 (the
keyword tree engine): every exact occurrence of every pattern, one hit
per (end, pattern), an occurrence never spanning the end-of-sequence
code; under ``charmap`` 2, I and L are one letter in the text and the
patterns alike (the text folded block by block as it is scanned)."""

from __future__ import annotations

import numpy as np

from .scan import occurrences, pattern_codes, reverse_complement, rows


def fold_of(table: bytes, charmap: int):
    """Code -> code it is searched as: I as L under ``charmap`` 2."""
    fold = np.arange(len(table), dtype=np.int64)
    if charmap == 2 and b"I" in table and b"L" in table:
        fold[table.index(b"I")] = table.index(b"L")
    return fold if charmap else None


def answer(ref, search: dict, patterns: list[str]) -> np.ndarray:
    pats = list(patterns)
    if search.get("rev_comp"):
        pats += [reverse_complement(p) for p in patterns]
    return exact_hits(ref.codes_t, ref.codes, ref.table, pats, ref.eos,
                      fold_of(ref.table, int(search.get("charmap", 0))))


def exact_hits(codes_t, codes_np, table: bytes, pats, eos: int,
               fold=None) -> np.ndarray:
    """Every exact occurrence of each pattern (ids 1..len(pats)), with
    ``fold`` applied to the text and the patterns alike."""
    pc = pattern_codes(pats, table, fold)
    ends, p0 = occurrences(codes_t, codes_np, pc, len(table), eos, fold)
    return rows(ends, p0 + 1, np.zeros(len(ends), np.int64))
