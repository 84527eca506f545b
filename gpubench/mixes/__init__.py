"""Queries of the benchmark's traffic mixes, drawn from the seed.

A traffic file (``traffic/<traffic>.json``) names its ``kind``; the module
``mixes/<kind>.py`` holds the mix's generator and its work function:

- ``Mix(spec, db, seed, device)`` reads the file's parameters, prepares
  what the mix needs from the database in set-up, and draws the whole
  query list from the seed: ``queries()`` yields them in order,
  ``warmup()`` gives a query of each size the list holds at its ends,
  drawn apart from it, and ``sizes`` holds the patterns a query;
- ``least_seconds(db, search, patterns, hits)`` is the yardstick of
  ``kernel_roofline_pct``: the least time the card could take to answer
  one query, counted from the problem alone, never from the route that
  serves it.

A later mix of a new kind adds that module and edits none; one of a kind
that is here is a data file alone.  Every seed gets the same multiset of
query sizes, in its own order, so two seeds do the same amount of work.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import numpy as np

from ..databases import Database

# the H100 SXM data sheet: HBM bytes per second
PEAK_BYTES = 3.35e12


@dataclass
class Query:
    patterns: list[str]


def make(spec: dict, db: Database, seed: int, device):
    """The traffic module of ``spec`` and its mix over ``db``."""
    kind = importlib.import_module(f"{__name__}.{spec['kind']}")
    return kind, kind.Mix(spec, db, seed, device)


def size_schedule(lo: int, hi: int, steps: int, count: int,
                  rng: np.random.Generator) -> np.ndarray:
    """``count`` sizes: blocks of the ``steps`` evenly spaced sizes from
    ``lo`` to ``hi``.  Within a block the sizes come in pairs that add up
    to ``lo + hi`` (the middle one alone where ``steps`` is odd), the
    pairs in random order and each pair either way round, so any run of
    queries holds about the same work whichever seed drew it."""
    grid = np.rint(np.linspace(lo, hi, steps)).astype(np.int64)
    pairs = [[grid[i], grid[steps - 1 - i]] for i in range(steps // 2)]
    if steps % 2:
        pairs.append([grid[steps // 2]])
    out = []
    while len(out) < count:
        for j in rng.permutation(len(pairs)):
            out += pairs[j][::-1] if rng.random() < 0.5 else pairs[j]
    return np.asarray(out[:count], np.int64)


def bytes_seconds(n: int, letters: int, patterns: list[str], k: int,
                  hits: int) -> float:
    """The bytes a scan must move, at the data sheet's bandwidth: the
    database read once, at log2(letters) bits a position, the patterns at
    the same width, and each hit written once, its end, pattern and edit
    count at their widths.  No operation count is a floor for a
    multi-pattern scan (an automaton does a constant few per position),
    so the bound is the bytes alone."""
    bits = math.log2(letters)
    read = (n + sum(len(p) for p in patterns)) * bits / 8
    hit_bits = (math.ceil(math.log2(max(n, 2)))
                + math.ceil(math.log2(len(patterns) * 2 + 1))
                + math.ceil(math.log2(k + 2)))
    return (read + hits * hit_bits / 8) / PEAK_BYTES


def letters_at(db: Database, starts, lengths):
    """The database's letters at each (start, length), end to end, as a
    uint8 array, and the offsets that cut it into pieces."""
    ln = np.asarray(lengths, np.int64)
    pos = np.repeat(np.asarray(starts, np.int64) - np.cumsum(ln) + ln, ln) \
        + np.arange(int(ln.sum()))
    letters = np.frombuffer(db.table, np.uint8)[db.codes[pos]]
    return letters, np.concatenate([[0], np.cumsum(ln)])


def pieces(letters: np.ndarray, cut: np.ndarray) -> list[str]:
    """``letters`` cut at ``cut``, as strings."""
    text = bytes(letters.astype(np.uint8)).decode()
    return [text[cut[i]:cut[i + 1]] for i in range(len(cut) - 1)]
