"""The roofline's yardstick against hand counts."""

import math

import pytest

import numpy as np

from gpubench.databases import Database
from gpubench.mixes import PEAK_BYTES, bytes_seconds, primer_panel
from gpubench.mixes import tryptic_peptides


def protein_db(n):
    return Database(np.zeros(n, np.uint8), b"ACDEFGHIKLMNPQRSTVWY\n",
                    np.zeros(1, np.int64), np.zeros(1, np.int64))


def test_protein_letters_follow_the_charmap():
    db, pats = protein_db(1000), ["PEPTIDEK"]
    for charmap, letters in ((2, 19), (0, 20)):
        got = tryptic_peptides.least_seconds(
            db, {"k": 0, "charmap": charmap}, pats, 0)
        assert got == bytes_seconds(1000, letters, pats, 0, 0)


def test_dna_query_by_hand():
    # 2^28 positions and two 20-mers at 2 bits; 100 hits of 28 bits
    # (end), 3 (pattern id: 4 patterns with both strands, and none) and 2
    # (edit count up to k = 1, and none)
    n = 1 << 28
    db = Database(np.zeros(n, np.uint8), b"ACGT\n", np.zeros(1, np.int64),
                  np.zeros(1, np.int64))
    got = primer_panel.least_seconds(db, {"k": 1}, ["A" * 20, "C" * 20],
                                     100)
    read = (n + 40) * 2 / 8
    hit = 100 * (28 + 3 + 2) / 8
    assert got == pytest.approx((read + hit) / PEAK_BYTES)
    assert got * 1e6 == pytest.approx(20.03, abs=0.01)


def test_protein_query_by_hand():
    n = 198_000_000
    pats = ["PEPTIDEK"] * 5000
    got = tryptic_peptides.least_seconds(protein_db(n),
                                         {"k": 0, "charmap": 2}, pats, 7000)
    bits = math.log2(19)
    read = (n + 8 * 5000) * bits / 8
    hit = 7000 * (28 + 14 + 1) / 8
    assert got == pytest.approx((read + hit) / PEAK_BYTES)
