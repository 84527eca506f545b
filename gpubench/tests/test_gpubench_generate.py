"""The configurations' databases and the traffic mixes: the same seed
gives the same database and queries, two seeds the same amount of work."""

import json
from pathlib import Path

import numpy as np
import pytest

from conftest import TINY
from gpubench import databases, mixes
from gpubench.databases.protein_db import lengths_of
from gpubench.mixes.tryptic_peptides import RESIDUE_MASS, WATER

HERE = Path(__file__).resolve().parents[1]


def cell(workload):
    cfg_name, traffic_name = workload.split(".")
    cfg = json.loads((HERE / "configs" / f"{cfg_name}.json").read_text())
    spec = json.loads((HERE / "traffic" / f"{traffic_name}.json")
                      .read_text())
    cfg_over, spec_over = TINY[workload]
    cfg.update(cfg_over)
    spec.update(spec_over)
    spec["max_queries"] = 60
    return cfg, spec


def draw(workload, seed, count=12):
    cfg, spec = cell(workload)
    db = databases.build(cfg, seed, "cpu")
    _kind, mix = mixes.make(spec, db, seed, "cpu")
    qs = []
    for q in mix.queries():
        qs.append(q.patterns)
        if len(qs) == count:
            break
    return db, mix, qs


@pytest.mark.parametrize("workload", sorted(TINY))
def test_same_seed_same_database_and_queries(workload):
    db1, _m1, q1 = draw(workload, 2**31 + 7)
    db2, _m2, q2 = draw(workload, 2**31 + 7)
    assert np.array_equal(db1.codes, db2.codes)
    assert q1 == q2
    db3, _m3, q3 = draw(workload, 2**31 + 8)
    assert not np.array_equal(db3.codes[:len(db1)], db1.codes[:len(db3)])
    assert q3 != q1


@pytest.mark.parametrize("workload", sorted(TINY))
def test_seeds_share_the_multiset_of_query_sizes(workload):
    sizes = [draw(workload, seed)[1].sizes for seed in (1, 2)]
    steps = len(np.unique(sizes[0]))
    whole = len(sizes[0]) // steps * steps
    assert sorted(sizes[0][:whole]) == sorted(sizes[1][:whole])
    if steps > 1:
        assert not np.array_equal(sizes[0], sizes[1])


def test_every_size_of_a_range_comes_in_each_block():
    spec = json.loads((HERE / "traffic" / "k1_panel.json").read_text())
    lo, hi = spec["pairs_per_query"]
    sizes = mixes.size_schedule(lo, hi, hi - lo + 1, 3 * (hi - lo + 1),
                                np.random.default_rng(0))
    for block in sizes.reshape(3, -1):
        assert sorted(block) == list(range(lo, hi + 1))


def test_dna_layout_and_primer_panels():
    db, mix, qs = draw("primer_chr1.k1_panel", 11)
    cfg, spec = cell("primer_chr1.k1_panel")
    assert len(db) == cfg["positions"]
    eos = np.flatnonzero(db.codes == db.eos)
    assert np.array_equal(eos, db.entry_starts - 1)
    assert set(np.unique(db.codes[db.codes != db.eos])) <= {0, 1, 2, 3}
    lo, hi = spec["pattern_length"]
    text = bytes(np.frombuffer(db.table, np.uint8)[db.codes]).decode()
    comp = str.maketrans("ACGT", "TGCA")
    for pats, m in zip(qs, mix.sizes):
        assert len(pats) == m and m % 2 == 0
        assert 32 <= m <= 48
        for i, p in enumerate(pats):
            assert lo <= len(p) <= hi
            # forward primers read from the database, reverse primers
            # from the other strand
            site = p if i % 2 == 0 else p.translate(comp)[::-1]
            assert site in text and "\n" not in site


def test_protein_lengths_add_up_to_the_residues():
    cfg, _spec = cell("peptide_sprot.map")
    full = json.loads((HERE / "configs" / "peptide_sprot.json").read_text())
    for c in (cfg, dict(full, entries=5700, residues=2_060_000)):
        lengths = lengths_of(c)
        assert len(lengths) == c["entries"]
        assert lengths.sum() == c["residues"] and lengths.min() >= 1
    db = databases.build(cfg, 3, "cpu")
    assert len(db) == cfg["residues"] + cfg["entries"]
    assert sorted(db.entry_lengths) == sorted(lengths_of(cfg))
    assert np.array_equal(np.flatnonzero(db.codes == db.eos),
                          db.entry_starts - 1)


def test_protein_layout_and_tryptic_peptides():
    db, mix, qs = draw("peptide_sprot.map", 12)
    cfg, spec = cell("peptide_sprot.map")
    assert len(db.entry_starts) == cfg["entries"]
    assert db.codes[0] == db.eos
    table = db.table.decode()
    text = bytes(np.frombuffer(db.table, np.uint8)[db.codes]).decode()
    folded = text.replace("I", "L")
    swapped = 0
    for pats in qs:
        assert len(set(pats)) >= len(pats) - 2
        for p in pats:
            mass = sum(RESIDUE_MASS[c] for c in p) + WATER
            assert len(p) >= 7 and mass <= spec["max_mass_da"]
            assert set(p) <= set(table[:-1])
            # a piece of the digest, I and L read either way
            assert p.replace("I", "L") in folded
            swapped += p not in text
    assert swapped > 0
    assert max(mix.lengths) > 25
    # each piece ends after K or R (not before P) or at its entry's end
    for s, ln in zip(mix.starts[:500], mix.lengths[:500]):
        last, nxt = text[s + ln - 1], text[s + ln] if s + ln < len(text) \
            else "\n"
        assert nxt == "\n" or (last in "KR" and nxt != "P")
        assert "\n" not in text[s:s + ln]
