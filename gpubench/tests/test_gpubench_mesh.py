"""A cell at four cards, on the CPU: the harness hands the program four
entries of the CPU, which the port's mesh takes as four position shards.
The run is correct, takes the sharded route, reports four cards, and the
shards answer the seed's queries with the rows one card gives."""

import numpy as np

from conftest import ROOT, TINY
from gpubench import databases, harness, mixes
from gpubench.entries.primer_match_model import Program

CELL = "primer_chr1.k1_panel"
SEED = 2**31 + 51


def test_panel_on_four_shards_is_correct():
    cfg_over, spec_over = TINY[CELL]
    r = harness.run_cell(ROOT, CELL, SEED, 1.0, False, device="cpu",
                         cfg_over=cfg_over, spec_over=spec_over,
                         cell_over={"chips": 4})
    assert r["correct"] is True
    assert r["info"]["engine"] == "halves"
    assert any("sharded over 4 devices" in x for x in r["info"]["routes"])
    assert r["device"]["count"] == 4
    assert r["device"]["memory_peak_bytes_per_card"] == [0] * 4


def test_four_shards_give_the_rows_of_one():
    _b, _c, cfg, spec = harness.cell_files(ROOT, CELL)
    cfg_over, spec_over = TINY[CELL]
    cfg.update(cfg_over)
    spec.update(spec_over)
    db = databases.build(cfg, SEED, "cpu")
    queries = mixes.make(spec, db, SEED, "cpu")[1].queries()
    one = Program(db, spec["search"], harness.cell_devices("cpu", 1))
    four = Program(db, spec["search"], harness.cell_devices("cpu", 4))
    assert one.mesh is None and four.mesh.size == 4
    total = 0
    for _ in range(3):
        q = next(queries)
        want = one.rows(one.query(q.patterns))
        got = four.rows(four.query(q.patterns))
        assert np.array_equal(got, want)
        total += len(want)
    assert total > 0
    assert one.engine == four.engine == "halves"
