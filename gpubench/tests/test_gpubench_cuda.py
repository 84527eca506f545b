"""The harness on the card at a small size: the kernels' path is correct
and traced, and the reference gives the same answers on the card as on
the CPU.  Run on a machine with a card:

    python -m pytest -m cuda gpubench/tests
"""

import numpy as np
import pytest

from conftest import ROOT, TINY
from gpubench import databases, harness, mixes
from gpubench.reference import Reference

# past 2^26 positions the port's scanners leave the host machines for
# the kernels, as at the cells' full sizes
ON_CARD = {
    "primer_chr1.k1_panel": ({"positions": 1 << 27},
                             {"checked_queries": 4}),
    "peptide_sprot.map": ({"entries": 250_000, "residues": 250_000 * 361},
                          {"patterns_per_query": [2000, 3000],
                           "size_steps": 2, "checked_queries": 3}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(ON_CARD))
def test_run_on_the_card_is_correct_and_traced(cuda_device, workload):
    cfg_over, spec_over = ON_CARD[workload]
    r = harness.run_cell(ROOT, workload, 2**31 + 31, 1.0, True,
                         device=cuda_device, cfg_over=cfg_over,
                         spec_over=spec_over)
    assert r["correct"] is True
    assert r["device"]["busy_s"] > 0
    metrics = {k: m["value"] for k, m in r["metrics"].items()}
    assert 0 < metrics["kernel_roofline_pct"] <= 100
    assert metrics["launches_per_query"] >= 1
    assert r["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_reference_on_the_card_equals_the_cpu(cuda_device, workload):
    _b, _c, cfg, spec = harness.cell_files(ROOT, workload)
    cfg_over, spec_over = TINY[workload]
    cfg.update(cfg_over)
    spec.update(spec_over)
    db = databases.build(cfg, 41, "cpu")
    q = next(mixes.make(spec, db, 41, "cpu")[1].queries())
    on_card = Reference(db.codes, db.table, cuda_device).answer(
        spec["search"], q.patterns)
    on_cpu = Reference(db.codes, db.table, "cpu").answer(
        spec["search"], q.patterns)
    assert np.array_equal(on_card, on_cpu)
