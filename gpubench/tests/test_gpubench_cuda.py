"""The harness on the card at a small size: the kernels' path is correct
and traced, on one card and on a mesh of four, and the reference gives
the same answers on the card as on the CPU.  Run on a machine with a
card (four for the mesh):

    python -m pytest -m cuda gpubench/tests
"""

import numpy as np
import pytest

from conftest import ON_CARD, ROOT, TINY
from gpubench import databases, harness, mixes
from gpubench.reference import Reference


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


@pytest.mark.cuda
def test_panel_on_four_cards_is_correct_and_traced(four_cards):
    cfg_over, spec_over = TINY["primer_chr1.k1_panel"]
    r = harness.run_cell(ROOT, "primer_chr1.k1_panel", 2**31 + 33, 1.0,
                         True, device=four_cards, cfg_over=cfg_over,
                         spec_over=spec_over, cell_over={"chips": 4})
    assert r["correct"] is True
    assert r["info"]["engine"] == "halves"
    assert any("sharded over 4 devices" in x for x in r["info"]["routes"])
    assert r["device"]["count"] == 4
    assert len(r["device"]["memory_peak_bytes_per_card"]) == 4
    assert r["device"]["memory_peak_bytes"] == max(
        r["device"]["memory_peak_bytes_per_card"])
    assert all(b > 0 for b in r["device"]["busy_s_per_card"])
