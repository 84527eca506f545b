"""A run with the timed path broken underneath comes out not correct:
one test for each fault the cells can have, and the control (the plain
reference with one of the configuration's guarantees broken, in the
program's place), on one card and on a mesh of four shards.  The look
for a card is skipped; the program runs on the CPU at a tiny size.  The
faults are the entry's ``Program(db, search, devices)`` with its query
broken."""

from dataclasses import dataclass
from functools import partial

import pytest

from conftest import ROOT, TINY
from gpubench import harness
from gpubench.control import ControlProgram
from gpubench.entries.primer_match_model import Program


@dataclass
class _Alignment:
    end: int
    edits: int

    def editdist(self):
        return self.edits


@dataclass
class _Hit:
    pid: int
    alignment: _Alignment

    @property
    def end(self):
        return self.alignment.end


class AlteredHit(Program):
    """One hit of each query reports an end one past its own."""

    def query(self, patterns, phases=None):
        hits = super().query(patterns, phases)
        if hits:
            h = hits[len(hits) // 2]
            hits[len(hits) // 2] = _Hit(h.pid, _Alignment(
                h.end + 1, h.alignment.editdist()))
        return hits


class HalfLeftOut(Program):
    """Half of each query's patterns left out."""

    def query(self, patterns, phases=None):
        return super().query(patterns[: len(patterns) // 2], phases)


class Unchanged(Program):
    """Each query answered with nothing, as if the scan never ran."""

    def query(self, patterns, phases=None):
        super().query(patterns[:1], phases)
        return []


class ExchangeLeftOut(Program):
    """On a mesh, only the first card's shard answers: the hits the other
    cards find never reach the client."""

    def query(self, patterns, phases=None):
        hits = super().query(patterns, phases)
        shard = -(-len(self.db.codes) // self.mesh.size)
        return [h for h in hits if h.end <= shard]


def run(workload, program_cls, seed=2**31 + 21, chips=None):
    """A run at the tiny size, on the cell's own number of cards or on
    ``chips`` (entries of the CPU)."""
    cfg_over, spec_over = TINY[workload]
    return harness.run_cell(ROOT, workload, seed, 0.5, False, device="cpu",
                            cfg_over=cfg_over, spec_over=spec_over,
                            cell_over={"chips": chips} if chips else None,
                            program_cls=program_cls)


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("fault", [AlteredHit, HalfLeftOut, Unchanged],
                         ids=["hit-altered", "half-left-out", "unchanged"])
def test_a_broken_path_is_not_correct(workload, fault):
    r = run(workload, fault)
    assert r["correct"] is False
    assert r["checks"]["missing_hits"]["value"] > 0


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_sound_path_is_correct(workload):
    r = run(workload, None)
    assert r["correct"] is True
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22])
def test_the_control_is_not_correct(workload, seed):
    spec = harness.cell_files(ROOT, workload)[3]
    r = run(workload, partial(ControlProgram, control=spec["control"]), seed)
    assert r["correct"] is False
    checks = r["checks"]
    assert checks["missing_hits"]["value"] + checks["extra_hits"]["value"] > 0


@pytest.mark.parametrize("fault", [AlteredHit, HalfLeftOut, Unchanged,
                                   ExchangeLeftOut],
                         ids=["hit-altered", "half-left-out", "unchanged",
                              "exchange-left-out"])
def test_a_broken_path_on_four_shards_is_not_correct(fault):
    r = run("primer_chr1.k1_panel", fault, chips=4)
    assert r["device"]["count"] == 4
    assert r["correct"] is False
    assert r["checks"]["missing_hits"]["value"] > 0


def test_the_control_on_four_shards_is_not_correct():
    spec = harness.cell_files(ROOT, "primer_chr1.k1_panel")[3]
    r = run("primer_chr1.k1_panel",
            partial(ControlProgram, control=spec["control"]), chips=4)
    assert r["correct"] is False
    checks = r["checks"]
    assert checks["missing_hits"]["value"] + checks["extra_hits"]["value"] > 0
