"""The port's pigeonhole (k > 0) engines against the JAX package's.

``halves`` and ``bases`` run on a planted synthetic database through the
port's gated device route (plain PyTorch versions on the CPU,
``use_host = False``) and through the host rung, and must emit exactly
the JAX model's engine hits (``mesh=None``); the serving stream repeats
them per run.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu.models.primer_match import (
    PrimerMatchModel as JaxModel,
)
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
)
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.parallel.shard import make_mesh
from tests.test_torch_gate import mutate

TABLE = b"ACGT\n"
EOS = 4
PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "TCATGAAGTAAAC"]
# bench.py's primer set (its PATS)
BENCH_PATS = PATS[:5] + ["AAGAAAAGGGGGAAA", "TCATGAAGTAAAC",
                         "TTGGCTGCTGCCCCCAG", "AGAAAAGGGGGAAA",
                         "CTATTGATAAGGGAGTG"]


@pytest.fixture(scope="module")
def db():
    """2^16 random bases in three entries; each pattern and its reverse
    complement planted exact and with 1 and 2 edits, adjacent duplicates
    (the 2k dedup window), one copy split by EOS, one at the end."""
    from sequence_alignment_tools_tpu.utils.iupac import reverse_comp

    rng = np.random.default_rng(17)
    n = 1 << 16
    codes = rng.integers(0, 4, size=n).astype(np.uint8)

    def put(at, s):
        codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]

    at = 120
    for p in PATS:
        for s in (p, reverse_comp(p)):
            for nmut in (0, 1, 2, 1):
                put(at, mutate(rng, s, nmut, nmut != 1) if nmut else s)
                at += 800
    put(at, PATS[0])
    put(at + len(PATS[0]) + 1, PATS[0])
    split = at + 600
    put(split, PATS[1])
    codes[[0, 21_000, 43_000, split + 5]] = EOS
    put(n - len(PATS[2]), PATS[2])
    starts = np.array([1, 21_001, 43_001])
    return SeqDB(codes=codes, table=TABLE, entry_starts=starts,
                 entry_lengths=np.array([20_999, 21_999, n - 43_001]),
                 headers=["e1 one", "e2 two", "e3 three"])


def pattern_set(engine, k):
    ps = build_pattern_set(PATS, rev_comp=True)
    if engine == "bases":
        # exact_bases needs esb/eeb constraints to pick its seeds
        for pid in range(1, ps.n_total + 1):
            if pid % 2:
                ps.esb[pid] = max(len(ps.pattern(pid)) - k - 3, 1)
            else:
                ps.eeb[pid] = max(len(ps.pattern(pid)) - k - 3, 1)
    return ps


CASES = [("halves", 1, True, 0), ("halves", 1, False, 0),
         ("halves", 2, True, 11), ("halves", 2, False, 11),
         ("bases", 1, True, 8), ("bases", 2, True, 8), ("bases", 1, False, 8)]


@pytest.fixture
def gated_calls(monkeypatch):
    """Counts the port scanner's gated scans."""
    calls = []
    real = ConvScanner.scan_gated

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(ConvScanner, "scan_gated", spy)
    return calls


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("engine,k,indels,node", CASES,
                         ids=lambda v: str(v))
def test_engine_hits_match_jax(db, engine, k, indels, node, route,
                               gated_calls, monkeypatch):
    monkeypatch.setenv("SAT_HOST_SCAN", "1")
    ps = pattern_set(engine, k)
    use_host = False if route == "device" else None
    ref = JaxModel(db, ps, k=k, indels=indels, node=node, mesh=None)
    ref.use_host = use_host
    want = list(ref.engine_hits())
    m = PrimerMatchModel(db, ps, k=k, indels=indels, node=node, device="cpu")
    m.use_host = use_host
    assert m.engine == engine
    assert list(m.engine_hits()) == want
    assert len(want) >= 2 * len(PATS)
    assert len(gated_calls) == (1 if route == "device" else 0)


@pytest.mark.parametrize("engine,k,indels,node", [CASES[0], CASES[4]],
                         ids=lambda v: str(v))
def test_stream_repeats_engine_hits(db, engine, k, indels, node):
    ps = pattern_set(engine, k)
    m = PrimerMatchModel(db, ps, k=k, indels=indels, node=node, device="cpu")
    m.use_host = False
    want = list(m.engine_hits())
    assert want
    assert list(m.engine_hits_stream(3)) == [want] * 3
    ends, pids, vals = m.engine_hits_arrays()
    assert list(zip(ends.tolist(), pids.tolist(), vals.tolist())) == want


def test_final_hits_match_jax(db):
    """hits() re-verifies each engine hit with the final aligner."""
    ps = pattern_set("halves", 1)
    ref = JaxModel(db, ps, k=1, mesh=None)
    m = PrimerMatchModel(db, ps, k=1, device="cpu")
    m.use_host = ref.use_host = False
    want = [(h.pid, h.end, h.alignment.editdist()) for h in ref.hits()]
    got = [(h.pid, h.end, h.alignment.editdist()) for h in m.hits()]
    assert got == want and want


def test_bench_primers_select_halves(db):
    """bench.py's k1_edit row: its primers with -r at k = 1 take the
    halves engine."""
    ps = build_pattern_set(BENCH_PATS, rev_comp=True)
    assert PrimerMatchModel(db, ps, k=1, device="cpu").engine == "halves"
    assert JaxModel(db, ps, k=1, mesh=None).engine == "halves"


@pytest.mark.parametrize("k,node,engine", [(1, 6, "hash"), (1, 15, "gs")])
def test_unported_engines_raise(db, k, node, engine):
    """No engine is left to raise: ``hash`` and ``gs`` build and run,
    and under a device mesh (the sharded rungs) emit the same hits."""
    ps = build_pattern_set(PATS, rev_comp=True)
    m = PrimerMatchModel(db, ps, k=k, indels=False, node=node, device="cpu")
    assert m.engine == engine
    assert list(m.engine_hits()) == list(JaxModel(
        db, ps, k=k, indels=False, node=node, mesh=None).engine_hits())
    meshed = PrimerMatchModel(db, ps, k=k, indels=False, node=node,
                              mesh=make_mesh(["cpu"] * 3), device="cpu")
    assert list(meshed.engine_hits()) == list(m.engine_hits())


@pytest.mark.parametrize("k,node,engine", [(1, 6, "hash"), (1, 15, "gs")])
def test_seed_table_engines_stream(db, k, node, engine):
    """The serving stream of the seed-table engines repeats their
    per-run hits (it used to take the exact engines' scan stream)."""
    ps = build_pattern_set(PATS, rev_comp=True)
    m = PrimerMatchModel(db, ps, k=k, indels=False, node=node, device="cpu")
    assert m.engine == engine
    want = list(JaxModel(db, ps, k=k, indels=False, node=node,
                         mesh=None).engine_hits())
    assert list(m.engine_hits_stream(2)) == [want] * 2
