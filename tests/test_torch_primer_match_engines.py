"""The port's seed-table engines and many-pattern k = 1 run against the
JAX package's.

- ``hash`` (hash_table: every seed-length window of every pattern) and
  ``gs`` (gs_hash_table: gapped seed templates) must emit exactly the JAX
  model's engine hits and final hits, through the device route (plain
  PyTorch versions on the CPU, ``use_host = False``: the census rung for
  the dense seeds of a large scan, the fused and pattern-blocked rungs for
  the templates) and through the host rung; the CLI prints the JAX CLI's
  bytes for ``-N 6`` and ``-N 15``.
- 3,000 patterns at k = 1 (6,000 half seeds): ``engine_hits_arrays``
  equals ``engine_hits`` and the JAX model's, through the slots route
  (``scan_slots``, ``gate_slots``) and through the native census with its
  inline gate.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.apps import primer_match as jax_app
from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu.models import primer_match as jax_model
from sequence_alignment_tools_tpu.models.primer_match import (
    PrimerMatchModel as JaxModel,
)
from sequence_alignment_tools_tpu.utils.iupac import reverse_comp
from sequence_alignment_tools_tpu_torch.apps import primer_match as torch_app
from sequence_alignment_tools_tpu_torch.models import primer_match as model
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
    SelectionError,
)
from sequence_alignment_tools_tpu_torch.native import load_shift_and_lib
from sequence_alignment_tools_tpu_torch.ops import gapped_seeds
from tests.test_torch_census import corpus, drawn  # noqa: F401 (fixture)
from tests.test_torch_gate import mutate
from tests.test_torch_primer_match_cli import inputs  # noqa: F401 (fixture)
from tests.test_torch_primer_match_k import PATS, db  # noqa: F401 (fixture)

TABLE = b"ACGT\n"


def both(db, ps, use_host, **kw):
    """(port engine hits, JAX engine hits, port model, JAX model)."""
    m = PrimerMatchModel(db, ps, device="cpu", **kw)
    m.use_host = use_host
    j = JaxModel(db, ps, mesh=None, **kw)
    return list(m.engine_hits()), list(j.engine_hits()), m, j


def final(m):
    return [(h.pid, h.end, h.alignment.editdist()) for h in m.hits()]


@pytest.mark.parametrize("use_host", [False, None], ids=["device", "host"])
@pytest.mark.parametrize("k,indels,seedlen", [(1, True, 0), (1, False, 0),
                                              (2, True, 6), (0, True, 0)])
def test_hash_engine_matches_jax(db, k, indels, seedlen, use_host):  # noqa: F811
    ps = build_pattern_set(PATS, rev_comp=True)
    got, want, m, j = both(db, ps, use_host, k=k, indels=indels,
                           seedlen=seedlen, node=6)
    assert m.engine == j.engine == "hash"
    assert len(want) >= 2 * len(PATS)
    assert got == want
    if k:
        assert final(m) == final(j)


def test_hash_engine_takes_the_census(corpus, monkeypatch):  # noqa: F811
    """On a scan past 2^18 positions the 4-base seeds are dense: the
    device route is the census rung."""
    big, text = corpus
    pats = [text[at : at + 15] for at in (1200, 90_500, 222_000)]
    assert all(p.isalpha() for p in pats)
    ps = build_pattern_set(pats, rev_comp=True)
    routes = []
    real = model.ConvScanner._route
    monkeypatch.setattr(model.ConvScanner, "_route",
                        lambda self, msg: routes.append(msg)
                        or real(self, msg))
    got, want, _m, _j = both(big, ps, False, k=1, indels=True, node=6)
    assert got == want and len(want) >= len(pats)
    assert len(routes) == 1 and routes[0].startswith("census kernel")


@pytest.mark.parametrize("use_host", [False, None], ids=["device", "host"])
@pytest.mark.parametrize("k,indels", [(2, False), (1, False)])
def test_gs_engine_matches_jax(db, k, indels, use_host):  # noqa: F811
    ps = build_pattern_set(PATS, rev_comp=True)
    got, want, m, j = both(db, ps, use_host, k=k, indels=indels, node=15)
    assert m.engine == j.engine == "gs"
    assert len(want) >= 2 * len(PATS)
    assert got == want
    assert final(m) == final(j)


@pytest.fixture(scope="module")
def long_db():
    """6,000 random bases; 24 primers of 28 bases drawn from them, each
    also planted with one and with two edits."""
    rng = np.random.default_rng(31)
    n = 6_000
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    pats = ["".join("ACGT"[c] for c in codes[100 + 240 * i : 128 + 240 * i])
            for i in range(24)]
    for i, p in enumerate(pats):
        for off, nmut in ((80, 1), (160, 2)):
            s = mutate(rng, p if i % 2 else reverse_comp(p), nmut, True)
            at = 100 + 240 * i + off
            codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
    codes[[0, 2_999]] = 4
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([1, 3_000]),
               entry_lengths=np.array([2_998, 3_000]),
               headers=["l1 one", "l2 two"])
    return db, pats


@pytest.mark.parametrize("count,use_host", [(4, False), (4, None),
                                            (24, False)],
                         ids=["fused", "host", "pattern-blocked"])
def test_gs_engine_edits_matches_jax(long_db, count, use_host):
    """k = 2 edits need patterns of at least 19 bases (scheme m20k2l10S,
    9 templates); 24 primers with reverse complements register 3,888
    template rows, past one fused pass."""
    db, pats = long_db
    ps = build_pattern_set(pats[:count], rev_comp=True)
    got, want, m, j = both(db, ps, use_host, k=2, indels=True, node=15)
    assert gapped_seeds.select(ps.min_len, 2, True).name == "m20k2l10S"
    assert len(want) >= 2 * count
    assert got == want
    if use_host is None:
        assert final(m) == final(j)


def test_gs_engine_without_scheme_exits(db):  # noqa: F811
    """13-base primers have no k = 2 edit scheme: both models exit."""
    ps = build_pattern_set(PATS, rev_comp=True)
    with pytest.raises(SelectionError):
        list(PrimerMatchModel(db, ps, k=2, indels=True, node=15,
                              device="cpu").engine_hits())
    with pytest.raises(SystemExit):
        list(JaxModel(db, ps, k=2, indels=True, node=15,
                      mesh=None).engine_hits())


def test_gapped_seeds_copy_matches_jax():
    from sequence_alignment_tools_tpu.ops import gapped_seeds as jax_gs

    assert sorted(gapped_seeds.SCHEMES) == sorted(jax_gs.SCHEMES)
    for name, sch in jax_gs.SCHEMES.items():
        got = gapped_seeds.SCHEMES[name]
        assert (got.m, got.l, got.n, got.k, got.indels, got.patpos,
                got.txtpos) == (sch.m, sch.l, sch.n, sch.k, sch.indels,
                                sch.patpos, sch.txtpos)
    for m in (5, 9, 13, 19, 20, 30):
        for k in (0, 1, 2, 3, 4):
            for indels in (True, False):
                a, b = gapped_seeds.select(m, k, indels), jax_gs.select(
                    m, k, indels)
                assert (a and a.name) == (b and b.name)


@pytest.mark.parametrize("k,indels,node,seedlen", [
    (1, True, 6, 0), (1, True, 6, 12), (2, False, 15, 0), (1, False, 15, 0),
    (2, True, 15, 0)])
def test_select_report_matches_jax(db, k, indels, node, seedlen):  # noqa: F811
    ps = build_pattern_set(PATS, rev_comp=True)
    args = (db, ps, k, False, False, seedlen, node, indels, False)
    want = jax_model.select_report(*args)
    assert model.select_report(*args) == want
    assert any(line.startswith("Using") for line in want) or node == 15


CLI = [["-N", "6", "-k", "1"], ["-N", "6", "-k", "1", "-r", "-x", "6"],
       ["-N", "6", "-K", "1", "-r", "-c"], ["-N", "15", "-K", "2", "-r"],
       ["-N", "15", "-K", "1", "-r", "-c"]]


@pytest.mark.parametrize("host_scan,flags",
                         [("0", f) for f in CLI] + [("1", CLI[0]),
                                                    ("1", CLI[3])],
                         ids=lambda v: v if isinstance(v, str)
                         else " ".join(v))
def test_cli_parity_seed_table_engines(inputs, flags, host_scan,  # noqa: F811
                                       capsys, monkeypatch):
    fasta, words, _ = inputs
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    monkeypatch.setenv("SAT_MESH", "0")
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    argv = ["-i", fasta, "-P", words] + flags
    capsys.readouterr()
    assert jax_app.main(argv) == 0
    want = capsys.readouterr().out
    assert torch_app.main(argv) == 0
    assert want.count("\n") >= 4
    assert capsys.readouterr().out == want


@pytest.fixture(scope="module")
def many_patterns(corpus):  # noqa: F811
    _db, text = corpus
    return drawn(text, 3000, 20, 28, seed=5)


@pytest.mark.parametrize("use_host", [False, None],
                         ids=["slots-route", "native-census"])
def test_many_pattern_k1_arrays(corpus, many_patterns, use_host,  # noqa: F811
                                monkeypatch):
    if use_host is None and load_shift_and_lib() is None:
        pytest.skip("native toolchain unavailable")
    big, _text = corpus
    ps = build_pattern_set(many_patterns, rev_comp=False)
    routes = []
    real = model.ConvScanner._route
    monkeypatch.setattr(model.ConvScanner, "_route",
                        lambda self, msg: routes.append(msg)
                        or real(self, msg))
    m = PrimerMatchModel(big, ps, k=1, indels=True, device="cpu")
    m.use_host = use_host
    assert m.engine == "halves"
    ends, pids, vals = m.engine_hits_arrays()
    assert routes[0].startswith(
        "gated seed census + slot gate (6000 seeds"
        if use_host is False else "native threaded mer-hash census")
    assert ends.dtype == np.int64 and len(np.unique(pids)) >= 2990
    tuples = list(zip(ends.tolist(), pids.tolist(), vals.tolist()))
    assert list(m.engine_hits()) == tuples
    assert [list(run) for run in m.engine_hits_stream(2)] == [tuples] * 2
    j = JaxModel(big, ps, k=1, indels=True, mesh=None)
    jends, jpids, jvals = j.engine_hits_arrays()
    assert np.array_equal(ends, jends) and np.array_equal(pids, jpids) \
        and np.array_equal(vals, jvals)
