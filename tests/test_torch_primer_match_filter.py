"""The port's filter engine (``-k 2``, ``-K 2``) against the JAX package's.

The k-edit filter engine takes its candidates from the Myers scan (the
bench primers: short patterns packed two to a word) or from the Sellers
scan (long primers, 32 to 40 bases), the k-mismatch one (``-K``) from the
poisoned conv scan; each then runs the batch / cluster / verify host
tail.  On a planted synthetic database the port's engine hits (device
route with the plain PyTorch versions on the CPU, and host route), its
serving stream, its final hits and its CLI bytes (``SAT_HOST_SCAN=0``
and ``1``) must equal the JAX package's exactly.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.apps import primer_match as jax_app
from sequence_alignment_tools_tpu.io.database import SeqDB as JaxSeqDB
from sequence_alignment_tools_tpu.io.patterns import (
    build_pattern_set as jax_build_pattern_set,
)
from sequence_alignment_tools_tpu.models.primer_match import (
    PrimerMatchModel as JaxModel,
)
from sequence_alignment_tools_tpu.ops.sellers import (
    SellersScanner as JaxSellers,
)
from sequence_alignment_tools_tpu.ops.tables import (
    build_tables as jax_build_tables,
)
from sequence_alignment_tools_tpu_torch.apps import primer_match as torch_app
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
)
from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp
from tests.conftest import make_synthetic_fasta
from tests.test_torch_gate import mutate

TABLE = b"ACGT\n"
EOS = 4
# bench.py's primer set (its PATS), cut to six
PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "TCATGAAGTAAAC"]
_RNG = np.random.default_rng(99)
# long primers: the Myers kernel takes no field past 31 bases
LONG = ["".join("ACGT"[c] for c in _RNG.integers(0, 4, size=ln))
        for ln in (32, 35, 38, 40)]


def _codes(rng, n, sets):
    """Seeded codes with every pattern of ``sets`` and its reverse
    complement planted exact and with 1 and 2 edits; one copy split by
    EOS and one at the end."""
    codes = rng.integers(0, 4, size=n).astype(np.uint8)

    def put(at, s):
        codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]

    at = 150
    for p in [q for pats in sets for q in pats]:
        for s in (p, reverse_comp(p)):
            for nmut in (0, 1, 2):
                put(at, mutate(rng, s, nmut, True) if nmut else s)
                at += 300
    split = at + 400
    put(split, PATS[1])
    codes[[0, 9_000, 21_000, split + 6]] = EOS
    put(n - len(PATS[2]), PATS[2])
    return codes


@pytest.fixture(scope="module")
def dbs():
    """(JAX SeqDB, port SeqDB) over 2^15 planted bases in three entries."""
    n = 1 << 15
    codes = _codes(np.random.default_rng(23), n, (PATS, LONG))
    kw = dict(codes=codes, table=TABLE,
              entry_starts=np.array([1, 9_001, 21_001]),
              entry_lengths=np.array([8_999, 11_999, n - 21_001]),
              headers=["e1 one", "e2 two", "e3 three"])
    return JaxSeqDB(**kw), SeqDB(**kw)


# (name, patterns, k, indels): the Myers route, -K, a wider k, the
# Sellers route
CASES = [("k2", PATS, 2, True), ("K2", PATS, 2, False),
         ("k3", PATS, 3, True), ("k2-long", LONG, 2, True)]


def models(dbs, pats, k, indels, use_host):
    jdb, pdb = dbs
    ref = JaxModel(jdb, jax_build_pattern_set(pats, rev_comp=True), k=k,
                   indels=indels, mesh=None)
    ref.use_host = use_host
    m = PrimerMatchModel(pdb, build_pattern_set(pats, rev_comp=True), k=k,
                         indels=indels, device="cpu")
    m.use_host = use_host
    return ref, m


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("name,pats,k,indels", CASES,
                         ids=[c[0] for c in CASES])
def test_engine_hits_match_jax(dbs, name, pats, k, indels, route,
                               monkeypatch):
    monkeypatch.setenv("SAT_HOST_SCAN", "1")
    ref, m = models(dbs, pats, k, indels, False if route == "device"
                    else None)
    assert m.engine == ref.engine == "filter"
    want = list(ref.engine_hits())
    assert list(m.engine_hits()) == want
    assert len(want) >= 2 * len(pats)
    if indels:
        scanner = m._filter_ctx()[0]
        assert scanner.myers_available(1 << 15) == (pats is PATS)
        assert scanner._host_eligible(1 << 15) == (route == "host")


@pytest.mark.parametrize("name,pats,k,indels", [CASES[0], CASES[1]],
                         ids=["k2", "K2"])
def test_stream_repeats_engine_hits(dbs, name, pats, k, indels):
    _ref, m = models(dbs, pats, k, indels, False)
    want = list(m.engine_hits())
    assert want
    try:
        assert list(m.engine_hits_stream(3)) == [want] * 3
    finally:
        m.close()


def test_tail_pool_large_messages():
    """Requests and results of megabytes through two lanes, more requests
    than lanes in flight: the pool must neither deadlock on its pipes nor
    reorder the runs."""
    from sequence_alignment_tools_tpu_torch.parallel.tailproc import (
        FilterTailPool,
    )

    n = 1 << 18
    codes = np.ones(n, np.uint8)  # C
    for at in range(3, n - 20, 19):
        codes[at : at + 13] = 0  # a 13-base run of A every 19 positions
    codes[0] = EOS
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([1]),
               entry_lengths=np.array([n - 1]), headers=["a"])
    m = PrimerMatchModel(db, build_pattern_set(["A" * 13]), k=2,
                         device="cpu")
    sends, spids = m._filter_ctx()[0].scan_pairs(codes)
    assert len(sends) > 60_000
    want = list(m._filter_emit(sends, spids))
    assert len(want) > 10_000
    pool = FilterTailPool(m, lanes=2)
    try:
        for _ in range(5):
            pool.submit(sends, spids)
        assert [pool.result() for _ in range(5)] == [want] * 5
    finally:
        pool.close()


def test_final_hits_match_jax(dbs):
    """hits() re-verifies each engine hit with the final aligner."""
    ref, m = models(dbs, PATS, 2, True, False)
    want = [(h.pid, h.end, h.alignment.editdist()) for h in ref.hits()]
    got = [(h.pid, h.end, h.alignment.editdist()) for h in m.hits()]
    assert got == want and want


@pytest.mark.parametrize("pats", [PATS, LONG], ids=["myers", "sellers"])
def test_scanner_matches_jax(dbs, pats):
    """``scan_pairs`` (Myers or Sellers route) gives the JAX block DP's
    candidate set, ``scan`` its (end, pid, mindist) stream in order."""
    jdb, pdb = dbs
    jt = jax_build_tables(jax_build_pattern_set(pats, rev_comp=True), jdb,
                          wc=False, textn=False)
    want = list(JaxSellers(jt, k=2, indels=True).scan(jdb.codes))
    sc = SellersScanner(build_tables(build_pattern_set(pats, rev_comp=True),
                                     pdb, wc=False, textn=False),
                        k=2, device="cpu")
    assert sc.myers_available(len(pdb.codes)) == (pats is PATS)
    ends, pids = sc.scan_pairs(pdb.codes)
    assert set(zip(ends.tolist(), pids.tolist())) == {
        (e, p) for e, p, _ in want}
    assert list(sc.scan(pdb.codes)) == want
    got = list(sc.scan_pairs_stream(pdb.codes for _ in range(2)))
    assert [i for i, _e, _p in got] == [0, 1]
    for _i, e, p in got:
        assert sorted(zip(e.tolist(), p.tolist())) == sorted(
            zip(ends.tolist(), pids.tolist()))


# -- CLI bytes ---------------------------------------------------------------

FLAGS = [["-k", "2", "-r"], ["-k", "2", "-r", "-c"], ["-K", "2", "-r"],
         ["-K", "2", "-r", "-c"], ["-k", "3", "-r", "-c"]]


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pm_filter")
    rng = np.random.default_rng(31)
    planted = []
    at = 800
    for p in PATS[:4] + LONG[:2]:
        for s in (p, reverse_comp(p)):
            for nmut in (0, 1, 2):
                planted.append((at, mutate(rng, s, nmut, True)
                                if nmut else s))
                at += 450
    fasta = str(d / "db.fasta")
    make_synthetic_fasta(fasta, n_entries=3, total=30_000, planted=planted,
                         seed=41)
    words = d / "pats.txt"
    words.write_text("\n".join(PATS[:4]) + "\n")
    long_words = d / "long.txt"
    long_words.write_text("\n".join(LONG[:2]) + "\n")
    return fasta, str(words), str(long_words)


def _both(argv, capsys, monkeypatch, host_scan):
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    monkeypatch.setenv("SAT_MESH", "0")
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    capsys.readouterr()
    assert jax_app.main(argv) == 0
    want = capsys.readouterr().out
    assert torch_app.main(argv) == 0
    got = capsys.readouterr().out
    return want, got


@pytest.mark.parametrize("host_scan", ["0", "1"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f))
def test_cli_parity(cli_inputs, flags, host_scan, capsys, monkeypatch):
    fasta, words, _ = cli_inputs
    want, got = _both(["-i", fasta, "-P", words] + flags, capsys,
                      monkeypatch, host_scan)
    assert want.count("\n") >= 8
    assert got == want


@pytest.mark.parametrize("host_scan", ["0", "1"])
def test_cli_parity_long_primers(cli_inputs, host_scan, capsys,
                                 monkeypatch):
    """The Sellers route through the CLI."""
    fasta, _, long_words = cli_inputs
    want, got = _both(["-i", fasta, "-P", long_words, "-k", "2", "-r"],
                      capsys, monkeypatch, host_scan)
    assert want.count("\n") >= 8
    assert got == want
