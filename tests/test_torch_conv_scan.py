"""The port's ConvScanner against the JAX scanner's XLA block path.

The port runs on the CPU here: with the host rung off (``use_host =
False``) every scan takes the fused route (plain PyTorch filter,
compaction and rescore on CPU tensors) at any size, pattern length and
alphabet, as the JAX tests send theirs through the interpret-mode kernel.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu.ops.conv_scan import ConvScanner as JaxScanner
from sequence_alignment_tools_tpu.ops.tables import build_tables
from sequence_alignment_tools_tpu_torch.ops import conv_scan
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
    scan_occupancy,
)
from sequence_alignment_tools_tpu_torch.parallel.shard import make_mesh
from tests.test_torch_scan_kernel import PATS, planted_db


@pytest.fixture(scope="module")
def db():
    return planted_db(n=60_000, seed=4)


def _tables(db, pats=PATS, rev_comp=True):
    return build_tables(build_pattern_set(pats, rev_comp=rev_comp), db,
                        wc=False, textn=False)


def _want(tables, k, codes):
    ref = JaxScanner(tables, k=k, block=1 << 15, use_pallas=False)
    ref.use_host = False  # pin the XLA block path
    return list(ref.scan(codes))


def _fused(tables, k):
    sc = ConvScanner(tables, k=k, device="cpu")
    sc.use_host = False
    return sc


def _record_fused(monkeypatch):
    """Record the length of every fused scan (``scan_hits`` call)."""
    calls = []
    real = conv_scan.scan_hits
    monkeypatch.setattr(conv_scan, "scan_hits",
                        lambda *a: calls.append(a[1]) or real(*a))
    return calls


@pytest.mark.parametrize("k", [0, 1, 2])
def test_fused_scan_matches_xla_path(db, k, monkeypatch):
    tables = _tables(db)
    want = _want(tables, k, db.codes)
    assert len(want) >= (1 + (k > 0)) * len(PATS) + 1
    calls = _record_fused(monkeypatch)
    before = scan_occupancy.launches
    assert list(_fused(tables, k).scan(db.codes)) == want
    assert calls == [len(db.codes)]  # one fused scan of the whole array
    assert scan_occupancy.launches == before  # CPU tensors: plain version


@pytest.mark.parametrize("k", [0, 2])
def test_small_scans_take_the_host_or_fused_route(db, k, monkeypatch):
    """A small scan takes the native shift-and machine by default and the
    fused route with the host rung off (no size floor); both match."""
    tables = _tables(db)
    want = _want(tables, k, db.codes)
    calls = _record_fused(monkeypatch)
    host = ConvScanner(tables, k=k, device="cpu")
    assert host._host_eligible(len(db.codes))
    assert list(host.scan(db.codes)) == want
    assert calls == []
    small = db.codes[:3000]
    assert list(_fused(tables, k).scan(small)) == _want(tables, k, small)
    assert calls == [len(small)]


def test_scan_stream_mixed_blocks(db):
    tables = _tables(db)
    blocks = [db.codes, db.codes[:30_000], db.codes[:3000], db.codes[:0],
              db.codes[-20_000:]] * 2
    want = [_want(tables, 0, b) if len(b) else [] for b in blocks]
    sc = _fused(tables, 0)
    got = list(sc.scan_stream(iter(blocks), depth=3))
    assert [i for i, _ in got] == list(range(len(blocks)))
    assert [h for _, h in got] == want


def test_cap_overflow_retry(db):
    """Caps of 1 overflow both the microblock and the hit sections; the
    retry grows them past the true counts and the output is unchanged."""
    tables = _tables(db)
    want = _want(tables, 1, db.codes)
    sc = _fused(tables, 1)
    sc._cap_mb = sc._hit_cap = 1
    assert list(sc.scan(db.codes)) == want
    assert sc._cap_mb >= 2 * len(PATS) and sc._hit_cap >= len(want)
    sc2 = _fused(tables, 1)
    sc2._cap_mb = sc2._hit_cap = 1
    got = dict(sc2.scan_stream(iter([db.codes, db.codes[:20_000]])))
    assert got[0] == want
    assert got[1] == _want(tables, 1, db.codes[:20_000])


@pytest.mark.parametrize("k", [0, 1])
def test_stream_whole_rung(db, k):
    """Arrays past the residency bound scan as halo'd streamed blocks; hits
    starting in a block's halo belong to the next block."""
    tables = _tables(db)
    sc = _fused(tables, k)
    sc._RESIDENT_MAX = 10_000
    sc._STREAM_BLOCK = 8192
    assert sc._stream_whole(db.codes)
    assert list(sc.scan(db.codes)) == _want(tables, k, db.codes)


def test_long_patterns_take_the_fused_route(monkeypatch):
    """Lmax > 128 (past the TPU kernel's int8 bound) takes the fused route
    like any other scan and matches the JAX XLA path."""
    rng = np.random.default_rng(8)
    n = 20_000
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    longp = "".join("ACGT"[c] for c in rng.integers(0, 4, size=140))
    codes[1234 : 1234 + 140] = ["ACGT".index(c) for c in longp]
    codes[9000 : 9000 + 140] = ["ACGT".index(c) for c in longp]
    codes[9070] = (codes[9070] + 1) % 4  # one substitution
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["e1"])
    tables = _tables(db, [longp, PATS[0]], rev_comp=True)
    assert tables.Lmax > 128
    calls = _record_fused(monkeypatch)
    for k in (0, 1):
        want = _want(tables, k, codes)
        assert len(want) == 1 + k
        assert list(_fused(tables, k).scan(codes)) == want
    assert calls == [n, n]


def test_wide_alphabet_matches_xla_path(monkeypatch):
    """Degenerate -w primers against an IUPAC database (15 codes, where the
    JAX scanner takes its bit-plane mode on the TPU): the fused route
    scores the class form directly and matches the JAX XLA path."""
    rng = np.random.default_rng(7)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    base = rng.integers(0, 4, size=40_000)
    amb = rng.random(40_000) < 0.03
    base[amb] = rng.integers(4, 15, size=int(amb.sum()))
    seq = table[base].tobytes()
    db = SeqDB.from_entries([("w1", seq[:25_000]), ("w2", seq[25_000:])])
    assert db.alphabet_size >= 15
    text = seq.decode()
    pats = [text[i : i + 12] for i in range(500, 39_000, 4_000)]
    pats.append("ACGRYTNNSWKT")
    tables = build_tables(build_pattern_set(pats, rev_comp=True), db,
                          wc=True, textn=False)
    calls = _record_fused(monkeypatch)
    want = _want(tables, 0, db.codes)
    assert len(want) >= len(pats)
    assert list(_fused(tables, 0).scan(db.codes)) == want
    assert calls == [len(db.codes)]


def test_waiting_rungs_raise(db):
    """No rung raises any more: under a mesh the scan and the stream run
    per position shard (the sharded rungs) and equal the XLA path; dense
    seeds past 2^18 positions, which used to raise, take the census
    rung."""
    tables = _tables(db)
    meshed = _fused(tables, 0)
    meshed.mesh = make_mesh(["cpu"] * 3)
    want = _want(tables, 0, db.codes)
    assert list(meshed.scan(db.codes)) == want
    assert list(meshed.scan_stream([db.codes])) == [(0, want)]
    big = np.tile(db.codes, 5)  # 300k positions of dense 4-mer seeds
    seeds = _tables(db, [p[:4] for p in PATS], rev_comp=False)
    dense = ConvScanner(seeds, k=0, device="cpu")
    dense.use_host = False
    assert dense._census_eligible(len(big))
    assert list(dense.scan(big)) == _want(seeds, 0, big)
