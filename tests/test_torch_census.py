"""The many-pattern rungs of the port's ConvScanner against the JAX scanner.

On the same numpy ``PatternTables`` and code arrays, all exact:

- the census rung of ``scan`` (dense seeds, literal sets past 2048
  patterns) and ``scan_seed_arrays``, through the plain version of
  ``scan_slots`` (the device route forced on CPU tensors with ``use_host =
  False``) and through the native census, against the JAX scanner's radix
  census;
- ``scan_seed_arrays`` with a gate: the device route's ``gate_slots``
  against the JAX ``_gate_ok``, the native route's inline gate against the
  JAX scanner's;
- the pattern-blocked rung at P = 2,500 with wildcards against the JAX
  scanner's XLA block path;
- the many-seed gated route (3,000 seeds: ``scan_slots``, ``gate_slots``)
  against the JAX census filtered by the JAX gate, cap overflows included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import (
    PatternSet,
    build_pattern_set,
)
from sequence_alignment_tools_tpu.models.primer_match import (
    PrimerMatchModel as JaxModel,
)
from sequence_alignment_tools_tpu.ops import gate as jax_gate
from sequence_alignment_tools_tpu.ops.conv_scan import ConvScanner as JaxScanner
from sequence_alignment_tools_tpu.ops.tables import build_tables
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
)
from sequence_alignment_tools_tpu_torch.native import load_shift_and_lib
from sequence_alignment_tools_tpu_torch.ops import conv_scan
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.gate import ExtendGate
from sequence_alignment_tools_tpu_torch.utils import trace

TABLE = b"ACGT\n"
EOS = 4
N = 300_000  # past the census rung's 2^18 floor


@pytest.fixture(scope="module")
def corpus():
    """(db, text): random ACGT with an EOS every 50,000 bases."""
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=N).astype(np.uint8)
    codes[::50_000] = EOS
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([1]),
               entry_lengths=np.array([N - 1]), headers=["e1"])
    return db, "".join("ACGT\n"[c] for c in codes)


def drawn(text, count, lo, hi, seed):
    """``count`` literal patterns of lo..hi bases drawn from ``text``, the
    first five twice."""
    rng = np.random.default_rng(seed)
    pats = []
    while len(pats) < count - 5:
        at = int(rng.integers(1, len(text) - hi - 1))
        p = text[at : at + int(rng.integers(lo, hi + 1))]
        if p.isalpha():
            pats.append(p)
    return pats + pats[:5]


def literal_tables(db, pats):
    ps = PatternSet(patterns=[""] + pats, esb=[0] * (len(pats) + 1),
                    eeb=[0] * (len(pats) + 1), n_forward=len(pats))
    return build_tables(ps, db, wc=False, textn=False)


def jax_scanner(tables):
    ref = JaxScanner(tables, k=0, block=1 << 15, use_pallas=False)
    ref.use_host = False
    return ref


def port_scanner(tables, use_host):
    sc = ConvScanner(tables, k=0, device="cpu")
    sc.use_host = use_host
    return sc


def routes_of(sc, monkeypatch):
    """Record the scanner's route lines."""
    seen = []
    monkeypatch.setattr(sc, "_route", seen.append)
    return seen


@pytest.fixture(scope="module")
def many(corpus):
    db, text = corpus
    return literal_tables(db, drawn(text, 3000, 14, 24, seed=1))


@pytest.fixture(scope="module")
def dense(corpus):
    db, _text = corpus
    return literal_tables(db, ["ACGT", "TTGA", "ACGT", "GGC", "CATGA"])


@pytest.mark.parametrize("which,use_host", [("dense", False), ("many", False),
                                            ("many", None)])
def test_census_rung_matches_jax(corpus, many, dense, which, use_host,
                                 monkeypatch):
    db, _text = corpus
    tables = {"dense": dense, "many": many}[which]
    ref = jax_scanner(tables)
    want = list(ref.scan(db.codes))
    assert len(want) >= tables.P
    sc = port_scanner(tables, use_host)
    seen = routes_of(sc, monkeypatch)
    assert list(sc.scan(db.codes)) == want
    host_route = ("native threaded mer-hash" if load_shift_and_lib()
                  else "host radix-code census")
    assert len(seen) == 1 and seen[0].startswith(
        "census kernel" if use_host is False else host_route)
    ends, pids = sc.scan_seed_arrays(db.codes)
    wends, wpids = ref.scan_seed_arrays(db.codes)
    assert ends.dtype == pids.dtype == np.int64
    assert np.array_equal(ends, wends) and np.array_equal(pids, wpids)
    uends, upids = sc.scan_seed_arrays(db.codes, sort=False)
    assert sorted(zip(uends.tolist(), upids.tolist())) == sorted(
        zip(wends.tolist(), wpids.tolist()))


def test_census_rung_boundaries(corpus, many, dense):
    """Below 2^18 positions, with k > 0 or with sparse seeds of at most
    2048 patterns the census does not apply: ``scan_seed_arrays`` gives
    None as the JAX scanner does, and ``scan`` takes another rung."""
    db, _text = corpus
    short = db.codes[: 1 << 17]
    for tables in (many, dense):
        assert port_scanner(tables, False).scan_seed_arrays(short) is None
        assert jax_scanner(tables).scan_seed_arrays(short) is None
    sparse = literal_tables(db, ["ACGTTGCATGCAAGGTCA", "TTGACCATGGCATCAGT"])
    assert port_scanner(sparse, False).scan_seed_arrays(db.codes) is None
    assert jax_scanner(sparse).scan_seed_arrays(db.codes) is None
    k1 = ConvScanner(dense, k=1, device="cpu")
    k1.use_host = False
    assert k1.scan_seed_arrays(db.codes) is None
    tiny = db.codes[:12_000]  # P > 2048 below the floor: pattern-blocked
    assert list(port_scanner(many, False).scan(tiny)) == list(
        jax_scanner(many).scan(tiny))


def test_numpy_census_without_native(corpus, many, monkeypatch):
    """Without the native library the CPU census is the numpy radix
    lookup, with the same output."""
    db, _text = corpus
    want = list(jax_scanner(many).scan(db.codes))
    sc = port_scanner(many, None)
    monkeypatch.setattr(sc, "_mer_native", lambda *a, **kw: None)
    seen = routes_of(sc, monkeypatch)
    assert list(sc.scan(db.codes)) == want
    assert seen == ["host radix-code census (numpy)"]


def halves_models(db, pats, k, indels):
    ps = build_pattern_set(pats, rev_comp=False)
    m = PrimerMatchModel(db, ps, k=k, indels=indels, device="cpu")
    j = JaxModel(db, ps, k=k, indels=indels, mesh=None)
    assert m.engine == j.engine == "halves"
    return m, j


@pytest.fixture(scope="module")
def half_seeds(corpus):
    db, text = corpus
    return drawn(text, 1500, 20, 32, seed=2)


@pytest.mark.parametrize("k,indels", [(1, True), (1, False)])
def test_scan_seed_arrays_with_gate(corpus, half_seeds, k, indels):
    """3,000 half seeds.  Device route: the survivors of ``gate_slots``
    are the JAX census hits that pass the JAX gate.  Native route: the
    inline prefix gate gives what the JAX scanner's gives."""
    db, _text = corpus
    m, j = halves_models(db, half_seeds, k, indels)
    _o, sc, _b, dirs, ext, geomB = m._halves_ctx()
    _jo, jsc, _jb, jdirs, jext, jgeomB = j._halves_ctx()
    jsc.use_host = False
    wends, wpids = jsc.scan_seed_arrays(db.codes)
    jgate = j._engine_gate(jsc, jdirs, jext, jgeomB, lambda p: p + 1)
    ok = np.asarray(jax_gate.ExtendGate(jgate, indels)(
        jnp.asarray(db.codes), wends, wpids.astype(np.int32)))
    assert len(half_seeds) <= ok.sum() < len(wends)
    gate = ExtendGate(m._engine_gate(sc, dirs, ext, geomB, lambda p: p + 1),
                      indels)
    sc.use_host = False
    ends, pids = sc.scan_seed_arrays(db.codes, ext_gate=gate)
    assert np.array_equal(ends, wends[ok]) and np.array_equal(pids,
                                                              wpids[ok])
    uends, upids = sc.scan_seed_arrays(db.codes, sort=False, ext_gate=gate)
    assert sorted(zip(uends.tolist(), upids.tolist())) == sorted(
        zip(ends.tolist(), pids.tolist()))
    # the native route: same spec, same native function, same survivors
    if load_shift_and_lib() is None:
        return
    sc.use_host = None
    spec = m._census_gate(sc, dirs, ext, lambda p: p + 1)
    jspec = j._census_gate(jsc, jdirs, jext, lambda p: p + 1)
    assert spec[3:] == jspec[3:] and all(
        np.array_equal(a, b) for a, b in zip(spec[:3], jspec[:3]))
    nends, npids = sc.scan_seed_arrays(db.codes, gate=spec)
    if JaxScanner._mer_lib_ok():  # else the JAX census ignores the gate
        jends, jpids = jsc.scan_seed_arrays(db.codes, gate=jspec)
        assert np.array_equal(nends, jends) and np.array_equal(npids, jpids)
    # the prefix gate keeps more than the exact gate, less than everything
    native = set(zip(nends.tolist(), npids.tolist()))
    assert set(zip(ends.tolist(), pids.tolist())) <= native
    assert native < set(zip(wends.tolist(), wpids.tolist()))


@pytest.fixture(scope="module")
def wide():
    """An IUPAC database of 12,000 positions and 2,500 degenerate
    12-mers drawn from it."""
    rng = np.random.default_rng(9)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    base = rng.integers(0, 4, size=12_000)
    amb = rng.random(12_000) < 0.04
    base[amb] = rng.integers(4, 15, size=int(amb.sum()))
    seq = table[base].tobytes()
    db = SeqDB.from_entries([("w1", seq[:7_000]), ("w2", seq[7_000:])])
    text = seq.decode()
    pats = [text[i : i + 12] for i in rng.integers(0, 11_900, size=2499)]
    pats.append("ACGRYTNNSWKT")
    return db, build_tables(build_pattern_set(pats, rev_comp=False), db,
                            wc=True, textn=False)


@pytest.mark.parametrize("k", [0, 1])
def test_pattern_blocked_matches_xla_path(wide, k, monkeypatch):
    db, tables = wide
    ref = JaxScanner(tables, k=k, block=1 << 13, use_pallas=False)
    ref.use_host = False
    want = list(ref.scan(db.codes))
    assert len(want) >= 2000
    sc = ConvScanner(tables, k=k, device="cpu")
    sc.use_host = False
    assert not sc._radix_eligible() and tables.P > sc._PBLOCK
    calls = []
    real = conv_scan.scan_occupancy
    monkeypatch.setattr(conv_scan, "scan_occupancy",
                        lambda *a: calls.append(a[2].numel()) or real(*a))
    seen = routes_of(sc, monkeypatch)
    assert list(sc.scan(db.codes)) == want
    assert calls[:2] == [2048, tables.P - 2048]  # both passes, in order
    assert seen == ["pattern-blocked scan pipeline (2500 patterns, 2 "
                    "blocks)"]
    assert not sc.gated_available(len(db.codes))
    if k == 0:
        got = dict(sc.scan_stream(iter([db.codes, db.codes[:4000]])))
        assert got[0] == want
        assert got[1] == list(ref.scan(db.codes[:4000]))


@pytest.mark.parametrize("device, k", [
    pytest.param("cpu", 0, id="0"),
    pytest.param("cpu", 1, id="1"),
    pytest.param("cuda", 0, id="cuda", marks=pytest.mark.cuda),
])
def test_pattern_blocked_cap_overflow(wide, device, k, monkeypatch):
    """Sub-scanner caps of 1 overflow in every pass; each pass retries on
    its own, over its kept occupancy: the filter runs once a pass (n more
    ``scan.positions`` a pass; on the card one ``scan_filter.cu`` launch
    a pass), every overflowed row costs one rescore and one
    ``scan.rescore_retry``, the microblock cap fits at the first retry
    (its count is exact), the caps grow past the pass's true counts and
    the merged stream equals the plain version's."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    db, tables = wide
    n = len(db.codes)
    sc = ConvScanner(tables, k=k, device="cpu")
    sc.use_host = False
    want = list(sc.scan(db.codes))
    sc2 = ConvScanner(tables, k=k, device=device)
    sc2.use_host = False
    subs = sc2._pblock_subs()
    for _off, sub in subs:
        sub._cap_mb = sub._hit_cap = 1
        sub._presize = lambda n, sub=sub: (sub._cap_mb, sub._hit_cap)
    rescores = []
    real = conv_scan.rescore_hits
    monkeypatch.setattr(conv_scan, "rescore_hits",
                        lambda *a: rescores.append((a[3].thresholds.numel(),
                                                    a[5], a[6])) or real(*a))
    positions = trace.total("scan.positions")
    launches = trace.total("launch.scan_occupancy")
    retries = trace.total("scan.rescore_retry")
    assert list(sc2.scan(db.codes)) == want
    assert trace.total("scan.positions") - positions == n * len(subs)
    assert trace.total("launch.scan_occupancy") - launches == \
        (len(subs) if device == "cuda" else 0)
    assert trace.total("scan.rescore_retry") - retries == \
        len(rescores) - len(subs)
    for off, sub in subs:
        mine = [(end - int(tables.lengths[pid]), pid) for end, pid, _m in want
                if off <= pid < off + sub.tables.P]
        assert len(mine) > 1
        assert sub._hit_cap >= len(mine)
        assert sub._cap_mb >= len({start // sub._MB for start, _p in mine})
        calls = [c[1:] for c in rescores if c[0] == sub.tables.P]
        assert calls[0] == (1, 1) and 2 <= len(calls) <= 3
        assert len({cap_mb for cap_mb, _hit_cap in calls[1:]}) == 1


class NoPresize(ConvScanner):
    """A scanner whose slot and survivor caps start where the test puts
    them, so that the overflow retries run."""

    def _slot_cap_for(self, n):
        return self._slot_cap

    def _slots_caps(self, n):
        return self._slot_cap, self._gsurv_cap


@pytest.mark.parametrize("k,indels", [(1, True), (2, True), (1, False)])
def test_many_seed_scan_gated(corpus, half_seeds, k, indels):
    """3,000 half seeds take the slots route of ``scan_gated``; survivors
    equal the JAX census hits that pass the JAX gate."""
    db, _text = corpus
    ps = build_pattern_set(half_seeds, rev_comp=False)
    m = PrimerMatchModel(db, ps, k=k, indels=indels, node=11, device="cpu")
    j = JaxModel(db, ps, k=k, indels=indels, node=11, mesh=None)
    _o, sc, _b, dirs, ext, geomB = m._halves_ctx()
    _jo, jsc, _jb, jdirs, jext, jgeomB = j._halves_ctx()
    jsc.use_host = False
    wends, wpids = jsc.scan_seed_arrays(db.codes)
    jgate = j._engine_gate(jsc, jdirs, jext, jgeomB, lambda p: p + 1)
    ok = np.asarray(jax_gate.ExtendGate(jgate, indels)(
        jnp.asarray(db.codes), wends, wpids.astype(np.int32)))
    want = sorted(zip(wends[ok].tolist(), wpids[ok].tolist()))
    gate = m._engine_gate(sc, dirs, ext, geomB, lambda p: p + 1)
    assert sc.tables.P == 3000 and not sc.gated_available(N)  # native census
    sc.use_host = False
    assert sc.gated_available(N) and sc.gated_available(1000)
    anchors, sids = sc.scan_gated(db.codes, gate, indels, k)
    assert anchors.dtype == np.int64 and sids.dtype == np.int32
    assert sorted(zip(anchors.tolist(), sids.tolist())) == want
    with pytest.raises(ValueError, match="gate tables built for"):
        sc.scan_gated(db.codes, gate, indels, k + 1)
    # a stream with an empty block, and caps that overflow twice
    tiny = NoPresize(sc.tables, k=0, device="cpu")
    tiny.use_host = False
    tiny._slot_cap, tiny._gsurv_cap = 4, 2
    half = db.codes[: N // 2]
    got = list(tiny.scan_gated_stream([db.codes, db.codes[:0], half], gate,
                                      indels, k, depth=2))
    assert [i for i, _a, _s in got] == [0, 1, 2] and len(got[1][1]) == 0
    assert sorted(zip(got[0][1].tolist(), got[0][2].tolist())) == want
    hanchors, hsids = sc.scan_gated(half, gate, indels, k)
    assert sorted(zip(got[2][1].tolist(), got[2][2].tolist())) == sorted(
        zip(hanchors.tolist(), hsids.tolist()))
    assert tiny._slot_cap >= len(wends) and tiny._gsurv_cap >= len(want)
    retry = NoPresize(sc.tables, k=0, device="cpu")
    retry.use_host = False
    retry._slot_cap = 4
    ends, pids = retry.scan_seed_arrays(db.codes)  # the census retry
    assert np.array_equal(ends, wends) and np.array_equal(pids, wpids)
    assert retry._slot_cap >= len(wends)
