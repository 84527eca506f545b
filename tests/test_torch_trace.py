"""The port's spans and counters (``utils/trace``) and the benchmark's
readers of them.

A query of ``PrimerMatchModel`` on the CPU (the device routes' plain
versions, ``use_host = False``) records nothing unless a
``torch.profiler`` session records; under one its spans nest, carry the
model's request id, and lie inside ``hits()``; the candidate and upload
counters equal counts made by hand.  The six readers of
``gpubench/metrics`` run on a synthetic trace.  On the card, the
``launch.*`` counts of a traced window equal the port's kernels in the
profiler's trace.
"""

import io
import re
import subprocess
import sys
import time
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpubench.metrics import (
    extend_yield_pct,
    glue_launches_per_query,
    model_idle_ms,
    scanned_gpos_per_query,
    scanner_idle_ms,
    upload_mb_per_query,
)
from gpubench.trace import DeviceOp, Trace, TracedQuery, profiler_events
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
    _hid_of,
)
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
from sequence_alignment_tools_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent
TABLE = b"ACGT\n"
SPANS = {"io.pattern_set", "model.init", "model.tables", "model.gate",
         "model.extend", "model.dedup", "model.emit", "model.hits",
         "model.close", "scan.tables", "scan.upload", "scan.dispatch",
         "scan.wait", "scan.decode", "scan.redispatch"}
PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC"]
ENGINES = [("halves", 1), ("exact_kt", 0)]


def make_db(n=1 << 15, seed=5):
    """``n`` random bases in two entries, each pattern planted twice (once
    with a substitution), in fresh arrays (so the text is uploaded anew)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    at = 100
    for p in PATS:
        for s in (p, p[:5] + ("A" if p[5] != "A" else "C") + p[6:]):
            codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
            at += 700
    half = n // 2
    codes[[0, half]] = 4
    return SeqDB(codes=codes, table=TABLE,
                 entry_starts=np.array([1, half + 1]),
                 entry_lengths=np.array([half - 1, n - half - 1]),
                 headers=["e1", "e2"])


def new_model(db, k, device="cpu"):
    m = PrimerMatchModel(db, build_pattern_set(PATS, rev_comp=True), k=k,
                         mesh=None, device=device)
    m.use_host = False
    return m


@pytest.mark.parametrize("engine,k", ENGINES)
def test_off_records_nothing(engine, k):
    assert not trace.recording()
    spans0, events0 = len(trace.spans()), len(trace.events())
    up0 = trace.total("upload.bytes")
    m = new_model(make_db(), k)
    assert m.engine == engine
    hits = list(m.hits())
    m.close()
    assert hits
    assert (len(trace.spans()), len(trace.events())) == (spans0, events0)
    # the totals count whether or not anything records
    assert trace.total("upload.bytes") > up0
    # off, every span is one shared null context
    assert trace.span("model.hits") is trace.span("scan.wait")


def traced_query(db, k):
    """(model, hits, t0, t1, i0, spans) of one query whose ``hits()`` ran
    under the profiler, between ``t0`` and ``t1``; its spans are
    ``trace.spans()[i0:]``."""
    m = new_model(db, k)
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        i0 = len(trace.spans())
        t0 = time.perf_counter_ns()
        hits = list(m.hits())
        t1 = time.perf_counter_ns()
    assert not trace.recording()
    return m, hits, t0, t1, i0, trace.spans()[i0:]


@pytest.mark.parametrize("engine,k", ENGINES)
def test_spans_nest_under_the_profiler(engine, k):
    m, hits, t0, t1, i0, recs = traced_query(make_db(), k)
    assert m.engine == engine and hits
    names = {r.name for r in recs}
    assert names <= SPANS
    assert {"model.hits", "model.tables", "scan.tables", "scan.upload",
            "scan.dispatch", "scan.decode"} <= names
    if engine == "halves":
        assert {"model.gate", "model.extend", "model.dedup"} <= names
    else:
        assert "model.emit" in names
    roots = [r for r in recs if r.parent < 0]
    assert [r.name for r in roots] == ["model.hits"]
    for r in recs:
        assert t0 <= r.start <= r.end <= t1
        assert r.request == m.request
        if r.parent >= 0:
            p = recs[r.parent - i0]
            assert p.start <= r.start and r.end <= p.end
            # a scanner span never holds a model span
            assert not (p.name.startswith("scan.")
                        and r.name.startswith("model."))
    # the next model is another request
    assert new_model(make_db(), k).request != m.request


@pytest.mark.parametrize("engine,k", ENGINES)
def test_counters_match_hand_counts(engine, k):
    db = make_db()
    n = len(db.codes)
    before = {c: trace.total(c) for c in
              ("upload.bytes", "cand.extend_in", "cand.extend_ok",
               "scan.positions")}
    m = new_model(db, k)
    hits = list(m.hits())
    grew = {c: trace.total(c) - v for c, v in before.items()}
    if engine == "halves":
        _o, sc, batch, dirs, ext, geomB = m._halves_ctx()
        S, Lg = m._gate_cache[1].bits.shape
        gate_bytes = 4 * S * Lg + 4 * S + 4 * S
        # the candidates again, and their extension
        ends, hids = m._seed_candidates(sc, dirs, ext, geomB, _hid_of)
        ok = batch(ends, hids.astype(np.int32))[0]
        assert grew["cand.extend_in"] == len(ends) > 0
        assert grew["cand.extend_ok"] == int(np.count_nonzero(ok))
        assert len(hits) <= grew["cand.extend_ok"] <= len(ends)
    else:
        _t, sc = m._exact_ctx()
        gate_bytes = 0
        assert grew["cand.extend_in"] == grew["cand.extend_ok"] == 0
    t = sc.tables
    # the text (uint8), then float32 and int16 weights [Lmax, alpha, P],
    # int32 thresholds and lengths [P], then the gate's int32 tables
    assert grew["upload.bytes"] == (
        n + t.Lmax * t.alpha * t.P * (4 + 2) + 2 * 4 * t.P + gate_bytes)
    # one filter pass over the text
    assert grew["scan.positions"] == n


def test_route_line_once_per_scanner(monkeypatch):
    """The route helper prints '[<asctime>] Route: <msg>' once per scanner
    and message, and nothing without SAT_ROUTE_VERBOSE or a progress
    callback."""
    db = make_db()
    tables = new_model(db, 0)._exact_ctx()[0]
    for sc in (ConvScanner(tables, device="cpu"),
               SellersScanner(tables, k=1, device="cpu")):
        err = io.StringIO()
        monkeypatch.delenv("SAT_ROUTE_VERBOSE", raising=False)
        with redirect_stderr(err):
            sc._route("quiet")
        monkeypatch.setenv("SAT_ROUTE_VERBOSE", "1")
        with redirect_stderr(err):
            for msg in ("one", "two", "one"):
                sc._route(msg)
        lines = err.getvalue().splitlines(keepends=True)
        assert [re.sub(r"^\[.{24}\] ", "", ln) for ln in lines] == [
            "Route: one\n", "Route: two\n"]


def test_trace_module_imports_no_torch():
    code = ("import sys; sys.path.insert(0, %r); "
            "from sequence_alignment_tools_tpu_torch.utils import trace; "
            "assert not trace.recording(); "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'torch', 'jax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def synthetic():
    """A window [0, 1000) ns with the device busy over [100, 200) and
    [500, 600), two queries, and the port's records in it."""
    ops = [DeviceOp(name, a, b) for name, a, b in (
        ("occupancy_kernel", 100, 150), ("gather", 150, 200),
        ("seed_gate_kernel", 500, 550), ("cub_scan", 550, 580),
        ("fill", 580, 600), ("Memcpy HtoD", 590, 600))]
    queries = [TracedQuery(0, 480, 0.0, 0.0), TracedQuery(480, 1000, 0.0,
                                                          0.0)]
    recs = []
    for name, start, end, parent in (
            ("model.hits", 50, 900, -1), ("scan.dispatch", 100, 150, 0),
            ("scan.wait", 150, 300, 0), ("model.extend", 600, 700, 0),
            ("scan.decode", 1200, 1300, -1)):   # past the window
        r = trace.SpanRecord(name, start, parent, 7)
        r.end = end
        recs.append(r)
    events = [(110, "launch.scan_occupancy", 1), (120, "launch.seed_gate", 1),
              (2000, "launch.seed_gate", 1), (110, "scan.positions", 1 << 28),
              (130, "upload.bytes", 3_000_000), (640, "cand.extend_in", 100),
              (660, "cand.extend_ok", 25)]
    return Trace(queries, ops, 0, 1000, 0, []), recs, events


def test_readers_on_a_synthetic_trace(monkeypatch):
    tr, recs, events = synthetic()
    monkeypatch.setattr(trace, "_records", recs)
    monkeypatch.setattr(trace, "_events", events)
    # idle: [0, 100), [200, 500), [600, 1000); model.hits' self time
    # [50, 100) + [300, 600) + [700, 900) holds 450 idle ns, model.extend
    # 100; scan.wait 100, scan.dispatch none
    assert model_idle_ms.read(tr) == pytest.approx(550e-6 / 2)
    assert scanner_idle_ms.read(tr) == pytest.approx(100e-6 / 2)
    # five kernels (the copy is none), two of them the port's
    assert glue_launches_per_query.read(tr) == pytest.approx(3 / 2)
    assert scanned_gpos_per_query.read(tr) == pytest.approx(
        (1 << 28) / 2 / 1e9)
    assert upload_mb_per_query.read(tr) == pytest.approx(1.5)
    assert extend_yield_pct.read(tr) == pytest.approx(25.0)


READERS = [model_idle_ms, scanner_idle_ms, glue_launches_per_query,
           scanned_gpos_per_query, upload_mb_per_query, extend_yield_pct]


@pytest.mark.parametrize("why", ["no_device_op", "no_port_trace"])
def test_readers_read_nothing_without_their_source(monkeypatch, why):
    """On the CPU (no device operation) and against a program without
    ``utils/trace`` (the parent of this module) every reader is None."""
    tr, recs, events = synthetic()
    monkeypatch.setattr(trace, "_records", recs)
    monkeypatch.setattr(trace, "_events", events)
    if why == "no_device_op":
        tr.ops = []
    else:
        import sequence_alignment_tools_tpu_torch.utils as utils

        monkeypatch.delattr(utils, "trace")
        monkeypatch.setitem(
            sys.modules, "sequence_alignment_tools_tpu_torch.utils.trace",
            None)
    assert [r.read(tr) for r in READERS] == [None] * len(READERS)


PORT_KERNELS = {"occupancy_kernel": "scan_occupancy",
                "seed_gate_kernel": "seed_gate",
                "myers_kernel": "myers_pairs",
                "sellers_bp_kernel": "sellers_scan",
                "seed_slots_kernel": "scan_slots",
                "gate_slots_kernel": "gate_slots"}


def _port_kernel(name):
    for kernel, wrapper in PORT_KERNELS.items():
        if re.search(r"\b%s\b" % kernel, name):
            return wrapper
    return None


@pytest.mark.cuda
def test_cuda_launch_counts_equal_the_profiler():
    """Queries through each of the six kernels on the card (the gated
    seed scan, the slot census and gate past 2,048 seeds, Myers, Sellers,
    the pattern-blocked scan) under the profiler: the ``launch.*`` events
    in the window count each of the port's kernels in the device trace,
    and no device operation bears a span's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(11)
    db = make_db(n=1 << 20, seed=11)

    def drawn(count, length):
        starts = rng.integers(1, len(db.codes) // 2 - length, count)
        return ["".join("ACGT"[c] for c in db.codes[s : s + length])
                for s in starts]

    runs = [(PATS, 1), (drawn(1100, 20), 1), (drawn(8, 24), 2),
            (drawn(8, 40), 2), (drawn(2100, 28), 0)]
    models = [PrimerMatchModel(db, build_pattern_set(p, rev_comp=True),
                               k=k, mesh=None, device="cuda")
              for p, k in runs]
    for m in models:
        m.use_host = False
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        for m in models:
            assert list(m.hits())
            m.close()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    counted = {w: 0 for w in PORT_KERNELS.values()}
    for t, name, n in trace.events():
        if t0 <= t < t1 and name.startswith("launch."):
            counted[name.removeprefix("launch.")] += n
    seen = {w: 0 for w in PORT_KERNELS.values()}
    spans = {r.name for r in trace.spans()}
    ops, _ranges = profiler_events(prof)
    for op in ops:
        assert op.name not in SPANS | spans
        w = _port_kernel(op.name)
        if w is not None:
            seen[w] += 1
    assert seen == counted
    assert all(v >= 1 for v in counted.values()), counted
