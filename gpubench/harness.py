"""One run of one benchmark cell, driven by ``BENCHMARK.json``.

The cell names a configuration and a traffic mix, each a file of
parameters of its own (``configs/<config>.json``, ``traffic/<traffic>
.json``).  Each file names the modules that serve it, found by name: the
configuration's ``kind`` a database builder (``databases/<kind>.py``), the
traffic's ``kind`` its generator and work function (``mixes/<kind>.py``),
its ``entry`` the way the program is driven (``entries/<entry>.py``) and
its ``search.engine`` the plain reference (``reference/<engine>.py``);
each per-layer metric is a reader of its own (``metrics/<name>.py``).
A later cell adds files and entries and edits none of these.  A run:

1. makes the configuration's database from the seed, and the traffic's
   set-up (its query list drawn from the seed);
2. starts every card's memory peak afresh, so that it is the program's,
   and hands the database and the cell's cards (``chips`` of them:
   ``cuda:0`` onward, or as many entries of the CPU in the tests) to the
   program, which puts it on them;
3. runs the warm-up queries (one of each extreme size), with the route
   lines on;
4. measures a closed loop with one client for ``seconds``: a query is
   sent when the one before it has returned, and the window closes when
   the last query sent inside it returns;
5. with ``trace``, measures that window under ``torch.profiler`` and the
   scanner spans, and reads the per-layer metrics from it;
6. reads the memory peak of every card, frees the program, and holds a
   sample of the completed queries, drawn from the seed with the largest
   among them, against the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import inspect
import io
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import databases, mixes
from .reference import Reference, compare
from .trace import (
    QUERY_RANGE,
    ScanSpans,
    Trace,
    TracedQuery,
    clock_offset,
    profiler_events,
)

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sequence_alignment_tools_tpu")
# every number compared has the limit 0: the hits are compared exactly
LIMITS = {"missing_hits": 0, "extra_hits": 0, "failed_queries": 0}


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, workload: str):
    """(benchmark, cell, configuration, traffic) of ``workload``: the
    configuration from the file its entry in ``configs`` names, the
    traffic from ``traffic/<traffic>.json``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    cfg = load_json(root / files[cell["config"]])
    spec = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, spec


def entry_program(spec: dict):
    """The ``Program`` of the traffic's ``entry``."""
    return importlib.import_module(f"gpubench.entries.{spec['entry']}").Program


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def warm_up(program, queries) -> list[str]:
    """Run the warm-up queries with the route lines on; the lines."""
    err = io.StringIO()
    os.environ["SAT_ROUTE_VERBOSE"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            for q in queries:
                program.query(q.patterns)
    finally:
        del os.environ["SAT_ROUTE_VERBOSE"]
    routes = []
    for line in err.getvalue().splitlines():
        if "Route: " in line:
            r = line.split("Route: ", 1)[1]
            if r not in routes:
                routes.append(r)
    return routes


def cell_devices(device: str, chips: int) -> list[str]:
    """The cell's cards: ``cuda:0`` onward, or ``chips`` entries of the
    CPU (the port's mesh takes repeated entries)."""
    if device == "cuda":
        return [f"cuda:{i}" for i in range(chips)]
    return [device] * chips


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", cfg_over: dict | None = None,
             spec_over: dict | None = None, cell_over: dict | None = None,
             program_cls=None) -> dict:
    """One run of ``workload``: the result line as a dict, with the
    compared numbers under ``checks`` (last) and the run's facts under
    ``info``.  ``cfg_over``, ``spec_over`` and ``cell_over`` replace keys
    of the configuration, the traffic and the cell's entry."""
    seed %= 1 << 64                  # any whole number, as numpy takes it
    bench, cell, cfg, spec = cell_files(root, workload)
    cfg.update(cfg_over or {})
    spec.update(spec_over or {})
    cell = dict(cell, **(cell_over or {}))
    cuda = device == "cuda"
    devices = cell_devices(device, int(cell["chips"]))

    # set-up, with the process's age at the end of each phase
    ages = {"imports": process_age_s()}
    db = databases.build(cfg, seed, device)
    ages["database"] = process_age_s()
    traffic, mix = mixes.make(spec, db, seed, device)
    search = spec["search"]
    ages["traffic"] = process_age_s()
    if cuda:
        torch.cuda.empty_cache()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    program = (program_cls or entry_program(spec))(db, search, devices)
    ages["upload"] = process_age_s()
    routes = warm_up(program, mix.warmup())
    engine = program.engine
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
    gc.collect()
    setup_s = process_age_s()
    ages["warm_up"] = setup_s
    uploads0 = program.uploads

    scan = ScanSpans() if trace else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        scan.install()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        # keep every event of the window (without it, torch may drop the
        # events of earlier cycles)
        keep = ({"acc_events": True}
                if "acc_events" in inspect.signature(profile).parameters
                else {})
        prof = profile(activities=acts, **keep)
        prof.__enter__()

    # the hits as the client holds them; the rows that the check compares
    # are made from them after the window, for the checked queries alone
    done, lat, held, traced, sent = [], [], [], [], []
    attempted = failed = 0
    queries = mix.queries()
    t_start = time.perf_counter_ns()
    deadline = t_start + int(seconds * 1e9)
    while time.perf_counter_ns() < deadline:
        q = next(queries)
        attempted += 1
        phases = [] if trace else None
        i0 = len(scan.spans) if trace else 0
        t0 = time.perf_counter_ns()
        sent.append(t0)
        try:
            if trace:
                with torch.profiler.record_function(QUERY_RANGE):
                    hits = program.query(q.patterns, phases)
            else:
                hits = program.query(q.patterns)
        except Exception:
            failed += 1
            if failed == 1:
                traceback.print_exc()
            continue
        t1 = time.perf_counter_ns()
        lat.append(t1 - t0)
        held.append(hits)
        done.append(q)
        if trace:
            s_in = scan.seconds_within(t0, t1, max(i0 - 1, 0))
            traced.append(TracedQuery(t0, t1, s_in, traffic.least_seconds(
                db, search, q.patterns, len(hits)), phases))
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
    t_end = time.perf_counter_ns()
    if trace:
        prof.__exit__(None, None, None)
        scan.remove()
    window_s = (t_end - t_start) / 1e9

    peaks = [int(torch.cuda.max_memory_allocated(d)) if cuda else 0
             for d in devices]
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": len(devices),
                   "memory_peak_bytes": max(peaks),
                   "memory_peak_bytes_per_card": peaks}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    wanted = cell_metrics(bench, workload, trace)
    metrics = {}
    breakdown = None
    if trace:
        ops, ranges = profiler_events(prof)
        del prof
        tr = Trace(traced, ops, t_start, t_end, clock_offset(sent, ranges),
                   scan.spans, len(devices))
        for m in wanted:
            reader = importlib.import_module(f"gpubench.metrics.{m['name']}")
            v = reader.read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["busy_s_per_card"] = tr.busy_s_per_card()
        device_info["window_s"] = tr.window_s
        breakdown = tr.breakdown()
    else:
        values = {
            "scan_gpos_s": len(db) * len(done) / window_s / 1e9,
            "query_p95_ms": float(np.percentile(lat, 95)) / 1e6
            if lat else None,
            "setup_s": setup_s,
        }
        for m in wanted:
            v = values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    uploads = program.uploads - uploads0

    # the program's state goes before the reference runs
    to_rows = program.rows
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(db.codes, db.table, device)
    rng = np.random.default_rng([seed, 3])
    check = []
    if done:
        sizes = [len(q.patterns) for q in done]
        largest = int(np.argmax(sizes))
        rest = [i for i in range(len(done)) if i != largest]
        take = min(int(spec["checked_queries"]) - 1, len(rest))
        check = [largest] + sorted(rng.choice(rest, take, replace=False)
                                   .tolist() if take else [])
    missing = extra = 0
    for i in check:
        m_, e_ = compare(to_rows(held[i]),
                         ref.answer(search, done[i].patterns))
        missing += m_
        extra += e_
    del ref
    checks = {"missing_hits": missing, "extra_hits": extra,
              "failed_queries": failed}
    result["correct"] = bool(check) and all(
        checks[k] <= LIMITS[k] for k in checks)
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = {
        "workload": workload, "seed": seed, "trace": int(trace),
        "engine": engine, "routes": routes,
        "device": power_limit() if cuda else "cpu",
        "queries_completed": len(done), "window_s": window_s,
        "patterns_per_query_mean": float(np.mean(
            [len(q.patterns) for q in done])) if done else 0.0,
        "hits_per_query_mean": float(np.mean([len(h) for h in held]))
        if held else 0.0,
        "uploads_in_window": uploads, "positions": len(db),
        "setup_ages_s": ages,
        "checked_queries": check,
        "query_p50_ms": float(np.percentile(lat, 50)) / 1e6 if lat else None,
    }
    result["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                        for k, v in checks.items()}
    return result
