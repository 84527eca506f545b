"""BENCHMARK.json against the contract it is written to, and the result
line of a run driven on the CPU at a tiny size."""

import json
import re

import pytest

from conftest import ROOT, TINY, TINY_FILES
from gpubench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert set(m.get("workloads", cells)) <= cells
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    reports = {w: {m["name"] for m in BENCH["end_to_end"]
                   if w in m.get("workloads", cells)} for w in cells}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert all(m["moves"] in reports[w] for w in m["workloads"])
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").exists()
    for w in cells:
        assert "setup_s" in reports[w] and len(reports[w]) >= 2


def test_configs_and_cells_have_their_files():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for c in cfgs.values():
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert c["source"] == body["source"] and len(c["source"]) <= 200
        assert (ROOT / "gpubench" / "databases" /
                f"{body['kind']}.py").exists()
    used = set()
    # four cards for at most a quarter of the cells, rounded down, or one
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        spec = json.loads((ROOT / "gpubench" / "traffic" /
                           f"{w['traffic']}.json").read_text())
        assert spec["control"] and spec["sources"]
        for family, name in (("mixes", spec["kind"]),
                             ("entries", spec["entry"]),
                             ("reference", spec["search"]["engine"])):
            assert (ROOT / "gpubench" / family / f"{name}.py").exists()
        used.add(w["config"])
    assert used == set(cfgs)


def test_every_cell_has_its_tiny_size():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(TINY_FILES) == cells
    for name, tiny in TINY_FILES.items():
        assert set(tiny) <= {"why", "config", "traffic", "on_card"}
        assert isinstance(tiny["config"], dict)
        assert isinstance(tiny["traffic"], dict)
        if "on_card" in tiny:
            assert set(tiny["on_card"]) == {"config", "traffic"}


@pytest.fixture(scope="module")
def primer_result():
    cfg_over, spec_over = TINY["primer_chr1.k1_panel"]
    return {trace: harness.run_cell(
        ROOT, "primer_chr1.k1_panel", 2**31 + 11, 1.0, bool(trace),
        device="cpu", cfg_over=cfg_over, spec_over=spec_over)
        for trace in (0, 1)}


def test_result_line_schema(primer_result):
    for trace, r in primer_result.items():
        assert list(r)[:3] == ["correct", "attempted", "failed"]
        assert list(r)[-1] == "checks"
        assert r["correct"] is True and r["failed"] == 0
        assert r["attempted"] >= 1
        assert set(r["device"]) >= {"platform", "kind", "count",
                                    "memory_peak_bytes"}
        assert r["device"]["count"] == 1
        assert r["device"]["memory_peak_bytes_per_card"] == [
            r["device"]["memory_peak_bytes"]]
        for c in r["checks"].values():
            assert set(c) == {"value", "limit"}
        group = BENCH["per_layer"] if trace else BENCH["end_to_end"]
        units = {m["name"]: m["unit"] for m in group}
        for name, m in r["metrics"].items():
            assert m["unit"] == units[name]
            assert isinstance(m["value"], float)
        json.dumps(r)
    plain, traced = primer_result[0], primer_result[1]
    assert set(plain["metrics"]) == {
        m["name"] for m in BENCH["end_to_end"]
        if "primer_chr1.k1_panel" in m.get("workloads", ["primer_chr1.k1_panel"])}
    # on the CPU the profiler sees no device: only the host-clock metric
    assert set(traced["metrics"]) == {"model_self_ms"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in traced["device"] and "window_s" in traced["device"]
    assert traced["info"]["engine"] == "halves"
    assert traced["info"]["routes"]


def test_no_card_no_result(tmp_path):
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload",
         "primer_chr1.k1_panel", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
