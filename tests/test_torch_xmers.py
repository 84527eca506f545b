"""The port's xmers and merstream against the JAX package's.

Phase 0 (``PHASE0_CONFIGS`` and the regex cases of
``tests/test_xmers.py``, raw and normalized databases), then phases 1
and 2: ``-K 1`` and ``-k 1`` with a small ``-b`` (several batches, one
model each), ``-U`` and ``-X``, a raw database (producer alphabet 256:
the ungated routes), and one batch past 2,048 half seeds on a normalized
database, where the halves engine takes the census and the slot gate (on
the plain device route, ``SAT_HOST_SCAN=0``, their plain versions
``scan_slots_ref`` and ``gate_slots_ref``).  Output bytes of the port
(host rung and plain device route) against the JAX app's, the JAX output
computed once (its halves route past 2,048 seeds takes about 20 s on the
CPU, so the databases stay at hundreds of bases).  ``-o`` files are
compared as bytes: phase 2 writes latin-1.
"""

import os
import random

import pytest

from sequence_alignment_tools_tpu.apps import xmers as jax_xmers
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import xmers as torch_xmers
from sequence_alignment_tools_tpu_torch.apps.compress_seq import main as cs
from sequence_alignment_tools_tpu_torch.ops.cuda import slots

PHASE0_CONFIGS = [
    ["-m", "5"],
    ["-m", "8"],
    ["-m", "12"],
    ["-m", "8", "-R"],
    ["-m", "5", "-R"],
    ["-m", "8", "-u", "7"],
    ["-m", "8", "-I"],
    ["-m", "8", "-R", "-I"],
]
REGEX_CONFIGS = [["-m", "4", "-r", "AC.T"], ["-m", "4", "-r", "AC.T", "-R"],
                 ["-m", "4", "-r", "AC.T GG;:"]]
_JAX_OUT: dict = {}


def write_fasta(path, entries):
    with open(path, "w") as f:
        for h, s in entries:
            f.write(f">{h}\n{s}\n")
    return str(path)


def random_entries(rng, tag, lengths, repeats=False):
    """Random entries; with ``repeats``, a 40-base segment of the first
    entry again in the second, once exact and once with a substitution
    (so that inexact hits with other contexts exist)."""
    seqs = ["".join(rng.choice("ACGT") for _ in range(n)) for n in lengths]
    if repeats:
        seg = seqs[0][30:70]
        sub = seg[:20] + "ACGT"[("ACGT".index(seg[20]) + 1) % 4] + seg[21:]
        s = seqs[1]
        seqs[1] = s[:40] + seg + s[80:120] + sub + s[160:]
    return [(f"{tag}{e} entry {e}", s) for e, s in enumerate(seqs)]


@pytest.fixture(scope="module")
def xm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_xmers")
    files = {
        "tiny": write_fasta(d / "tiny.fasta", random_entries(
            random.Random(3), "s", (120, 150, 180))),
        "big": write_fasta(d / "big.fasta", random_entries(
            random.Random(21), "b", (800, 800))),
        "raw": write_fasta(d / "raw.fasta", random_entries(
            random.Random(5), "r", (200, 200), repeats=True)),
        "norm": write_fasta(d / "norm.fasta", random_entries(
            random.Random(6), "n", (200, 200), repeats=True)),
        "census": write_fasta(d / "census.fasta", random_entries(
            random.Random(8), "c", (280, 280), repeats=True)),
    }
    rng = random.Random(9)
    base = "".join(rng.choice("ACGT") for _ in range(200))
    files["engineered"] = write_fasta(d / "eng.fasta", [(
        "x1 engineered", base[:40] + "ACGTACGTACGTG" + base[40:80]
        + "ACGTACGTACGTG" + base[80:120] + "ACGTACGTACGTT" + base[120:])])
    for name in ("norm", "census", "engineered"):
        assert cs(["-i", files[name], "-n", "true"]) == 0
    files["tiny_norm"] = str(d / "tiny_norm.fasta")
    with open(files["tiny"]) as src, open(files["tiny_norm"], "w") as dst:
        dst.write(src.read())
    assert cs(["-i", files["tiny_norm"], "-n", "true"]) == 0
    files["dir"] = str(d)
    return files


def parity(xm_files, db, flags, monkeypatch, host_scan, tool="main"):
    """(JAX bytes, port bytes) of ``xmers`` (or ``merstream``) writing to
    an ``-o`` file."""
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_MESH", "0")
    out = os.path.join(xm_files["dir"], "out.txt")
    argv = ["-i", xm_files[db]] + flags + ["-o", out]
    key = (tool,) + tuple(argv)
    if key not in _JAX_OUT:
        monkeypatch.setenv("SAT_HOST_SCAN", "1")
        assert getattr(jax_xmers, tool)(list(argv)) == 0
        _JAX_OUT[key] = open(out, "rb").read()
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    assert getattr(torch_xmers, tool)(list(argv)) == 0
    return _JAX_OUT[key], open(out, "rb").read()


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", PHASE0_CONFIGS, ids=lambda c: " ".join(c))
def test_phase0_parity(xm_files, cfg, host_scan, monkeypatch):
    want, got = parity(xm_files, "tiny", cfg, monkeypatch, host_scan)
    assert want
    assert got == want


@pytest.mark.parametrize("cfg", REGEX_CONFIGS, ids=lambda c: " ".join(c))
def test_phase0_regex_parity(xm_files, cfg, monkeypatch):
    want, got = parity(xm_files, "big", cfg, monkeypatch, "0")
    assert want.count(b"\n") > 10
    assert got == want


def test_phase0_normalized_db(xm_files, monkeypatch):
    want, got = parity(xm_files, "tiny_norm", ["-m", "8", "-D", "3"],
                       monkeypatch, "0")
    assert want and got == want


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", [["-m", "12", "-K", "1", "-R", "-b", "60"],
                                 ["-m", "12", "-k", "1", "-R", "-b", "60"],
                                 ["-m", "12", "-k", "2", "-b", "150"]],
                         ids=lambda c: " ".join(c))
def test_inexact_phases_batches(xm_files, cfg, host_scan, monkeypatch):
    """Several batches on a normalized database (halves with the fused
    gated route; at k = 2 the filter engine)."""
    want, got = parity(xm_files, "norm", cfg, monkeypatch, host_scan)
    assert want.count(b"-1:") > 5
    assert got == want


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", [["-m", "8", "-K", "1", "-R", "-b", "60"],
                                 ["-m", "8", "-k", "1", "-b", "100"]],
                         ids=lambda c: " ".join(c))
def test_inexact_phases_raw_db(xm_files, cfg, host_scan, monkeypatch):
    """A raw database: producer alphabet 256 (the ungated routes), phase 2
    printing phantom extension characters above 127."""
    want, got = parity(xm_files, "raw", cfg, monkeypatch, host_scan)
    assert want.count(b"-1:") > 5
    assert got == want


@pytest.mark.parametrize("flag", ["-U", "-X"])
def test_uniq_exonly_gates(xm_files, flag, monkeypatch):
    want, got = parity(xm_files, "engineered",
                       ["-m", "12", "-k", "1", flag], monkeypatch, "0")
    assert want.count(b"-1:") > 0
    assert got == want


def test_census_batch(xm_files, monkeypatch):
    """One batch of about 540 mers with their reverse complements: about
    2,160 half seeds, past 2,048, so the halves engine takes the census
    and the slot gate (their plain versions here)."""
    calls = {"scan_slots_ref": 0, "gate_slots_ref": 0}
    for name in calls:
        ref = getattr(slots, name)

        def spy(*a, _ref=ref, _name=name, **kw):
            calls[_name] += 1
            return _ref(*a, **kw)

        monkeypatch.setattr(slots, name, spy)
    flags = ["-m", "12", "-k", "1", "-R"]
    for host_scan in ("0", "1"):
        want, got = parity(xm_files, "census", flags, monkeypatch, host_scan)
        assert got == want
    assert want.count(b"-1:") > 5
    assert calls["scan_slots_ref"] >= 1 and calls["gate_slots_ref"] >= 1


@pytest.mark.parametrize("flags", [["-m", "4", "-r", "AC.T"],
                                   ["-m", "4", "-r", "AC.T", "-R", "-u",
                                    "9"],
                                   ["-m", "8", "-r", "........", "-K", "1",
                                    "-b", "100"]],
                         ids=lambda f: " ".join(f))
def test_merstream_parity(xm_files, flags, monkeypatch):
    want, got = parity(xm_files, "big", flags, monkeypatch, "0",
                       tool="merstream_main")
    assert want and got == want


def test_xmers_dispatcher(xm_files, monkeypatch):
    flags = ["-m", "8", "-K", "1", "-R", "-b", "60"]
    want, _got = parity(xm_files, "raw", flags, monkeypatch, "0")
    out = os.path.join(xm_files["dir"], "disp.txt")
    monkeypatch.setattr("sys.argv", ["sat", "xmers", "-i", xm_files["raw"]]
                        + flags + ["-o", out])
    assert torch_main.main() == 0
    assert open(out, "rb").read() == want
    assert any(b > 127 for b in want)
