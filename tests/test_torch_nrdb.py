"""The port's nrdb against the JAX package's.

``NR_CONFIGS`` of ``tests/test_db_tools.py`` on its seven-entry database
(exact duplicates, a contained entry, a short one, a prefix-sharing
near-duplicate), and a protein database past 2,048 entries and 2^18
residues with duplicates and contained entries planted, where the
self-scan's seed set takes the census rung: on the plain device route
(``SAT_HOST_SCAN=0``) the census kernel's plain version
``scan_slots_ref``.  Output bytes of the port (host rung and plain device
route) against the JAX app's, the JAX output computed once.
"""

import io
import random

import numpy as np
import pytest

from sequence_alignment_tools_tpu.apps import nrdb as jax_nrdb
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import nrdb as torch_nrdb
from sequence_alignment_tools_tpu_torch.apps.compress_seq import main as cs
from sequence_alignment_tools_tpu_torch.ops.cuda import slots

NR_CONFIGS = [[], ["-C"], ["-b"], ["-C", "-b"], ["-x", "10"],
              ["-S", "-x", "5"]]
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
_JAX_OUT: dict = {}


def write_fasta(path, entries, width=55):
    with open(path, "w") as f:
        for h, s in entries:
            f.write(f">{h}\n")
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + "\n")


@pytest.fixture(scope="module")
def nr_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nrdb")
    rng = random.Random(19)
    base = "".join(rng.choice("ACGT") for _ in range(300))
    e2 = "".join(rng.choice("ACGT") for _ in range(250))
    small = str(d / "nr.fasta")
    write_fasta(small, [
        ("a1 first entry", base),
        ("a2 duplicate of first", base),
        ("a3 distinct", e2),
        ("a4 contained in a3", e2[50:200]),
        ("a5 short", "ACG"),
        ("a6 another dup of first", base),
        ("a7 prefix-sharing but distinct", base[:100] + "T" + base[101:]),
    ])
    assert cs(["-i", small, "-n", "true"]) == 0
    # 2,300 proteins of 60 to 180 residues (about 276,000 residues), every
    # 20th from the 5th an exact duplicate, every 20th from the 9th
    # contained in an earlier entry
    prng = np.random.default_rng(3)
    seqs = []
    for i in range(2300):
        if i % 20 == 5:
            s = seqs[i - 3]
        elif i % 20 == 9:
            s = seqs[i - 4][10:50]
        else:
            s = AA[prng.integers(0, 20, int(prng.integers(60, 181)))] \
                .tobytes().decode()
        seqs.append(s)
    big = str(d / "proteins.fasta")
    write_fasta(big, [(f"p{i} protein {i}", s) for i, s in enumerate(seqs)],
                width=60)
    assert cs(["-i", big, "-n", "true"]) == 0
    return small, big, sum(map(len, seqs))


def parity(argv, monkeypatch, host_scan):
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_MESH", "0")
    key = tuple(argv)
    if key not in _JAX_OUT:
        monkeypatch.setenv("SAT_HOST_SCAN", "1")
        want = io.StringIO()
        jax_nrdb.run(jax_nrdb.parse_args(list(argv)), want)
        _JAX_OUT[key] = want.getvalue()
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    got = io.StringIO()
    torch_nrdb.run(torch_nrdb.parse_args(list(argv)), got)
    return _JAX_OUT[key], got.getvalue()


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", NR_CONFIGS, ids=lambda c: " ".join(c) or "d")
def test_nrdb_parity(nr_files, cfg, host_scan, monkeypatch):
    small, _big, _n = nr_files
    want, got = parity(["-i", small] + cfg, monkeypatch, host_scan)
    assert want
    assert got == want


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", [[], ["-C"]], ids=["d", "-C"])
def test_nrdb_census_rung(nr_files, cfg, host_scan, monkeypatch):
    """2,300 seeds over 276,000 residues: the census rung, its plain
    version on the device route."""
    _small, big, n_res = nr_files
    assert n_res > 1 << 18
    calls = []
    ref = slots.scan_slots_ref
    monkeypatch.setattr(slots, "scan_slots_ref",
                        lambda *a, **kw: calls.append(1) or ref(*a, **kw))
    want, got = parity(["-i", big] + cfg, monkeypatch, host_scan)
    assert got == want
    # the planted duplicates and contained entries are gone
    assert got.count(">") == 2300 - 115 * (2 if cfg else 1)
    assert (len(calls) > 0) == (host_scan == "0")


def test_nrdb_dispatcher(nr_files, monkeypatch, capsys):
    small, _big, _n = nr_files
    want, _got = parity(["-i", small, "-C"], monkeypatch, "0")
    monkeypatch.setattr("sys.argv", ["sat", "nrdb", "-i", small, "-C"])
    capsys.readouterr()
    assert torch_main.main() == 0
    assert capsys.readouterr().out == want
