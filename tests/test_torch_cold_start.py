"""The cold one-shot regime: the site-less ``sat_torch`` launcher.

``python -S sat_torch <tool> ...`` is the port's counterpart of
``python -S sat``: where the JAX package under ``sat`` never imports jax,
the port under ``sat_torch`` never imports torch, and the two print the
same bytes.  Each case runs under both launchers with ``SAT_BOOT_DEBUG=1``
and ``SAT_MESH=0`` and ``SAT_DEVICE`` unset (so a host-routed run must
succeed on a machine without a card, as the JAX one does): primer_match
``-r -c``, ``-k 1``, ``-k 2`` and ``-K 2``, exact_match, ``pcr_match
-r``, peptide_scan, nrdb, ``compress_seq -n true``, kmer_count and
``--help``.  Then the device route under the launcher: forced with
``SAT_HOST_SCAN=0 SAT_DEVICE=cpu`` it imports torch mid-run and prints
the same bytes; with ``SAT_DEVICE`` unset it raises the ``SAT_DEVICE=cpu``
error (no fallback).  A devcount cache primed with 1 under
``SAT_MESH=auto`` keeps torch unloaded, importing the package, its
dispatcher, every app, the models and the scanner modules loads no torch,
and eight threads loading a native library for the first time at once
all get it.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from tests.conftest import make_synthetic_fasta

REPO = pathlib.Path(__file__).resolve().parents[1]
SAT = str(REPO / "sat")
SAT_TORCH = str(REPO / "sat_torch")
TIMEOUT = 120
FWD, REV = "ACGTTGCAGGTACCA", "GATTACAGATTACAG"
PROTEINS = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A 200,000-base DNA database with primers planted, its primer file,
    a normalized protein database with peptides cut from it, and 300
    proteins for nrdb (some repeated)."""
    from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
        main as compress_seq,
    )
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    d = tmp_path_factory.mktemp("cold")
    db = str(d / "db.fasta")
    make_synthetic_fasta(db, total=200_000, seed=3,
                         planted=[(1200, FWD), (1500, reverse_comp(REV)),
                                  (9000, "TGGTACCTGCAACGT")])
    (d / "p.txt").write_text(f"{FWD}\nGATTACAGATTACA\n")
    prot = str(d / "prot.fasta")
    text = make_synthetic_fasta(prot, total=12_000, seed=9,
                                alphabet=PROTEINS)
    assert compress_seq(["-i", prot, "-n", "true"]) == 0
    rng = __import__("random").Random(17)
    seqs = ["".join(rng.choice(PROTEINS) for _ in range(rng.randint(40, 90)))
            for _ in range(270)]
    seqs += seqs[:30]
    (d / "nr.fasta").write_text("".join(f">n{i} protein {i}\n{s}\n"
                                        for i, s in enumerate(seqs)))
    return {"dir": d, "db": db, "pats": str(d / "p.txt"), "prot": prot,
            "peps": f"{text[500:509]} {text[7_000:7_008]}",
            "nr": str(d / "nr.fasta")}


def run(launcher, argv, cwd, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "SAT_DEVICE",
                        "SAT_HOST_SCAN", "SAT_MESH")}
    env.update(SAT_BOOT_DEBUG="1", SAT_MESH="0")
    env.update(env_extra)
    env = {k: v for k, v in env.items() if v is not None}
    return subprocess.run([sys.executable, "-S", launcher] + argv,
                          capture_output=True, timeout=TIMEOUT, env=env,
                          cwd=str(cwd))


def boot_line(r):
    lines = [ln for ln in r.stderr.decode(errors="replace").splitlines()
             if ln.startswith("sat-boot:")]
    assert lines, r.stderr.decode(errors="replace")[-1500:]
    return lines[-1]


CASES = {
    "primer-c": ("primer_match", ["-r", "-c"]),
    "primer-k1": ("primer_match", ["-r", "-k", "1"]),
    "primer-k2": ("primer_match", ["-r", "-k", "2"]),
    "primer-K2": ("primer_match", ["-r", "-K", "2"]),
    "exact_match": ("exact_match", ["-r"]),
    "pcr_match": ("pcr_match", ["-r"]),
    "peptide_scan": ("peptide_scan", []),
    "nrdb": ("nrdb", []),
    "compress_seq": ("compress_seq", ["-n", "true"]),
    "kmer_count": ("kmer_count", ["-k", "4", "-a"]),
    "help": ("--help", []),
}


def argv_of(case, inputs, db=None):
    tool, flags = CASES[case]
    if tool == "--help":
        return [tool]
    src = {"peptide_scan": ["-i", inputs["prot"], "-p", inputs["peps"]],
           "pcr_match": ["-i", inputs["db"], "-p", f"{FWD} {REV}"],
           "nrdb": ["-i", inputs["nr"]],
           "kmer_count": ["-i", inputs["db"]],
           "compress_seq": ["-i", db]}.get(
               tool, ["-i", inputs["db"], "-P", inputs["pats"]])
    return [tool] + src + flags


@pytest.mark.parametrize("case", list(CASES))
def test_host_routes_never_import_torch(inputs, tmp_path, case):
    """Equal stdout under both launchers, the JAX one free of jax and the
    port free of torch, with ``SAT_DEVICE`` unset."""
    outs = {}
    for name, launcher in (("sat", SAT), ("sat_torch", SAT_TORCH)):
        cwd = tmp_path / name
        cwd.mkdir()
        db = None
        if case == "compress_seq":
            db = str(cwd / "c.fasta")
            shutil.copy(inputs["db"], db)
        r = run(launcher, argv_of(case, inputs, db), cwd)
        assert r.returncode == 0, r.stderr.decode(errors="replace")[-1500:]
        if name == "sat":
            assert boot_line(r) == "sat-boot: jax_imported=False"
        else:
            assert boot_line(r) == ("sat-boot: torch_imported=False "
                                    "cuda_initialized=False")
        outs[name] = r.stdout
        if case == "compress_seq":
            outs[name] += b"".join(p.read_bytes()
                                   for p in sorted(cwd.iterdir())
                                   if p.name != "c.fasta")
    assert outs["sat"] == outs["sat_torch"]
    if case.startswith("primer") or case in ("exact_match", "pcr_match",
                                             "peptide_scan", "nrdb",
                                             "kmer_count", "compress_seq"):
        assert outs["sat"].count(b"\n") >= 2


def test_device_route_imports_torch(inputs, tmp_path):
    """``SAT_HOST_SCAN=0 SAT_DEVICE=cpu``: the launcher imports torch when
    the gated seed scan first runs, and prints the host route's bytes."""
    argv = argv_of("primer-k1", inputs)
    host = run(SAT_TORCH, argv, tmp_path)
    dev = run(SAT_TORCH, argv, tmp_path, SAT_HOST_SCAN="0", SAT_DEVICE="cpu",
              SAT_ROUTE_VERBOSE="1")
    assert dev.returncode == 0, dev.stderr.decode(errors="replace")[-1500:]
    assert boot_line(dev) == ("sat-boot: torch_imported=True "
                              "cuda_initialized=False")
    assert b"gated seed scan + extension gate (plain PyTorch, CPU)" \
        in dev.stderr
    assert dev.stdout == host.stdout and host.stdout.count(b"\n") >= 2


def test_device_route_without_a_card_raises(inputs, tmp_path):
    """``SAT_HOST_SCAN=0`` with ``SAT_DEVICE`` unset asks for CUDA: on a
    machine without a card the run exits non-zero with the
    ``SAT_DEVICE=cpu`` message and prints nothing; nothing falls back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device route runs")
    r = run(SAT_TORCH, argv_of("primer-c", inputs), tmp_path,
            SAT_HOST_SCAN="0")
    assert r.returncode != 0
    assert b"set SAT_DEVICE=cpu" in r.stderr
    assert r.stdout == b""


def test_cached_single_device_keeps_torch_unloaded(inputs, tmp_path):
    """``SAT_MESH=auto`` with a fresh cached device count of 1: the model
    answers "no mesh" from the cache and never asks the CUDA driver."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    node = "".join(c if c.isalnum() else "_"
                   for c in "%s_cuda" % os.uname().nodename)
    (tmp / f"sat_torch_devcount_{node}").write_text("1")
    argv = argv_of("primer-c", inputs)
    r = run(SAT_TORCH, argv, tmp_path, SAT_MESH="auto", TMPDIR=str(tmp))
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-1500:]
    assert boot_line(r) == ("sat-boot: torch_imported=False "
                            "cuda_initialized=False")
    assert r.stdout == run(SAT, argv, tmp_path).stdout


IMPORTS = r"""
import importlib, pkgutil, sys
pkg = "sequence_alignment_tools_tpu_torch"
import sequence_alignment_tools_tpu_torch.apps as apps
names = [pkg, pkg + ".__main__", pkg + ".models.primer_match",
         pkg + ".models.pcr_match", pkg + ".ops.conv_scan",
         pkg + ".ops.sellers", pkg + ".ops.tables"]
names += [pkg + ".apps." + m.name for m in pkgutil.iter_modules(apps.__path__)]
for name in names:
    importlib.import_module(name)
print(len(names), "torch" in sys.modules)
"""


def test_import_graph_loads_no_torch():
    r = subprocess.run([sys.executable, "-c", IMPORTS], capture_output=True,
                       timeout=TIMEOUT, cwd=str(REPO))
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-1500:]
    count, torch_loaded = r.stdout.split()
    assert int(count) >= 30 and torch_loaded == b"False"


def test_native_library_first_load_across_threads(monkeypatch):
    """Eight threads asking at once for a native library that this
    process has not loaded yet all get it: the first load is serialised,
    so no thread sees the loader's placeholder and falls back."""
    import threading

    from sequence_alignment_tools_tpu_torch import native

    assert native.load_shift_and_lib() is not None
    monkeypatch.setattr(native, "_LIBS", {})
    gate = threading.Barrier(8)
    got = []

    def load():
        gate.wait()
        got.append(native.load_shift_and_lib())

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert len(got) == 8 and all(lib is not None for lib in got)
