"""The port never imports jax, nor anything of the JAX package.

A site-less interpreter (``python -S``, ``sys.path`` built by hand as the
``sat`` launcher builds it) runs the port's CLI on a synthetic database
through the plain PyTorch scan and through the native host machine, and
reports whether jax or any module of the JAX package
(``sequence_alignment_tools_tpu`` or ``sequence_alignment_tools_tpu.*``)
was imported, for exact search, for ``-k 1`` (the gated seed scan and the
native extension) and for the filter engine (``-k 2``: the Myers scan and
the cluster verify; ``-K 2``: the poisoned k-mismatch scan), for
peptide_scan and ``primer_match -T`` (the six-frame translation), and for
xmers and allvall (a model or a scanner per batch or chunk); a source
scan checks every file of the package, ``chip_smoke.py`` and
``kernel_probe.py``.
"""

import io
import os
import pathlib
import re
import subprocess
import sys

import pytest

from sequence_alignment_tools_tpu.apps import primer_match as jax_app
from tests.conftest import make_synthetic_fasta

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "sequence_alignment_tools_tpu_torch"

BOOT = r"""
import atexit, os, runpy, sys
venv = os.path.dirname(os.path.dirname(sys.executable))
sp = os.path.join(venv, "lib", "python%d.%d" % sys.version_info[:2],
                  "site-packages")
if not os.path.isdir(sp):
    import sysconfig
    sp = sysconfig.get_paths()["purelib"]
sys.path[:0] = [sp, sys.argv[1]]
atexit.register(lambda: sys.stderr.write(
    "jax_imported=%s jax_package_imported=%s\n" % (
        "jax" in sys.modules,
        any(m == "sequence_alignment_tools_tpu"
            or m.startswith("sequence_alignment_tools_tpu.")
            for m in sys.modules))))
sys.argv = ["sequence_alignment_tools_tpu_torch"] + sys.argv[2:]
runpy.run_module("sequence_alignment_tools_tpu_torch", run_name="__main__",
                 alter_sys=True)
"""


@pytest.mark.parametrize("host_scan,flags", [("0", ["-r", "-c"]),
                                             ("1", ["-r"]),
                                             ("0", ["-k", "1", "-r"]),
                                             ("0", ["-k", "2", "-r"]),
                                             ("0", ["-K", "2", "-r"]),
                                             ("0", ["-N", "6", "-k", "1",
                                                    "-r"]),
                                             ("0", ["-N", "15", "-K", "2",
                                                    "-r"])],
                         ids=["torch-blocks", "host-machine", "gated-k1",
                              "filter-k2", "filter-K2", "hash", "gs"])
def test_sitless_cli_never_imports_jax(tmp_path, capsys, monkeypatch,
                                       host_scan, flags):
    fasta = str(tmp_path / "db.fasta")
    make_synthetic_fasta(fasta, total=40_000, seed=5,
                         planted=[(1200, "ACGTTGCAGGTACCA"),
                                  (9000, "TGGTACCTGCAACGT")])
    pats = tmp_path / "p.txt"
    pats.write_text("ACGTTGCAGGTACCA\nGATTACAGATTACA\n")
    argv = ["-i", fasta, "-P", str(pats)] + flags
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(SAT_DEVICE="cpu", SAT_HOST_SCAN=host_scan)
    r = subprocess.run(
        [sys.executable, "-S", "-c", BOOT, str(REPO), "primer_match"] + argv,
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"jax_imported=False jax_package_imported=False" in r.stderr, \
        r.stderr.decode()[-1500:]
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    monkeypatch.setenv("SAT_MESH", "0")
    capsys.readouterr()
    jax_app.main(argv)
    want = capsys.readouterr().out
    assert want.count("\n") >= 2
    assert r.stdout.decode() == want


@pytest.mark.parametrize("flags", [["-r"], ["-r", "-k", "1"]],
                         ids=["k0", "k1"])
def test_sitless_pcr_match_never_imports_jax(tmp_path, flags):
    from sequence_alignment_tools_tpu.apps import pcr_match as jax_pcr
    from sequence_alignment_tools_tpu.utils.iupac import reverse_comp

    fwd, rev = "ACGTTGCAGGTACCA", "GATTACAGATTACAG"
    fasta = str(tmp_path / "db.fasta")
    make_synthetic_fasta(fasta, total=40_000, seed=5,
                         planted=[(1200, fwd), (1500, reverse_comp(rev))])
    argv = ["-i", fasta, "-p", f"{fwd} {rev}"] + flags
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(SAT_DEVICE="cpu", SAT_HOST_SCAN="0")
    r = subprocess.run(
        [sys.executable, "-S", "-c", BOOT, str(REPO), "pcr_match"] + argv,
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"jax_imported=False jax_package_imported=False" in r.stderr, \
        r.stderr.decode()[-1500:]
    want = io.StringIO()
    jax_pcr.run(jax_pcr.parse_args(argv), want)
    assert want.getvalue().count("\n") >= 1
    assert r.stdout.decode() == want.getvalue()


@pytest.mark.parametrize("tool,flags", [("peptide_scan", ["-T", "A"]),
                                        ("peptide_scan", ["-K", "1"]),
                                        ("primer_match", ["-T", "-r"])],
                         ids=["peptide-6frame", "peptide-protein",
                              "primer-translate"])
def test_sitless_translated_tools_never_import_jax(tmp_path, tool, flags):
    from sequence_alignment_tools_tpu.apps import peptide_scan as jax_pep
    from sequence_alignment_tools_tpu.apps.compress_seq import main as cs

    protein = "-T" not in flags
    fasta = str(tmp_path / "db.fasta")
    text = make_synthetic_fasta(
        fasta, total=12_000, seed=9,
        alphabet="ACDEFGHIKLMNPQRSTVWY" if protein else "ACGT")
    assert cs(["-i", fasta, "-n", "true"]) == 0
    peps = [text[500:509], text[7_000:7_008]] if protein else \
        ["MKTAYIAK", "GGIEDELK"]
    argv = ["-i", fasta, "-p", " ".join(peps)] + flags
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(SAT_DEVICE="cpu", SAT_HOST_SCAN="0")
    r = subprocess.run(
        [sys.executable, "-S", "-c", BOOT, str(REPO), tool] + argv,
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"jax_imported=False jax_package_imported=False" in r.stderr, \
        r.stderr.decode()[-1500:]
    app = jax_pep if tool == "peptide_scan" else jax_app
    want = io.StringIO()
    app.run(app.parse_args(argv), want)
    if protein:
        assert want.getvalue().count("\n") >= 2
    assert r.stdout.decode() == want.getvalue()


@pytest.mark.parametrize("tool", ["xmers", "allvall"])
def test_sitless_xmers_allvall_never_import_jax(tmp_path, tool):
    """xmers (phases 1 and 2 over batches of a normalized database) and
    allvall (``-K 1 -r``, the bitmap on stdout), on the plain device
    route."""
    from sequence_alignment_tools_tpu.apps import allvall as jax_av
    from sequence_alignment_tools_tpu.apps import xmers as jax_xm
    from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
        main as cs,
    )

    fasta = str(tmp_path / "db.fasta")
    if tool == "xmers":
        text = make_synthetic_fasta(fasta, n_entries=1, total=400, seed=12)
        with open(fasta, "a") as f:
            f.write(">rep\n" + text[100:160] + "\n")
        assert cs(["-i", fasta, "-n", "true"]) == 0
        argv = ["-i", fasta, "-m", "12", "-K", "1", "-R", "-b", "100"]
    else:
        text = make_synthetic_fasta(fasta, total=3000, seed=12)
        bg = tmp_path / "bg.fasta"
        bg.write_text(">bg\n" + text[500:560] + "\n")
        query = str(tmp_path / "q.fasta")
        make_synthetic_fasta(query, n_entries=1, total=400, seed=13,
                             planted=[(100, text[510:540])])
        argv = ["-i", query, "-b", str(bg), "-m", "20", "-K", "1", "-r",
                "-o", "-"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(SAT_DEVICE="cpu", SAT_HOST_SCAN="0")
    r = subprocess.run(
        [sys.executable, "-S", "-c", BOOT, str(REPO), tool] + argv,
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"jax_imported=False jax_package_imported=False" in r.stderr, \
        r.stderr.decode()[-1500:]
    out = tmp_path / "jax.out"
    if tool == "xmers":
        assert jax_xm.main(argv + ["-o", str(out)]) == 0
        assert r.stdout.count(b"-1:") > 0
    else:
        assert jax_av.allvall_main(argv[:-1] + [str(out)]) == 0
        assert r.stdout.count(b"BINARY RUN LENGTHS") == 2
    assert r.stdout == out.read_bytes()


# an import of the JAX package: a module path that starts with its name
# and does not go on with "_torch"
JAX_PKG_IMPORT = re.compile(
    r"^\s*(from|import)\s+sequence_alignment_tools_tpu(?!_torch)\b",
    re.MULTILINE)


def test_no_file_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "kernel_probe.py"]
    assert len(files) >= 12
    for mod in ("ops/cuda/slots.py", "ops/gapped_seeds.py",
                "models/pcr_match.py", "apps/pcr_match.py",
                "io/translate.py", "apps/peptide_scan.py",
                "apps/exact_match.py", "apps/inexact_match.py",
                "apps/nrdb.py", "apps/tandem_match.py", "apps/allvall.py",
                "models/xmers.py", "apps/xmers.py", "apps/compress_seq.py",
                "apps/protein_mw.py", "apps/peptide_mult.py"):
        assert PKG / mod in files
    for f in files:
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f
        assert not JAX_PKG_IMPORT.search(text), f
