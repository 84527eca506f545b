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
xmers and allvall (a model or a scanner per batch or chunk), for one
tool of each host stack (kmer_count, pairscan, ``walk_graph -O``,
Xspace) against the JAX app's bytes, and for every one of the 21 tools
that reach no scanner in one interpreter that first imports each of
their 19 modules, and for primer_match sharded over a 4-entry CPU mesh
after importing the three ``parallel`` modules of the mesh; a source
scan checks every file of the package, ``chip_smoke.py``,
``kernel_probe.py`` and the ``sat_torch`` launcher.
"""

import contextlib
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


HOST_MODULES = ("apps.extract_seq", "apps.aacomp", "apps.kmer_count",
                "apps.kmer_annotate", "apps.polyrun", "apps.atac_seq",
                "apps.chario", "apps.genome_simulation",
                "apps.solid_simulation", "ops.merhash", "apps.pairscan",
                "ops.netflo", "models.word_graph", "apps.wordgraph_build",
                "apps.walk_graph", "apps.solid_assembly", "apps.indexer",
                "models.xspace", "apps.xspace")

# a site-less interpreter that imports each host module, then runs each
# argv of the JSON file named by argv[2] through the port's dispatcher
BOOT_MANY = r"""
import json, os, sys
venv = os.path.dirname(os.path.dirname(sys.executable))
sp = os.path.join(venv, "lib", "python%d.%d" % sys.version_info[:2],
                  "site-packages")
if not os.path.isdir(sp):
    import sysconfig
    sp = sysconfig.get_paths()["purelib"]
sys.path[:0] = [sp, sys.argv[1]]
import importlib
for m in json.loads(sys.argv[3]):
    importlib.import_module("sequence_alignment_tools_tpu_torch." + m)
from sequence_alignment_tools_tpu_torch import __main__ as dispatch
for argv in json.load(open(sys.argv[2])):
    sys.argv = ["sequence_alignment_tools_tpu_torch"] + argv
    try:
        rc = dispatch.main()
    except SystemExit as e:
        rc = e.code
    sys.stdout.flush()
    sys.stderr.write("rc %s=%s\n" % (argv[0], rc))
sys.stderr.write("jax_imported=%s jax_package_imported=%s\n" % (
    "jax" in sys.modules,
    any(m == "sequence_alignment_tools_tpu"
        or m.startswith("sequence_alignment_tools_tpu.")
        for m in sys.modules)))
"""


def host_inputs(d):
    """Small inputs for every host tool: a normalized DNA database, a
    protein FASTA, extract_seq and atac_seq records, a chario stream."""
    from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
        main as cs,
    )

    db = str(d / "db.fasta")
    text = make_synthetic_fasta(db, total=3000, seed=21,
                                planted=[(1500, "A" * 25)])
    with open(db, "a") as f:
        f.write(">rep\n" + text[100:400] + "\n")
    assert cs(["-i", db, "-n", "true"]) == 0
    rng = __import__("random").Random(4)
    (d / "prot.fasta").write_text("".join(
        f">q{i}\n" + "".join(rng.choice("ACDEFGHIKLMNPQRSTVWY")
                             for _ in range(120)) + "\n" for i in range(2)))
    (d / "pos.txt").write_text("0 10 20\n1 5 30\n-1 400 15\n")
    (d / "rec.txt").write_text("r1 0 10 30 0 0\nr2 1 100 25 1 1\n")
    (d / "in.seq").write_text(text[:600] + "$")
    return db


def host_tool_runs(d):
    db = host_inputs(d)
    p = {n: str(d / n) for n in ("prot.fasta", "pos.txt", "rec.txt",
                                 "in.seq", "ix.bin", "mers.txt", "g.sqn",
                                 "ps.bm", "g.wg", "g.sq", "ix", "pa", "xs",
                                 "lo", "wg.ee")}
    ix = p["ix"]
    return [
        ["extract_seq", "-i", db, "-A", p["pos.txt"]],
        ["aacomp", "-i", p["prot.fasta"], "-M", "600", "-o", p["ix.bin"]],
        ["aacomplookup", "-i", p["ix.bin"], "-t", "0.5"],
        ["kmer_count", "-i", db, "-k", "6", "-a", "-o", p["mers.txt"]],
        ["kmer_annotate", "-m", p["mers.txt"], "-s", db, "-k", "6"],
        ["polyrun", "-i", db, "-l", "20"],
        ["atac_seq", "-i", db, "-A", p["rec.txt"]],
        ["chario", "-i", p["in.seq"]],
        ["genome_simulation", "-l", "1000", "-s", "1", "-o", p["g.sqn"]],
        ["solid_simulation", "-i", db, "-m", "20", "-S", "5", "-s", "3"],
        ["pairscan", "-i", db, "-o", p["ps.bm"], "-m", "4", "-D", "3"],
        ["build_graph", "-i", db, "-k", "8", "-g", p["g.wg"], "-s",
         p["g.sq"]],
        ["walk_graph", "-g", p["g.wg"], "-s", p["g.sq"], "-k", "8", "-R",
         "-O"],
        ["cannon_csbh_graph", "-g", p["g.wg"], "-k", "8"],
        ["csbh_annotate", "-g", p["g.wg"], "-k", "8"],
        ["solid_assembly", "-g", p["g.wg"], "-i", db, "-k", "8"],
        ["Indexer", "-i", ix + ".idx", "-f", ix + ".fwd", "-r", ix + ".rev",
         db],
        ["IndexerAA", "-i", p["pa"] + ".idx", "-f", p["pa"] + ".seq",
         p["prot.fasta"]],
        ["Xspace", "-m", "6", "-a", "-i", ix + ".idx", "-f", ix + ".fwd",
         "-o", p["xs"]],
        ["XspaceLo", "-k", "6", "-i", ix + ".idx", "-f", ix + ".fwd", "-r",
         ix + ".rev", "-o", p["lo"]],
        ["WordGraph", "-x", p["xs"], "-m", "6", "-f", ix + ".fwd", "-o",
         p["wg.ee"]],
    ]


def test_sitless_host_tools_never_import_jax(tmp_path):
    """Each of the 19 host modules imports, and each of the 21 tool names
    that reach no scanner runs, in one site-less interpreter that loads
    neither jax nor the JAX package."""
    import json

    from sequence_alignment_tools_tpu import __main__ as jax_main
    from sequence_alignment_tools_tpu_torch import __main__ as torch_main

    runs = host_tool_runs(tmp_path)
    names = [r[0] for r in runs]
    assert len(set(names)) == 21
    assert set(torch_main._TOOLS) == set(jax_main._TOOLS)
    assert {torch_main._TOOLS[n][0] for n in names} == {
        m.split(".")[1] for m in HOST_MODULES if m.startswith("apps.")}
    plan = tmp_path / "runs.json"
    plan.write_text(json.dumps(runs))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(SAT_DEVICE="cpu")
    r = subprocess.run(
        [sys.executable, "-S", "-c", BOOT_MANY, str(REPO), str(plan),
         json.dumps(HOST_MODULES)], input=b"250.5\n410.2\n",
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    err = r.stderr.decode(errors="replace")
    assert r.returncode == 0, err[-1500:]
    rcs = dict(line[3:].split("=") for line in err.splitlines()
               if line.startswith("rc "))
    assert sorted(rcs) == sorted(names)
    for name, rc in rcs.items():
        # chario's wall-seeded random seeks may hit the reference's
        # getbasepos abort, which it mirrors with 134
        assert rc == "0" or (name == "chario" and rc == "134"), (name, rc)
    assert "jax_imported=False jax_package_imported=False" in err, err[-1500:]
    assert (tmp_path / "wg.ee").read_text().endswith(".\n")


@pytest.mark.parametrize("tool", ["kmer_count", "pairscan", "walk_graph",
                                  "Xspace"])
def test_sitless_host_stack_never_imports_jax(tmp_path, tool):
    """One tool of each host stack through the site-less CLI, against the
    JAX app's stdout and output file."""
    from test_torch_seq_tools import entry

    runs = {r[0]: r for r in host_tool_runs(tmp_path)}
    for pre in {"walk_graph": ["build_graph"],
                "Xspace": ["Indexer"]}.get(tool, []):
        assert entry("sequence_alignment_tools_tpu", pre)(runs[pre][1:]) == 0
    argv = {"kmer_count": runs["kmer_count"][1:5] + ["-a"],
            "pairscan": runs["pairscan"][1:],
            "walk_graph": runs["walk_graph"][1:],
            "Xspace": runs["Xspace"][1:]}[tool]
    out_file = {"pairscan": "ps.bm", "Xspace": "xs"}.get(tool)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(SAT_DEVICE="cpu")
    r = subprocess.run(
        [sys.executable, "-S", "-c", BOOT, str(REPO), tool] + argv,
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"jax_imported=False jax_package_imported=False" in r.stderr, \
        r.stderr.decode()[-1500:]
    got = (tmp_path / out_file).read_bytes() if out_file else r.stdout
    if out_file:
        (tmp_path / out_file).unlink()
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        assert entry("sequence_alignment_tools_tpu", tool)(argv) == 0
    if out_file:
        assert (tmp_path / out_file).read_bytes() == got
    else:
        assert got.decode() == want.getvalue()
    assert len(got) > 100


# an import of the JAX package: a module path that starts with its name
# and does not go on with "_torch"
PARALLEL_MODULES = ("parallel.shard", "parallel.multihost",
                    "parallel.devcache")


@pytest.mark.parametrize("flags", [["-r"], ["-k", "1", "-r"]],
                         ids=["k0", "k1"])
def test_sitless_mesh_never_imports_jax(tmp_path, capsys, monkeypatch,
                                        flags):
    """The parallel modules import, and primer_match runs sharded over a
    4-entry CPU mesh (``SAT_MESH=4``), in a site-less interpreter that
    loads neither jax nor the JAX package; its bytes are the JAX app's
    single-device bytes."""
    import json

    fasta = str(tmp_path / "db.fasta")
    make_synthetic_fasta(fasta, total=40_000, seed=9,
                         planted=[(1200, "ACGTTGCAGGTACCA"),
                                  (19_995, "ACGTTGCAGGTACCA"),
                                  (30_010, "TGGTACCTGCAACGT")])
    pats = tmp_path / "p.txt"
    pats.write_text("ACGTTGCAGGTACCA\nGATTACAGATTACA\n")
    argv = ["-i", fasta, "-P", str(pats)] + flags
    plan = tmp_path / "runs.json"
    plan.write_text(json.dumps([["primer_match"] + argv]))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(SAT_DEVICE="cpu", SAT_HOST_SCAN="0", SAT_MESH="4",
               SAT_ROUTE_VERBOSE="1")
    r = subprocess.run(
        [sys.executable, "-S", "-c", BOOT_MANY, str(REPO), str(plan),
         json.dumps(PARALLEL_MODULES)],
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    err = r.stderr.decode(errors="replace")
    assert r.returncode == 0 and "rc primer_match=0" in err, err[-1500:]
    assert "sharded over 4 devices" in err, err[-1500:]
    assert "jax_imported=False jax_package_imported=False" in err, err[-1500:]
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    monkeypatch.setenv("SAT_MESH", "0")
    capsys.readouterr()
    jax_app.main(argv)
    want = capsys.readouterr().out
    assert want.count("\n") >= 2
    assert r.stdout.decode() == want


JAX_PKG_IMPORT = re.compile(
    r"^\s*(from|import)\s+sequence_alignment_tools_tpu(?!_torch)\b",
    re.MULTILINE)


def test_no_file_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "kernel_probe.py",
                                         REPO / "sat_torch"]
    assert len(files) >= 12
    for mod in ("ops/cuda/slots.py", "ops/gapped_seeds.py",
                "models/pcr_match.py", "apps/pcr_match.py",
                "io/translate.py", "apps/peptide_scan.py",
                "apps/exact_match.py", "apps/inexact_match.py",
                "apps/nrdb.py", "apps/tandem_match.py", "apps/allvall.py",
                "models/xmers.py", "apps/xmers.py", "apps/compress_seq.py",
                "apps/protein_mw.py", "apps/peptide_mult.py") + tuple(
                    m.replace(".", "/") + ".py"
                    for m in HOST_MODULES + PARALLEL_MODULES):
        assert PKG / mod in files
    for f in files:
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f
        assert not JAX_PKG_IMPORT.search(text), f
