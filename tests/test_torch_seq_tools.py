"""The port's host sequence tools against the JAX package's: extract_seq,
kmer_count, polyrun, kmer_annotate, aacomp / aacomplookup, atac_seq,
chario, genome_simulation and solid_simulation (with ``Drand48``).

Each CLI runs in-process on both packages, each side in a directory of
its own, on one synthesized database per module (made from a fixed seed
and normalized with the port's compress_seq); stdout bytes, stderr bytes,
exit status and every file the tool writes must be equal.  The cases are
the configuration lists of the JAX package's tests of these tools
(``KC_CONFIGS``, ``PR_CONFIGS``, ``KA_CONFIGS``, ``ATAC_CONFIGS``, the
chario contents).  chario's random seeks and rate lines read the wall
clock, so ``time.time`` and ``time.localtime`` are pinned for both sides.

``run_both`` is shared with the other ``test_torch_*`` parity files of
the host tools.
"""

import ctypes
import ctypes.util
import importlib
import io
import random
import sys
import time

import numpy as np
import pytest

from sequence_alignment_tools_tpu import __main__ as jax_main
from sequence_alignment_tools_tpu_torch.apps.compress_seq import main as cs
from sequence_alignment_tools_tpu_torch.apps.genome_simulation import Drand48

PACKAGES = ("sequence_alignment_tools_tpu", "sequence_alignment_tools_tpu_torch")


def entry(pkg, tool):
    """The entry function the JAX dispatcher maps ``tool`` to, in ``pkg``."""
    mod, fn = jax_main._TOOLS[tool]
    return getattr(importlib.import_module(f"{pkg}.apps.{mod}"), fn)


def run_tool(pkg, tool, argv, cwd, monkeypatch, stdin=""):
    """(exit status, stdout bytes, stderr bytes, {file: bytes} of ``cwd``)
    of one in-process run of ``tool`` from ``pkg`` with ``cwd`` as the
    working directory."""
    out, err = io.BytesIO(), io.BytesIO()
    streams = [io.TextIOWrapper(b, encoding="utf-8", errors="surrogateescape",
                                newline="\n", write_through=True)
               for b in (out, err)]
    with monkeypatch.context() as m:
        m.chdir(cwd)
        m.setattr(sys, "stdout", streams[0])
        m.setattr(sys, "stderr", streams[1])
        m.setattr(sys, "stdin", io.StringIO(stdin))
        try:
            rc = entry(pkg, tool)(list(argv))
        except SystemExit as e:
            rc = e.code
    files = {p.name: p.read_bytes() for p in sorted(cwd.iterdir())
             if p.is_file()}
    return 0 if rc is None else rc, out.getvalue(), err.getvalue(), files


def run_both(tool, argv, tmp_path, monkeypatch, stdin="", setup=None):
    """Run ``tool`` from both packages on ``argv`` (relative output names
    land in each side's own directory; ``setup(d)`` may seed it) and
    assert the two runs equal; returns the JAX run."""
    runs = []
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir(parents=True)
        if setup is not None:
            setup(d)
        runs.append(run_tool(pkg, tool, argv, d, monkeypatch, stdin))
    want, got = runs
    assert got[0] == want[0], (got[0], want[0], got[2][-800:])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert sorted(got[3]) == sorted(want[3])
    for name in want[3]:
        assert got[3][name] == want[3][name], name
    return want


def write_fasta(path, entries, width=70):
    with open(path, "w") as f:
        for h, s in entries:
            f.write(f">{h}\n")
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + "\n")


@pytest.fixture(scope="module")
def seq_files(tmp_path_factory):
    """One DNA database with homopolymer runs, an N run and a non-ACGT run
    (after ``tests/test_seq_tools.py``), in four entries; a protein
    database (after ``tests/test_mass_tools.py``); the extract_seq and
    atac_seq records; kmer_count's ``-k 6 -a`` tables for kmer_annotate."""
    d = tmp_path_factory.mktemp("torch_seq_tools")
    rng = random.Random(11)
    seq = [rng.choice("ACGT") for _ in range(8000)]
    seq[500:530] = ["A"] * 30
    seq[1000:1025] = ["N"] * 25
    seq[2000:2022] = ["T"] * 22
    seq[3000:3040] = ["G"] * 40
    seq[3900:3925] = ["x"] * 25
    seq[6100:6130] = ["C"] * 30
    s = "".join(seq)
    entries = [("p1 poly entry one", s[:5000]), ("p2 poly entry two",
                                                 s[5000:7400]),
               ("p3 short three", s[7400:7700]), ("p4 tail four", s[7700:])]
    db = d / "poly.fasta"
    write_fasta(db, entries)
    raw = d / "poly_raw.fasta"
    write_fasta(raw, entries, width=57)
    assert cs(["-i", str(db), "-n", "true"]) == 0

    aas = "ACDEFGHIKLMNPQRSTVWY"
    prots = ["".join(rng.choice(aas) for _ in range(400)) for _ in range(3)]
    p2 = list(prots[2])
    p2[50], p2[120], p2[200] = "X", "B", "Z"
    prots[2] = "".join(p2)
    prot = d / "prot.fasta"
    write_fasta(prot, [(f"q{i} prot {i}", p) for i, p in enumerate(prots)],
                width=60)

    pos = d / "pos.txt"
    pos.write_text("0 10 20\n2 5 30\n-1 400 15\n1 0 10\n2 290 20\n"
                   "5 0 5\n99 0 5\n0 0 0\n3 10 8\n-1 5003 12\n1 2390 10\n")
    rec = d / "rec.txt"
    rec.write_text("r1 0 10 30 0 0\nr2 0 100 25 1 1\nr3 1 5 40 0 0\n"
                   "r4 0 60 30 0 0\nr5 2 200 50 1 1\nr6 1 990 40 0 0\n"
                   "r7 3 0 20 0 0\nr8 0 1000 150 0 0\nr9 1 1500 200 1 1\n")
    files = {"db": str(db), "raw": str(raw), "prot": str(prot),
             "pos": str(pos), "rec": str(rec)}
    for name, extra in (("mers_txt", []), ("mers_bin", ["-b"])):
        out = d / name
        entry(PACKAGES[1], "kmer_count")(
            ["-i", str(db), "-k", "6", "-a", "-o", str(out)] + extra)
        files[name] = str(out)
    return files


def test_extract_seq_parity(seq_files, tmp_path, monkeypatch):
    _rc, out, _err, _f = run_both(
        "extract_seq", ["-i", seq_files["db"], "-A", seq_files["pos"]],
        tmp_path, monkeypatch)
    assert out.count(b"\n") >= 7


@pytest.mark.parametrize("cfg", [["-o", "x.txt"], ["-A", "-"], ["-n"],
                                 ["-E", "36"]],
                         ids=["out", "stdin", "notin", "eos"])
def test_extract_seq_options(seq_files, tmp_path, monkeypatch, cfg):
    argv = ["-i", seq_files["db"]] + cfg
    if "-A" not in cfg:
        argv += ["-A", seq_files["pos"]]
    rc, out, _err, files = run_both(
        "extract_seq", argv, tmp_path, monkeypatch,
        stdin=open(seq_files["pos"]).read())
    assert rc == 0
    if cfg[0] in ("-o", "-A"):
        assert len(files.get("x.txt", out)) > 100


KC_CONFIGS = [
    ["-k", "4", "-a"],
    ["-k", "3"],
    ["-k", "5", "-M", "10"],
    ["-k", "2", "-a", "-n"],
    ["-k", "1", "-a"],
    ["-k", "6", "-a", "-N"],
]


@pytest.mark.parametrize("cfg", KC_CONFIGS, ids=lambda c: " ".join(c))
def test_kmer_count_parity(seq_files, tmp_path, monkeypatch, cfg):
    _rc, out, _err, _f = run_both("kmer_count", ["-i", seq_files["db"]] + cfg,
                                  tmp_path, monkeypatch)
    assert out.count(b"\n") >= 4


@pytest.mark.parametrize("cfg", [["-k", "4", "-a", "-b"],
                                 ["-k", "6", "-a", "-b", "-N"],
                                 ["-k", "3", "-a", "-r"],
                                 ["-k", "5", "-M", "3"]],
                         ids=lambda c: " ".join(c))
def test_kmer_count_output_file(seq_files, tmp_path, monkeypatch, cfg):
    """``-o``: the binary census (``-a -b``, packed u64 + u32 records) and
    text tables, compared as files."""
    _rc, out, _err, files = run_both(
        "kmer_count", ["-i", seq_files["db"], "-o", "kc.out"] + cfg,
        tmp_path, monkeypatch)
    assert out == b""
    if "-b" in cfg:
        assert len(files["kc.out"]) % 12 == 0 and len(files["kc.out"]) >= 12
    else:
        assert files["kc.out"].count(b"\n") >= 4


PR_CONFIGS = [
    ["-l", "20"],
    ["-l", "20", "-n"],
    ["-l", "20", "-N"],
    ["-l", "22", "-A", r"%f|%H|%s|%e|%S|%E|%t|%l\n"],
    ["-l", "40"],
]


@pytest.mark.parametrize("cfg", PR_CONFIGS, ids=lambda c: " ".join(c))
def test_polyrun_parity(seq_files, tmp_path, monkeypatch, cfg):
    _rc, out, _err, _f = run_both("polyrun", ["-i", seq_files["db"]] + cfg,
                                  tmp_path, monkeypatch)
    if cfg != ["-l", "40"]:
        assert out.count(b"\n") >= 1


KA_CONFIGS = [["-k", "6"], ["-k", "6", "-n"], ["-k", "6", "-b"]]


@pytest.mark.parametrize("cfg", KA_CONFIGS, ids=lambda c: " ".join(c))
def test_kmer_annotate_parity(seq_files, tmp_path, monkeypatch, cfg):
    table = seq_files["mers_bin" if "-b" in cfg else "mers_txt"]
    _rc, out, _err, _f = run_both(
        "kmer_annotate", ["-m", table, "-s", seq_files["raw"]] + cfg,
        tmp_path, monkeypatch)
    assert out.count(b"\t") == 4 and len(out) > 10_000


def test_kmer_annotate_output_file(seq_files, tmp_path, monkeypatch):
    _rc, _out, _err, files = run_both(
        "kmer_annotate", ["-m", seq_files["mers_txt"], "-s",
                          seq_files["raw"], "-k", "4", "-o", "ka.txt"],
        tmp_path, monkeypatch)
    assert files["ka.txt"].count(b"\n") == 4


@pytest.mark.parametrize("cfg", [["-M", "600"], ["-m", "300", "-M", "900"]],
                         ids=lambda c: " ".join(c))
def test_aacomp_parity(seq_files, tmp_path, monkeypatch, cfg):
    """The binary mass index (``-o`` and stdout), then aacomplookup over
    it with queries on stdin (``-o`` and stdout); the masses go through
    ``monomolwt`` and the lookup's key-only introsort."""
    argv = ["-i", seq_files["prot"]] + cfg
    _rc, out, _err, _f = run_both("aacomp", argv, tmp_path / "out",
                                  monkeypatch)
    _rc, _o, _e, files = run_both("aacomp", argv + ["-o", "ix.bin"],
                                  tmp_path / "file", monkeypatch)
    assert files["ix.bin"] == out
    n = int(np.frombuffer(out[:8], dtype="<u8")[0])
    assert n > 1000 and len(out) == 8 + 24 * n
    ix = tmp_path / "ix.bin"
    ix.write_bytes(out)
    queries = "250.5\n410.2\n300.0\n520.25\n"
    _rc, hits, _e, _f = run_both("aacomplookup", ["-i", str(ix), "-t", "0.5"],
                                 tmp_path / "look", monkeypatch,
                                 stdin=queries)
    assert hits.count(b"\n") >= 4
    _rc, _o, _e, files = run_both(
        "aacomplookup", ["-i", str(ix), "-t", "0.05", "-o", "hits.txt"],
        tmp_path / "lookfile", monkeypatch, stdin=queries)
    assert "hits.txt" in files


ATAC_CONFIGS = [
    [], ["-H"], ["-m"], ["-e"], ["-O"], ["-r", "-n"], ["-n", "-I"],
    ["-n", "-t", "r", "-I"], ["-r", "-n", "-H"],
]


@pytest.mark.parametrize("cfg", ATAC_CONFIGS,
                         ids=lambda c: " ".join(c) or "d")
def test_atac_parity(seq_files, tmp_path, monkeypatch, cfg):
    _rc, out, _err, _f = run_both(
        "atac_seq", ["-i", seq_files["db"], "-A", seq_files["rec"]] + cfg,
        tmp_path, monkeypatch)
    assert len(out) > 20


def test_atac_output_appends(seq_files, tmp_path, monkeypatch):
    """``-o`` appends (the reference opens it so), here to a seeded file."""
    _rc, _out, _err, files = run_both(
        "atac_seq", ["-i", seq_files["db"], "-A", seq_files["rec"], "-r",
                     "-n", "-o", "atac.fa"], tmp_path, monkeypatch,
        setup=lambda d: (d / "atac.fa").write_text(">old\nACGT\n"))
    assert files["atac.fa"].startswith(b">old\nACGT\n>")


def chario_input(content):
    rng = random.Random(13)
    if content == "acgt":
        return "".join(rng.choice("ACGT") for _ in range(223)) + "$"
    if content == "newlines":
        return "".join(rng.choice("ACGTN") + ("\n" if rng.random() < 0.02
                                              else "")
                       for _ in range(517)) + "$"
    if content == "multi-eos":
        return "ACGTACG$TTTACGTAGCATGC$" * 40
    return "ACGTAGCATTG$"


@pytest.mark.parametrize("clock", [1_700_000_000, 1_700_000_017])
@pytest.mark.parametrize("content", ["acgt", "newlines", "multi-eos", "tiny"])
def test_chario_parity(tmp_path, monkeypatch, content, clock):
    """stdout (the coordinate dump), stderr (timestamps, rates, the
    first / middle / last 50 chars and the seeded random seeks) and exit
    status (134 when a seek hits the reference's getbasepos abort) under
    one pinned clock."""
    path = tmp_path / "in.seq"
    path.write_text(chario_input(content))
    real_localtime = time.localtime
    monkeypatch.setattr(time, "time", lambda: float(clock))
    monkeypatch.setattr(time, "localtime",
                        lambda *a: real_localtime(clock))
    rc, out, err, _f = run_both("chario", ["-i", str(path)], tmp_path,
                                monkeypatch)
    assert rc in (0, 134)
    assert out.count(b"\n") >= 2
    assert b"Last 50 chars" in err


def test_chario_usage(tmp_path, monkeypatch):
    rc, _out, err, _f = run_both("chario", ["-h"], tmp_path, monkeypatch)
    assert rc == 1 and err.startswith(b"Usage: chario")


def glibc_drand48(seed, n):
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.drand48.restype = ctypes.c_double
    libc.srand48(ctypes.c_long(seed))
    return [libc.drand48() for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 7, 42, 12345, 1_700_000_000,
                                  (1 << 32) + 5])
def test_drand48_is_glibc(seed):
    """The port's Drand48 gives glibc's ``srand48`` / ``drand48`` sequence,
    bit for bit (glibc keeps the seed's low 32 bits)."""
    r = Drand48(seed)
    assert [r.next() for _ in range(64)] == glibc_drand48(seed, 64)


@pytest.mark.parametrize("argv", [["-l", "1000", "-s", "42", "-o", "g.sqn"],
                                  ["-l", "3000", "-s", "7"],
                                  ["-l", "0", "-s", "1"]],
                         ids=["file", "stdout", "empty"])
def test_genome_simulation_parity(tmp_path, monkeypatch, argv):
    _rc, out, _err, files = run_both("genome_simulation", argv, tmp_path,
                                     monkeypatch)
    data = files.get("g.sqn", out)
    n = int(argv[1])
    assert len(data) == n + 2 and data[0] == 4 and data[-1] == 4
    assert set(data[1:-1]) <= {0, 1, 2, 3}


def test_genome_simulation_env_seed(tmp_path, monkeypatch):
    monkeypatch.setenv("RAND48_SEED", "99")
    _rc, out, _err, _f = run_both("genome_simulation", ["-l", "500"],
                                  tmp_path, monkeypatch)
    assert len(out) == 502


@pytest.mark.parametrize("cfg", [["-m", "25", "-S", "20", "-R", "-e",
                                  "0 0.1 0 0 0.2", "-s", "7"],
                                 ["-m", "30", "-S", "40", "-s", "3", "-o",
                                  "reads.csfasta"],
                                 ["-m", "20", "-S", "15", "-R", "-r", "4",
                                  "-p", "4", "-e", "0.3 0.3", "-s", "11"]],
                         ids=["rc-errors", "file", "rounds"])
def test_solid_simulation_parity(seq_files, tmp_path, monkeypatch, cfg):
    _rc, out, _err, files = run_both(
        "solid_simulation", ["-i", seq_files["db"]] + cfg, tmp_path,
        monkeypatch)
    lines = files.get("reads.csfasta", out).decode().splitlines()
    m = int(cfg[1])
    assert len(lines) == 2 * int(cfg[3])
    for hdr, csq in zip(lines[::2], lines[1::2]):
        assert len(hdr.split()[1]) == m and len(csq) == m + 1
        assert csq[0] == "G" and set(csq[1:]) <= set("0123")
