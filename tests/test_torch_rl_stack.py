"""The port's RL-stack tools against the JAX package's: Indexer and
IndexerAA (``apps/indexer.py``), Xspace and XspaceLo (``apps/xspace.py``
over ``models/xspace.py``).

Indexer / IndexerAA: the index, forward, reverse-complement and amino
flat files, byte for byte, on a FASTA with lowercase, IUPAC, ``U``,
stop and unknown characters.  Xspace / XspaceLo: the x-space files for
``XS_CONFIGS`` and ``LO_CONFIGS`` of ``tests/test_rl_stack.py`` (with the
reverse-complement stream and multi-block plans) and the amino
configurations, on one synthesized DNA database indexed once.  The
cross-read: the port's Xspace / XspaceLo on the JAX package's Indexer
files and the JAX package's on the port's give the same bytes.
"""

import random

import pytest

from test_torch_seq_tools import PACKAGES, entry, run_both, run_tool


@pytest.fixture(scope="module")
def rl_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rl")
    rng = random.Random(17)
    mixed = d / "mix.fasta"
    s = "".join(rng.choice("ACGTacgtn") for _ in range(300))
    mixed.write_text(
        ">e1 first entry\nACGTacgtNRYu\nGGGTTT\n>e2 second\nTTTTaaaa\n"
        ">e3 third AA\nMKVLpqrst.*xB\n>e4 random\n"
        + "\n".join(s[i:i + 61] for i in range(0, len(s), 61)) + "\n")
    rng = random.Random(77)
    dna = d / "big.fasta"
    with open(dna, "w") as f:
        for e in range(6):
            n = 400 + 100 * e
            s = "".join(rng.choice("ACGTACGTacgtN") for _ in range(n))
            f.write(f">r{e} rand {e}\n")
            for i in range(0, n, 61):
                f.write(s[i:i + 61] + "\n")
    rng = random.Random(5)
    prot = d / "prot.fasta"
    with open(prot, "w") as f:
        for e in range(3):
            s = "".join(rng.choice("ACDEFGHIKLMNPQRSTVWYxz.")
                        for _ in range(250))
            f.write(f">p{e} prot {e}\n{s}\n")
    files = {"mixed": str(mixed), "dna": str(dna), "prot": str(prot)}
    # the DNA and protein databases indexed by each package
    for pkg in PACKAGES:
        b = str(d / f"{pkg}.b")
        assert entry(pkg, "Indexer")(["-i", b + ".idx", "-f", b + ".fwd",
                                      "-r", b + ".rev", str(dna)]) == 0
        p = str(d / f"{pkg}.p")
        assert entry(pkg, "IndexerAA")(["-i", p + ".idx", "-f", p + ".seq",
                                        str(prot)]) == 0
        files[pkg] = (b, p)
    return files


@pytest.mark.parametrize("src", ["mixed", "dna", "prot"])
def test_indexer_parity(rl_files, tmp_path, monkeypatch, src):
    _rc, out, _e, files = run_both(
        "Indexer", ["-i", "x.idx", "-f", "x.fwd", "-r", "x.rev",
                    rl_files[src]], tmp_path, monkeypatch)
    assert out == b"" and sorted(files) == ["x.fwd", "x.idx", "x.rev"]
    assert files["x.fwd"].count(b"$") >= 4


def test_indexer_stdout_and_flags(rl_files, tmp_path, monkeypatch):
    """The index on stdout, the flag glued to its value, and the usage
    exit."""
    _rc, out, _e, files = run_both(
        "Indexer", ["-fx.fwd", rl_files["mixed"]], tmp_path / "glued",
        monkeypatch)
    assert out.count(b">") == 4 and "x.fwd" in files
    rc, _o, err, _f = run_both("Indexer", ["-i", "x.idx"], tmp_path / "usage",
                               monkeypatch)
    assert rc == 1 and err.startswith(b"Indexer:")


@pytest.mark.parametrize("extra", [[], ["-U"]], ids=["amino", "upper"])
@pytest.mark.parametrize("src", ["mixed", "prot"])
def test_indexer_aa_parity(rl_files, tmp_path, monkeypatch, extra, src):
    _rc, _o, _e, files = run_both(
        "IndexerAA", extra + ["-i", "x.idx", "-f", "x.seq", rl_files[src]],
        tmp_path, monkeypatch)
    assert sorted(files) == ["x.idx", "x.seq"]


def test_indexer_files_agree(rl_files):
    """The fixture's databases, indexed once by each package: the same
    bytes, so the cross-reads below read one format."""
    (jb, jp), (tb, tp) = rl_files[PACKAGES[0]], rl_files[PACKAGES[1]]
    for a, b, ext in [(jb, tb, e) for e in (".idx", ".fwd", ".rev")] + \
            [(jp, tp, e) for e in (".idx", ".seq")]:
        want = open(a + ext, "rb").read()
        assert len(want) > 50 and open(b + ext, "rb").read() == want, ext


XS_CONFIGS = [["-m", "6"], ["-m", "6", "-a"], ["-m", "3", "-a"],
              ["-m", "10"], ["-m", "4"]]


@pytest.mark.parametrize("cfg", XS_CONFIGS, ids=lambda c: " ".join(c))
def test_xspace_parity(rl_files, tmp_path, monkeypatch, cfg):
    b = rl_files[PACKAGES[0]][0]
    _rc, _o, _e, files = run_both(
        "Xspace", [*cfg, "-i", b + ".idx", "-f", b + ".fwd", "-o", "x.out"],
        tmp_path, monkeypatch)
    assert files["x.out"].count(b"\n") > 18


LO_CONFIGS = [["-k", "6"], ["-k", "6", "-R"], ["-k", "3", "-R"],
              ["-k", "4", "-M", "1"], ["-k", "4", "-M", "1", "-R"]]


@pytest.mark.parametrize("cfg", LO_CONFIGS, ids=lambda c: " ".join(c))
def test_xspacelo_parity(rl_files, tmp_path, monkeypatch, cfg):
    """Incl. the reverse-complement stream (``-R`` stands for ``-r`` with
    the reverse file) and multi-block plans (``-M 1``)."""
    b = rl_files[PACKAGES[0]][0]
    argv = []
    for c in cfg:
        argv += ["-r", b + ".rev"] if c == "-R" else [c]
    _rc, _o, _e, files = run_both(
        "XspaceLo", argv + ["-i", b + ".idx", "-f", b + ".fwd", "-o",
                            "x.out"], tmp_path, monkeypatch)
    assert files["x.out"].count(b"\n") > 20


@pytest.mark.parametrize("tool,cfg", [("Xspace", ["-m", "3", "-A"]),
                                      ("Xspace", ["-m", "2", "-U"]),
                                      ("XspaceLo", ["-k", "3", "-A"]),
                                      ("XspaceLo", ["-k", "2", "-U", "-p"])],
                         ids=["xs-A", "xs-U", "lo-A", "lo-plan"])
def test_xspace_amino_parity(rl_files, tmp_path, monkeypatch, tool, cfg):
    p = rl_files[PACKAGES[0]][1]
    rc, _o, _e, files = run_both(
        tool, [*cfg, "-i", p + ".idx", "-f", p + ".seq", "-o", "x.out"],
        tmp_path, monkeypatch)
    assert rc == 0 and (files.get("x.out", b"\n").count(b"\n") > 0)


@pytest.mark.parametrize("tool,cfg", [("Xspace", ["-m", "6", "-a"]),
                                      ("Xspace", ["-m", "4"]),
                                      ("XspaceLo", ["-k", "5", "-R"])],
                         ids=["xs-a", "xs", "lo-rev"])
def test_xspace_cross_read(rl_files, tmp_path, monkeypatch, tool, cfg):
    """Each package's Xspace / XspaceLo on the other package's Indexer
    files, against the JAX package on its own."""
    runs = []
    for reader, indexer in ((0, 0), (1, 0), (0, 1)):
        b = rl_files[PACKAGES[indexer]][0]
        argv = []
        for c in cfg:
            argv += ["-r", b + ".rev"] if c == "-R" else [c]
        d = tmp_path / f"{reader}{indexer}"
        d.mkdir()
        runs.append(run_tool(PACKAGES[reader], tool,
                             argv + ["-i", b + ".idx", "-f", b + ".fwd",
                                     "-o", "x.out"], d, monkeypatch))
    assert runs[0][0] == 0 and runs[0][3]["x.out"].count(b"\n") > 20
    assert runs[1] == runs[0]
    assert runs[2] == runs[0]
