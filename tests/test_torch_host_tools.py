"""The port's host tools of the flagship products against the JAX
package's: compress_seq (PrimerMatch and PeptideScan both normalize their
databases with it), protein_mw and peptide_mult (PeptideScan).

compress_seq: every artifact of the port's CLI byte-equal to the JAX
CLI's on the same input (normalized, bit-compressed, reverse-complement
table, ``$`` EOS, a protein database, the uppercase switch), and ``-c``'s
staleness exit status.  protein_mw and peptide_mult: stdout bytes on the
inputs of ``tests/test_seq_tools.py`` and ``tests/test_mass_tools.py``
(``PM_CONFIGS``), raw and normalized.
"""

import io
import os
import random
import re
import shutil

import pytest

from sequence_alignment_tools_tpu.apps import compress_seq as jax_cs
from sequence_alignment_tools_tpu.apps import peptide_mult as jax_pm
from sequence_alignment_tools_tpu.apps import protein_mw as jax_mw
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import compress_seq as torch_cs
from sequence_alignment_tools_tpu_torch.apps import peptide_mult as torch_pm
from sequence_alignment_tools_tpu_torch.apps import protein_mw as torch_mw

MASSES = """G 57.02146
A 71.03711
S 87.03203
P 97.05276
V 99.06841
T 101.04768
C 103.00919
L 113.08406
I 113.08406
N 114.04293
D 115.02694
Q 128.05858
K 128.09496
E 129.04259
M 131.04049
H 137.05891
F 147.06841
R 156.10111
Y 163.06333
W 186.07931
n 1.00794
c 17.00274
"""
PM_CONFIGS = [["-e", "2"], ["-e", "0.1"], ["-e", "0.01", "-r"],
              ["-C", "2"], ["-C", "0"], ["-X"], ["-X", "-e", "5"]]
CS_CONFIGS = [["-n", "true", "-z", "true", "-C", "false"],
              ["-n", "true"],
              ["-n", "true", "-R", "true", "-C", "false"],
              ["-E", "36", "-n", "true"],
              ["-u", "false", "-I", "false", "-C", "false"],
              ["-e", "false", "-S", "false"]]


def dna_fasta(path, seed=3):
    rng = random.Random(seed)
    with open(path, "w") as f:
        for e in range(3):
            f.write(f">s{e} entry {e}\n")
            s = "".join(rng.choice("ACGTacgtN") for _ in range(997))
            for i in range(0, len(s), 61):
                f.write(s[i:i + 61] + "\n")


@pytest.fixture(scope="module")
def prot_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_host_tools")
    rng = random.Random(31)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    entries = ["".join(rng.choice(aas) for _ in range(400))
               for _ in range(3)]
    entries[1] = "M" + entries[1][1:]
    e2 = list(entries[2])
    e2[50], e2[120], e2[200] = "X", "B", "Z"
    entries[2] = "".join(e2)
    raw = d / "prot.fasta"
    with open(raw, "w") as f:
        for i, s in enumerate(entries):
            f.write(f">q{i} prot {i}\n")
            for j in range(0, len(s), 60):
                f.write(s[j:j + 60] + "\n")
    norm = d / "prot_norm.fasta"
    shutil.copyfile(raw, norm)
    assert torch_cs.main(["-i", str(norm), "-n", "true"]) == 0
    massf = d / "mass.txt"
    massf.write_text(MASSES)
    mass = {t.split()[0]: float(t.split()[1]) for t in MASSES.splitlines()}

    def pepmass(p):
        return mass["n"] + sum(mass[c] for c in p) + mass["c"]

    peps = re.findall(r"[^KR]*[KR]|[^KR]+$", entries[0])
    qf = d / "queries.txt"
    with open(qf, "w") as f:
        qs = [(1000 + i, i + 1, round(pepmass(p), 3))
              for i, p in enumerate(peps[:4])]
        f.write("1 " + " ".join(f"{q} {r} {m}" for q, r, m in qs) + "\n")
        f.write("2 2001 1 800.5 2002 2 1200.25\n")
        f.write("3 3001 1 900.0\n")
    idx = d / "idx.txt"
    idx.write_text("1\n3\n2\n7\n1\n")
    return {"raw": str(raw), "norm": str(norm), "mass": str(massf),
            "queries": str(qf), "idx": str(idx)}


@pytest.mark.parametrize("cfg", CS_CONFIGS, ids=lambda c: " ".join(c))
def test_compress_seq_artifacts(tmp_path, cfg):
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        dna_fasta(tmp_path / side / "x.fasta")
    assert jax_cs.main(["-i", str(tmp_path / "jax" / "x.fasta")] + cfg) == 0
    assert torch_cs.main(["-i", str(tmp_path / "torch" / "x.fasta")]
                         + cfg) == 0
    made = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == made
    assert len(made) >= 3
    for name in made:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_compress_seq_protein_and_check(tmp_path, prot_files):
    for side, app in (("jax", jax_cs), ("torch", torch_cs)):
        (tmp_path / side).mkdir()
        shutil.copyfile(prot_files["raw"], tmp_path / side / "p.fasta")
        assert app.main(["-i", str(tmp_path / side / "p.fasta"), "-n",
                         "true", "-C", "false"]) == 0
    made = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == made
    assert {"p.fasta" + ext for ext in (".sqn", ".tbl", ".hdr")} <= set(made)
    for name in made:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    # -c true: up to date -> 0; source touched -> 1; rebuilt -> 0
    src = str(tmp_path / "torch" / "p.fasta")
    assert torch_cs.main(["-i", src, "-n", "true", "-c", "true"]) == 0
    old = os.path.getmtime(src) - 10
    for name in made:
        if name != "p.fasta":
            os.utime(tmp_path / "torch" / name, (old, old))
    assert torch_cs.main(["-i", src, "-n", "true", "-c", "true"]) == 1
    assert torch_main_run(["compress_seq", "-i", src, "-n", "true"]) == 0
    assert torch_cs.main(["-i", src, "-n", "true", "-c", "true"]) == 0


def torch_main_run(argv):
    import sys

    saved = sys.argv
    sys.argv = ["sat"] + argv
    try:
        return torch_main.main()
    finally:
        sys.argv = saved


@pytest.mark.parametrize("db", ["raw", "norm"])
def test_protein_mw_parity(prot_files, db):
    argv = ["-i", prot_files[db], "-I", prot_files["idx"], "-m",
            prot_files["mass"]]
    want, got = io.StringIO(), io.StringIO()
    jax_mw.run(jax_mw.parse_args(argv), want)
    torch_mw.run(torch_mw.parse_args(argv), got)
    assert want.getvalue().count("\n") == 5
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("db", ["raw", "norm"])
@pytest.mark.parametrize("cfg", PM_CONFIGS, ids=lambda c: " ".join(c))
def test_peptide_mult_parity(prot_files, cfg, db):
    argv = ["-i", prot_files[db], "-I", prot_files["queries"], "-m",
            prot_files["mass"]] + cfg
    want, got = io.StringIO(), io.StringIO()
    jax_pm.run(jax_pm.parse_args(argv), want)
    torch_pm.run(torch_pm.parse_args(argv), got)
    assert want.getvalue().count("\n") == 3
    assert got.getvalue() == want.getvalue()


def test_host_tools_dispatcher(prot_files, tmp_path, capsys):
    for tool, app, argv in (
            ("protein_mw", jax_mw, ["-i", prot_files["norm"], "-I",
                                    prot_files["idx"], "-m",
                                    prot_files["mass"]]),
            ("peptide_mult", jax_pm, ["-i", prot_files["norm"], "-I",
                                      prot_files["queries"], "-m",
                                      prot_files["mass"], "-X"])):
        want = io.StringIO()
        app.run(app.parse_args(argv), want)
        capsys.readouterr()
        assert torch_main_run([tool] + argv) == 0
        assert capsys.readouterr().out == want.getvalue()
