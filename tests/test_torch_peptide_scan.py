"""Byte parity of the port's peptide_scan and ``primer_match -T`` with the
JAX package's.

Both run in-process on the same synthesized inputs (``make_synthetic_fasta``,
normalized by the port's ``compress_seq``, whose artifacts
``tests/test_torch_host_tools.py`` holds against the JAX package's): a
protein database with planted peptides and substituted copies, and a DNA
database with the peptides' codons planted on both strands.  The JAX apps run on their host
route; the port's run on the native host machine (``SAT_HOST_SCAN=1``) and
through its device route's plain PyTorch versions (``SAT_HOST_SCAN=0``).
One case of each tool goes through the port's dispatcher.  One case
maps 2,100 peptides, past the register's 14 residues, over a database of
more than 2^18 residues: the port's device route takes the census keyed
by prefixes.
"""

import os
import sys

import numpy as np
import pytest

from sequence_alignment_tools_tpu.apps import peptide_scan as jax_pep
from sequence_alignment_tools_tpu.apps import primer_match as jax_pm
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import peptide_scan as torch_pep
from sequence_alignment_tools_tpu_torch.apps import primer_match as torch_pm
from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
    main as compress,
)
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from tests.conftest import make_synthetic_fasta

AAS = "ACDEFGHIKLMNPQRSTVWY"
PEPS = ["MKTAYIAKQR", "LLDFGAKHE", "WWSPNNVTK", "GGIEDELK"]
_BASES = "TCAG"
_AA = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
CODON = {}
for _i, _c in enumerate(_AA):
    CODON.setdefault(_c, _BASES[_i // 16] + _BASES[_i // 4 % 4]
                     + _BASES[_i % 4])
RC = {"A": "T", "C": "G", "G": "C", "T": "A"}
FMT = r"%i %s %e %S %E %d %r%R %F %n %q %t %f\n"


def enc(p):
    return "".join(CODON[c] for c in p)


def rc(s):
    return "".join(RC[c] for c in reversed(s))


def sub(p, i):
    return p[:i] + ("A" if p[i] != "A" else "G") + p[i + 1 :]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pep_torch")
    prot = str(d / "prot.fasta")
    planted = [(100 + 700 * i, p) for i, p in enumerate(PEPS)]
    planted += [(3_500 + 700 * i, sub(p, 4)) for i, p in enumerate(PEPS)]
    planted += [(6_200, PEPS[0][:5] + "IKQL")]  # an I/L, K/Q variant
    make_synthetic_fasta(prot, n_entries=3, total=7_000, planted=planted,
                         seed=31, alphabet=AAS)
    dna = str(d / "dna.fasta")
    planted = [(300, enc(PEPS[0])), (1_501, enc(PEPS[1])),
               (2_702, enc(sub(PEPS[2], 3))),
               (4_000, rc(enc(PEPS[3]))), (5_201, rc(enc(PEPS[0]))),
               (6_302, rc(enc(sub(PEPS[1], 2))))]
    make_synthetic_fasta(dna, n_entries=2, total=8_000, planted=planted,
                         seed=32)
    for path in (prot, dna):
        assert compress(["-i", path, "-n", "true"]) == 0
    peps = str(d / "peps.txt")
    with open(peps, "w") as f:
        f.write("\n".join(PEPS) + "\n")
    return prot, dna, peps


def _both(jax_app, torch_app, argv, capsys, monkeypatch, host_scan):
    monkeypatch.setenv("SAT_MESH", "0")
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_HOST_SCAN", "1")
    capsys.readouterr()
    assert jax_app.main(argv) == 0
    want = capsys.readouterr().out
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    assert torch_app.main(argv) == 0
    return want, capsys.readouterr().out


# -M 2 / -M 3 with -K 1: the amino-acid maps keep the pigeonhole engines
# off the gate, whose accept tables compare characters
PROT = [[], ["-K", "1"], ["-K", "2"], ["-C", "4"], ["-M", "2", "-K", "1"],
        ["-M", "3", "-K", "1"]]
DNA = [["-T", "A"], ["-T", "F"], ["-T", "A", "-K", "1"],
       ["-T", "A", "-C", "3", "-M", "2"], ["-T", "A", "-M", "3", "-K", "1"],
       ["-T", "F", "-K", "1"]]


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("flags", PROT, ids=lambda f: " ".join(f) or "plain")
def test_peptide_scan_protein_parity(inputs, flags, host_scan, capsys,
                                     monkeypatch):
    prot, _dna, peps = inputs
    want, got = _both(jax_pep, torch_pep, ["-i", prot, "-P", peps] + flags,
                      capsys, monkeypatch, host_scan)
    assert want.count("\n") >= len(PEPS)
    assert got == want


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("flags", DNA, ids=lambda f: " ".join(f))
def test_peptide_scan_translated_parity(inputs, flags, host_scan, capsys,
                                        monkeypatch):
    _prot, dna, peps = inputs
    want, got = _both(jax_pep, torch_pep, ["-i", dna, "-P", peps] + flags,
                      capsys, monkeypatch, host_scan)
    assert want.count("\n") >= 2
    assert got == want


TRANSLATE = [["-T", "-c"], ["-T", "-c", "-a"], ["-T"], ["-T", "-A", FMT],
             ["-T", "-k", "1", "-c"], ["-T", "-K", "1"], ["-T", "-r", "-c"]]


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("flags", TRANSLATE, ids=lambda f: " ".join(f))
def test_primer_match_translate_parity(inputs, flags, host_scan, capsys,
                                       monkeypatch):
    _prot, dna, peps = inputs
    want, got = _both(jax_pm, torch_pm, ["-i", dna, "-P", peps] + flags,
                      capsys, monkeypatch, host_scan)
    assert want
    assert got == want


@pytest.mark.parametrize("tool,flags", [("peptide_scan", ["-T", "A"]),
                                        ("primer_match", ["-T", "-r"])])
def test_dispatcher_runs_translated_tools(inputs, tool, flags, capsys,
                                          monkeypatch):
    _prot, dna, peps = inputs
    argv = ["-i", dna, "-P", peps] + flags
    jax_app = jax_pep if tool == "peptide_scan" else jax_pm
    want, _ = _both(jax_app, jax_app, argv, capsys, monkeypatch, "1")
    assert tool in torch_main._TOOLS
    monkeypatch.setattr(sys, "argv", ["sat", tool] + argv)
    assert torch_main.main() == 0
    assert capsys.readouterr().out == want
    assert os.environ["SAT_DEVICE"] == "cpu"


def test_peptide_scan_prefix_census(tmp_path, capsys, monkeypatch):
    """2,100 peptides of 7 to 20 residues, I = L (``-M 2``), over 2^18 +
    6,000 residues: with ``SAT_HOST_SCAN=0`` the port takes the census
    keyed by 14-residue prefixes, and its stdout equals the JAX
    package's."""
    prot = str(tmp_path / "prot.fasta")
    total = (1 << 18) + 6_000
    seq = make_synthetic_fasta(prot, n_entries=4, total=total, seed=53,
                               alphabet=AAS)
    assert compress(["-i", prot, "-n", "true"]) == 0
    rng = np.random.default_rng(53)
    peps = set()
    while len(peps) < 2_100:
        at = int(rng.integers(0, total - 20))
        peps.add(seq[at : at + int(rng.integers(7, 21))])
    peps_path = str(tmp_path / "peps.txt")
    with open(peps_path, "w") as f:
        f.write("\n".join(sorted(peps)) + "\n")
    seen = []
    monkeypatch.setattr(ConvScanner, "_route",
                        lambda self, msg: seen.append(msg))
    want, got = _both(jax_pep, torch_pep,
                      ["-i", prot, "-P", peps_path, "-M", "2"], capsys,
                      monkeypatch, "0")
    assert seen == ["census kernel (2100 patterns, prefix-keyed at 14; "
                    "plain PyTorch, CPU)"]
    assert want.count("\n") >= 2_000
    assert got == want
