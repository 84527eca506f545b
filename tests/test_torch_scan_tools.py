"""The port's exact_match, inexact_match and tandem_match against the JAX
package's.

Each CLI runs in-process on a synthesized, normalized database (the
primers of ``tests/test_small_tools.py`` planted exact, reverse
complemented and with one substitution, and planted next to EOS: at the
end of the first entry, right after its EOS with the first base deleted,
at the start of the first entry with a substitution) and must print the
bytes the JAX app prints, with the port's scans on the host rung
(``SAT_HOST_SCAN=1``) and on the plain device route (``SAT_HOST_SCAN=0``;
inexact_match's Sellers scan takes its plain version in both).  The JAX
output is computed once per configuration.  inexact_match prints raw
candidates with no clustering, so the EOS plants show every edge case of
the row DP at an entry boundary.
"""

import contextlib
import io
import random

import pytest

from sequence_alignment_tools_tpu.apps import exact_match as jax_em
from sequence_alignment_tools_tpu.apps import inexact_match as jax_im
from sequence_alignment_tools_tpu.apps import tandem_match as jax_tm
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import exact_match as torch_em
from sequence_alignment_tools_tpu_torch.apps import inexact_match as torch_im
from sequence_alignment_tools_tpu_torch.apps import tandem_match as torch_tm
from sequence_alignment_tools_tpu_torch.apps.compress_seq import main as cs
from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

PATS = ["CATCCTGCATCA", "TGGTAGGAGTTG", "AACCGGTTAACC"]
EM_CONFIGS = [["-q"], [], ["-r", "-q"], ["-r"], ["-b", "-q"], ["-k"]]
IM_CONFIGS = [["-k", "0", "-q"], ["-k", "1", "-q"], ["-k", "1"],
              ["-k", "2", "-q"], ["-r", "-k", "1", "-q"], ["-k", "1", "-r"]]
TANDEM_CONFIGS = [["-p", "CAG TTAG", "-c", "3", "-l", "9"],
                  ["-p", "ATG", "-r", "-c", "4"],
                  ["-p", "CAG", "-c", "3", "-l", "31"]]
APPS = {"exact_match": (jax_em, torch_em),
        "inexact_match": (jax_im, torch_im),
        "tandem_match": (jax_tm, torch_tm)}
_JAX_OUT: dict = {}


def substitute(s, i):
    return s[:i] + "ACGT"[("ACGT".index(s[i]) + 1) % 4] + s[i + 1:]


def write_fasta(path, entries, width=60):
    with open(path, "w") as f:
        for h, s in entries:
            f.write(f">{h}\n")
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + "\n")


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan_tools")
    rng = random.Random(7)
    seq = [rng.choice("ACGT") for _ in range(20000)]
    pos = 500
    for p in PATS:
        for v in (p, reverse_comp(p), substitute(p, 4)):
            seq[pos:pos + len(v)] = list(v)
            pos += len(v) + 211
    s = "".join(seq)
    e1, e2 = s[:12000], s[12000:]
    # next to EOS: exact at the end of e1, the first base deleted right
    # after e2's EOS, a substitution at the start of e1
    e1 = substitute(PATS[2], 0) + e1[12:-12] + PATS[0]
    e2 = PATS[1][1:] + e2[11:]
    fasta = str(d / "scan.fasta")
    write_fasta(fasta, [("e1 first", e1), ("e2 second", e2)])
    assert cs(["-i", fasta, "-n", "true"]) == 0
    patf = d / "pats.txt"
    patf.write_text(" ".join(PATS) + "\n")
    # primers longer than 31 bases, one planted with two edits
    long_pats = ["".join(rng.choice("ACGT") for _ in range(n))
                 for n in (33, 38)]
    lseq = [rng.choice("ACGT") for _ in range(6000)]
    lseq[1000:1033] = list(long_pats[0])
    v = substitute(long_pats[1], 9)
    v = v[:20] + v[21:]
    lseq[3000:3000 + len(v)] = list(v)
    lfasta = str(d / "long.fasta")
    write_fasta(lfasta, [("l1 long primers", "".join(lseq))])
    assert cs(["-i", lfasta, "-n", "true"]) == 0
    lpatf = d / "long.txt"
    lpatf.write_text("\n".join(long_pats) + "\n")
    tseq = [rng.choice("ACGT") for _ in range(5000)]
    tseq[500:530] = list("CAG" * 10)
    tseq[1000:1012] = list("TTAG" * 3)
    tseq[2000:2015] = list("CAT" * 5)
    tfasta = str(d / "tandem.fasta")
    write_fasta(tfasta, [("t1 tandem entry", "".join(tseq))], width=70)
    assert cs(["-i", tfasta, "-n", "true"]) == 0
    return {"db": fasta, "pats": str(patf), "long_db": lfasta,
            "long_pats": str(lpatf), "tandem_db": tfasta}


def parity(tool, argv, monkeypatch, host_scan):
    """(JAX output, port output) of ``tool`` on ``argv``."""
    jax_app, torch_app = APPS[tool]
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_MESH", "0")
    key = (tool,) + tuple(argv)
    if key not in _JAX_OUT:
        monkeypatch.setenv("SAT_HOST_SCAN", "1")
        want = io.StringIO()
        jax_app.run(jax_app.parse_args(list(argv)), want)
        _JAX_OUT[key] = want.getvalue()
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    got = io.StringIO()
    torch_app.run(torch_app.parse_args(list(argv)), got)
    return _JAX_OUT[key], got.getvalue()


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", EM_CONFIGS, ids=lambda c: " ".join(c) or "d")
def test_exact_match_parity(scan_files, cfg, host_scan, monkeypatch):
    want, got = parity("exact_match",
                       ["-i", scan_files["db"], "-P", scan_files["pats"]]
                       + cfg, monkeypatch, host_scan)
    assert want.count("\n") >= 3
    assert got == want


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", IM_CONFIGS, ids=lambda c: " ".join(c))
def test_inexact_match_parity(scan_files, cfg, host_scan, monkeypatch):
    want, got = parity("inexact_match",
                       ["-i", scan_files["db"], "-P", scan_files["pats"]]
                       + cfg, monkeypatch, host_scan)
    assert want.count("\n") >= 4
    assert got == want


def test_inexact_match_eos_plants(scan_files, monkeypatch):
    """The candidates next to EOS are in the output: the exact plant ending
    at the first entry's EOS, and the 1-edit plants on either side."""
    want, got = parity("inexact_match",
                       ["-i", scan_files["db"], "-P", scan_files["pats"],
                        "-k", "1", "-q"], monkeypatch, "0")
    assert got == want
    ends = {int(line.split()[2]) for line in got.splitlines()
            if line.split()[1] == PATS[0]}
    assert 1 + 12000 in ends  # the leading EOS, then e1's 12,000 bases
    pids = {line.split()[1] for line in got.splitlines()}
    assert {PATS[1], PATS[2]} <= pids


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", [["-k", "2", "-q"], ["-k", "2"],
                                 ["-k", "0", "-q"]],
                         ids=lambda c: " ".join(c))
def test_inexact_match_long_primers(scan_files, cfg, host_scan,
                                    monkeypatch):
    """Primers past 31 bases (Sellers' columns past one 32-bit field)."""
    want, got = parity("inexact_match",
                       ["-i", scan_files["long_db"], "-P",
                        scan_files["long_pats"]] + cfg, monkeypatch,
                       host_scan)
    # k = 0 finds the exact plant; k = 2 the 2-edit plant too (twice: -P
    # appends the last primer again)
    assert want.count("\n") >= (1 if cfg[1] == "0" else 3)
    assert got == want


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("cfg", TANDEM_CONFIGS, ids=lambda c: " ".join(c))
def test_tandem_match_parity(scan_files, cfg, host_scan, monkeypatch):
    want, got = parity("tandem_match", ["-i", scan_files["tandem_db"]] + cfg,
                       monkeypatch, host_scan)
    if cfg[-1] != "31":
        assert want.count(">t1") >= 1
    assert got == want


def test_dispatcher(scan_files, monkeypatch, capsys):
    """The port's dispatcher runs each tool, has the JAX dispatcher's 37
    names and entry functions, and answers an unknown name as the JAX
    dispatcher does (usage on stderr, exit 1)."""
    from sequence_alignment_tools_tpu import __main__ as jax_main

    for tool, argv in (
            ("exact_match", ["-i", scan_files["db"], "-P",
                             scan_files["pats"], "-r"]),
            ("inexact_match", ["-i", scan_files["db"], "-P",
                               scan_files["pats"], "-k", "1", "-q"]),
            ("tandem_match", ["-i", scan_files["tandem_db"]]
             + TANDEM_CONFIGS[0])):
        want, _got = parity(tool, argv, monkeypatch, "0")
        monkeypatch.setattr("sys.argv", ["sat", tool] + argv)
        capsys.readouterr()
        assert torch_main.main() == 0
        assert capsys.readouterr().out == want
    assert torch_main._TOOLS == jax_main._TOOLS
    for argv in (["sat"], ["sat", "no_such_tool", "-h"]):
        usage = []
        for m in (jax_main, torch_main):
            monkeypatch.setattr("sys.argv", argv)
            with contextlib.redirect_stderr(io.StringIO()) as err:
                assert m.main() == 1
            usage.append(err.getvalue())
        assert usage[1] == usage[0].replace(
            "sequence_alignment_tools_tpu ",
            "sequence_alignment_tools_tpu_torch ")
        names = usage[1].split("Tools:")[1].split()
        assert len(names) == 37 and names == sorted(jax_main._TOOLS)
