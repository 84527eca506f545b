"""The port's pcr_match against the JAX package's.

Both CLIs run in-process on the synthetic FASTA, pair, STS and FASTA
primer files of ``tests/test_pcr_match.py`` (planted amplicons: exact,
one substitution, reverse strand, past ``-M``, overlapping primers, a
second entry) and must print the same bytes, with the port's inner scans
on its device route (``SAT_HOST_SCAN=0``, plain PyTorch versions on the
CPU) and on the host rung.  The pair model's ``pairs`` and
``pairs_stream`` are held against the JAX model's pairs.
"""

import io

import pytest

from sequence_alignment_tools_tpu.apps import pcr_match as jax_app
from sequence_alignment_tools_tpu.io.compress import load_db as jax_load_db
from sequence_alignment_tools_tpu.models.pcr_match import (
    PcrMatchModel as JaxPcrModel,
)
from sequence_alignment_tools_tpu.utils.format import (
    pcr_alignformat as jax_format,
)
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import pcr_match as torch_app
from sequence_alignment_tools_tpu_torch.io.compress import load_db
from sequence_alignment_tools_tpu_torch.models.pcr_match import PcrMatchModel
from sequence_alignment_tools_tpu_torch.utils.format import pcr_alignformat
from tests.test_pcr_match import (  # noqa: F401 (fixtures)
    CONFIGS,
    PAIRS,
    STS_CONFIGS,
    pair_file,
    pcr_fasta,
    sts_file,
)

FULL = (r"%i|%>s|%>e|%<s|%<e|%>S|%>E|%<S|%<E|%l|%>l|%<l|%>d|%<d|%>r|%<r|%r"
        r"|%R|%>p|%<p|%>q|%<q|%N|%h|%H|%f|%%\n%@\n%*\n")


def outputs(argv, monkeypatch, host_scan):
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    monkeypatch.setenv("SAT_MESH", "0")
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    want, got = io.StringIO(), io.StringIO()
    jax_app.run(jax_app.parse_args(list(argv)), want)
    torch_app.run(torch_app.parse_args(list(argv)), got)
    return want.getvalue(), got.getvalue()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: " ".join(c) or "plain")
def test_pair_parity(pcr_fasta, pair_file, cfg, monkeypatch):  # noqa: F811
    want, got = outputs(["-i", pcr_fasta, "-P", pair_file] + cfg,
                        monkeypatch, "0")
    assert want.count("\n") >= 3
    assert got == want


@pytest.mark.parametrize("cfg", [["-r"], ["-r", "-k", "1"],
                                 ["-r", "-K", "1", "-a"]],
                         ids=lambda c: " ".join(c))
def test_pair_parity_host_rung(pcr_fasta, pair_file, cfg,  # noqa: F811
                               monkeypatch):
    want, got = outputs(["-i", pcr_fasta, "-P", pair_file] + cfg,
                        monkeypatch, "1")
    assert want and got == want


@pytest.mark.parametrize("cfg", STS_CONFIGS + [["-D", "1", "-d", "30"],
                                               ["-k", "1", "-d", "10"]],
                         ids=lambda c: " ".join(c) or "sts")
def test_sts_parity(pcr_fasta, sts_file, cfg, monkeypatch):  # noqa: F811
    want, got = outputs(["-i", pcr_fasta, "-S", sts_file] + cfg, monkeypatch,
                        "0")
    assert want and got == want


def test_fasta_pairs_parity(pcr_fasta, tmp_path, monkeypatch):  # noqa: F811
    patf = tmp_path / "pairs.fasta"
    with open(patf, "w") as f:
        for i, (a, b) in enumerate(PAIRS):
            f.write(f">fwd{i} forward primer {i}\n{a}\n")
            f.write(f">rev{i} reverse primer {i}\n{b}\n")
    want, got = outputs(["-i", pcr_fasta, "-F", str(patf), "-r", "-A",
                         r"%i %>P %<P %>s %<e\n"], monkeypatch, "0")
    assert want and got == want


def test_inline_pairs_and_output_file(pcr_fasta, tmp_path,  # noqa: F811
                                      monkeypatch, capsys):
    """``-p`` inline pairs; ``-o`` appends; an odd primer count exits 1."""
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    pair = " ".join(PAIRS[0])
    want, got = outputs(["-i", pcr_fasta, "-p", pair, "-r"], monkeypatch, "0")
    assert want and got == want
    out = tmp_path / "out.txt"
    out.write_text("kept\n")
    assert torch_app.main(["-i", pcr_fasta, "-p", pair, "-r", "-o",
                           str(out)]) == 0
    assert out.read_text() == "kept\n" + want
    with pytest.raises(SystemExit) as e:
        torch_app.main(["-i", pcr_fasta, "-p", PAIRS[0][0], "-r"])
    assert e.value.code == 1
    assert "Odd number of primers!" in capsys.readouterr().err


def models(pcr_fasta, k, **kw):  # noqa: F811
    pats = [p for pair in PAIRS for p in pair]
    opts = {"ucdict": False, "rev_comp": True, "fplen": 0, "tplen": 0,
            "stlen": 0, "edlen": 0}
    m = PcrMatchModel(
        load_db(pcr_fasta),
        torch_app.build_pair_pattern_set(pats, opts, [], []), k=k,
        rev_comp=True, device="cpu", **kw)
    j = JaxPcrModel(
        jax_load_db(pcr_fasta),
        jax_app.build_pair_pattern_set(pats, opts, [], []), k=k,
        rev_comp=True, **kw)
    return m, j


@pytest.mark.parametrize("use_host", [False, None], ids=["device", "host"])
@pytest.mark.parametrize("k,kw", [(0, {}), (1, {}), (1, {"indels": False}),
                                  (0, {"allorient": True, "maxdist": 500})],
                         ids=["k0", "k1", "K1", "allorient"])
def test_pairs_and_stream_match_jax(pcr_fasta, k, kw, use_host):  # noqa: F811
    m, j = models(pcr_fasta, k, **kw)
    m.inner.use_host = use_host
    want = [jax_format(FULL, h) for h in j.pairs()]
    assert len(want) >= 3
    assert [pcr_alignformat(FULL, h) for h in m.pairs()] == want
    runs = list(m.pairs_stream(2))
    assert [[pcr_alignformat(FULL, h) for h in run] for run in runs] \
        == [want, want]
    m.inner.close()


def test_dispatcher_runs_pcr_match(pcr_fasta, pair_file,  # noqa: F811
                                   monkeypatch, capsys):
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    want, _got = outputs(["-i", pcr_fasta, "-P", pair_file, "-r"],
                         monkeypatch, "1")
    monkeypatch.setattr("sys.argv", ["sat", "pcr_match", "-i", pcr_fasta,
                                     "-P", pair_file, "-r"])
    capsys.readouterr()
    assert torch_main.main() == 0
    assert capsys.readouterr().out == want
    monkeypatch.setattr("sys.argv", ["sat", "pcr_match", "-h"])
    with pytest.raises(SystemExit) as e:
        torch_main.main()
    assert e.value.code == 1
    assert "Usage: pcr_match" in capsys.readouterr().err
