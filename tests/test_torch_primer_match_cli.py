"""Byte parity of the port's primer_match CLI with the JAX package's.

Both run in-process on the same synthetic FASTA with ``SAT_HOST_SCAN=0``:
the JAX CLI through its XLA block path, the port through its fused route
(plain PyTorch versions on the CPU).  The ``-k``/``-K`` cases run with
``SAT_HOST_SCAN=0`` (the port's gated seed scan) and ``=1`` (the native
host machine)."""

import pytest
import torch

from sequence_alignment_tools_tpu.apps import primer_match as jax_app
from sequence_alignment_tools_tpu.utils.iupac import reverse_comp
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import primer_match as torch_app
from sequence_alignment_tools_tpu_torch.device import resolve_device
from sequence_alignment_tools_tpu_torch.models import primer_match as model
from tests.conftest import make_synthetic_fasta

PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC"]
FMT = (r"%h\t%H\t%f\t%s\t%e\t%5\t%3\t%S\t%E\t%i\t%d\t%p\t%P\t%q\t%Q\t%t"
       r"\t%T\t%A\t%r\t%R\t%%\n")
WORDS = [[], ["-r"], ["-c"], ["-r", "-c"], ["-r", "-c", "-a"],
         ["-r", "-c", "-M", "2"], ["-r", "-A", FMT]]
FASTA = [["-r"], ["-c"], ["-r", "-c", "-a"], ["-A", FMT]]
# the pigeonhole engines: halves (-k 1, -K 1) and bases (-3 8)
EDITS = [["-k", "1", "-r"], ["-k", "1", "-r", "-c"], ["-K", "1", "-r"],
         ["-k", "1", "-r", "-3", "8"], ["-k", "1", "-r", "-A", FMT]]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pm_torch")
    planted = [(1000 + 2500 * i, p) for i, p in enumerate(PATS)]
    planted += [(15000 + 2500 * i, reverse_comp(p))
                for i, p in enumerate(PATS)]
    planted += [(30000 + 700 * i, PATS[0]) for i in range(3)]
    # one substitution, one deletion, one insertion
    planted += [(36000 + 900 * i, p[:6] + "ACGT"[(2 + i) % 4] + p[7:])
                for i, p in enumerate(PATS)]
    planted += [(40000 + 900 * i, p[:5] + p[6:]) for i, p in enumerate(PATS)]
    planted += [(44000 + 700 * i, reverse_comp(p[:7] + "T" + p[7:]))
                for i, p in enumerate(PATS[:3])]
    fasta = str(d / "db.fasta")
    make_synthetic_fasta(fasta, n_entries=3, total=48_000, planted=planted,
                         seed=21)
    words = d / "pats.txt"
    words.write_text("\n".join(PATS) + "\n")
    fa = d / "pats.fa"
    fa.write_text("".join(f">primer{i} pair {i}\n{p}\n"
                          for i, p in enumerate(PATS)))
    return fasta, str(words), str(fa)


def _both(argv, capsys, monkeypatch, host_scan="0"):
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    monkeypatch.setenv("SAT_MESH", "0")
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    capsys.readouterr()
    assert jax_app.main(argv) == 0
    want = capsys.readouterr().out
    assert torch_app.main(argv) == 0
    got = capsys.readouterr().out
    return want, got


@pytest.mark.parametrize("flags", WORDS, ids=lambda f: " ".join(f) or "plain")
def test_parity_word_patterns(inputs, flags, capsys, monkeypatch):
    fasta, words, _ = inputs
    want, got = _both(["-i", fasta, "-P", words] + flags, capsys, monkeypatch)
    assert want
    assert got == want


@pytest.mark.parametrize("flags", FASTA, ids=lambda f: " ".join(f))
def test_parity_fasta_patterns(inputs, flags, capsys, monkeypatch):
    fasta, _, fa = inputs
    want, got = _both(["-i", fasta, "-F", fa] + flags, capsys, monkeypatch)
    assert want
    assert got == want


@pytest.mark.parametrize("host_scan", ["0", "1"])
@pytest.mark.parametrize("flags", EDITS, ids=lambda f: " ".join(f))
def test_parity_edit_options(inputs, flags, host_scan, capsys, monkeypatch):
    fasta, words, _ = inputs
    want, got = _both(["-i", fasta, "-P", words] + flags, capsys,
                      monkeypatch, host_scan)
    assert want.count("\n") >= 2 * len(PATS)
    assert got == want


# the engines hash (-N 6) and gs (-N 15) and translated search (-T) used to
# exit 1, and now print the JAX CLI's bytes (-T: the primers read as
# peptides against the six-frame translation)
@pytest.mark.parametrize("flags", [["-k", "1", "-N", "6"], ["-T"],
                                   ["-K", "1", "-N", "15", "-r"]])
def test_unported_options_exit(inputs, flags, capsys, monkeypatch):
    fasta, words, _ = inputs
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    want, got = _both(["-i", fasta, "-P", words] + flags, capsys,
                      monkeypatch)
    assert got == want
    assert want or flags == ["-T"]
    assert "not ported" not in capsys.readouterr().err


def test_dispatcher(monkeypatch, capsys):
    """``pairscan -h`` reaches the tool (its usage, exit 1, as the JAX
    dispatcher's); ``--help`` lists the tools and exits 0."""
    from sequence_alignment_tools_tpu import __main__ as jax_main

    errs = []
    for m in (jax_main, torch_main):
        monkeypatch.setattr("sys.argv", ["sat", "pairscan", "-h"])
        with pytest.raises(SystemExit) as exc:
            m.main()
        assert exc.value.code == 1
        errs.append(capsys.readouterr().err)
    assert errs[1] == errs[0]
    assert errs[0].startswith("Usage: pairscan")
    monkeypatch.setattr("sys.argv", ["sat", "--help"])
    assert torch_main.main() == 0
    assert "primer_match" in capsys.readouterr().err


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SAT_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="SAT_DEVICE=cpu"):
        resolve_device()
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    assert resolve_device().type == "cpu"


@pytest.mark.parametrize("node,engine", [(0, "exact_kt"), (4, "exact_sa"),
                                         (1, "suftree")])
def test_model_engines_and_stream(inputs, monkeypatch, node, engine):
    """Each exact engine's hit stream equals the JAX model's, and the
    serving stream repeats it per run."""
    from sequence_alignment_tools_tpu.io.compress import load_db
    from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
    from sequence_alignment_tools_tpu.models.primer_match import (
        PrimerMatchModel as JaxModel,
    )

    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    fasta, _, _ = inputs
    db = load_db(fasta)
    db.has_suffix_tree = engine == "suftree"
    ps = build_pattern_set(PATS, rev_comp=True)
    want = list(JaxModel(db, ps, node=node, mesh=None).engine_hits())
    m = model.PrimerMatchModel(db, ps, node=node, device="cpu")
    assert m.engine == engine
    assert list(m.engine_hits()) == want
    assert len(want) >= 2 * len(PATS)
    assert list(m.engine_hits_stream(3)) == [want] * 3
