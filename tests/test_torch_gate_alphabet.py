"""The pigeonhole (k > 0) engines over alphabets of 30 codes or more.

The extension gate packs one bit per code into int32 accept words, so
``GateTables`` refuses an alphabet of 30 codes or more.  The port's
scanner then offers no gated route (``gated_available`` is False) and the
census branch of ``_seed_candidates`` runs without the device gate: the
halves engine at ``-k 1`` over a 31-code database, device route forced
(``SAT_HOST_SCAN=0``, plain versions on the CPU), must emit exactly the
JAX model's engine hits, through the fused route and through the census
(more than 2,048 seeds), and the CLI must print the JAX app's bytes.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.apps import primer_match as jax_app
from sequence_alignment_tools_tpu.io.database import SeqDB as JaxSeqDB
from sequence_alignment_tools_tpu.io.patterns import (
    build_pattern_set as jax_build_pattern_set,
)
from sequence_alignment_tools_tpu.models.primer_match import (
    PrimerMatchModel as JaxModel,
)
from sequence_alignment_tools_tpu_torch.apps import primer_match as torch_app
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
)
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner

# 30 symbols (amino acids, the other letters, stop, gap, two digits): with
# EOS a 31-code alphabet
LETTERS = b"ACDEFGHIKLMNPQRSTVWYBJOUXZ*-12"


def wide_text(n, count, length, seed):
    """(text, patterns): random symbols with ``count`` patterns cut from
    it, and a copy of every other pattern with one substitution, one
    deletion or one insertion planted elsewhere."""
    rng = np.random.default_rng(seed)
    let = np.frombuffer(LETTERS, np.uint8)
    seq = bytearray(let[rng.integers(0, len(let), size=n)].tobytes())
    pats = []
    for i in range(count):
        at = int(rng.integers(0, n - length))
        pats.append(seq[at : at + length].decode())
    for i, p in enumerate(pats[::2]):
        j = int(rng.integers(3, length - 3))
        sub = chr(LETTERS[(LETTERS.index(p[j].encode()) + 1) % len(LETTERS)])
        v = (p[:j] + sub + p[j + 1 :], p[:j] + p[j + 1 :],
             p[:j] + "W" + p[j:])[i % 3]
        at = int(rng.integers(0, n - len(v)))
        seq[at : at + len(v)] = v.encode()
    return seq.decode(), pats


def entries(text):
    half = len(text) // 2
    return [("w1 first", text[:half].encode()),
            ("w2 second", text[half:].encode())]


@pytest.mark.parametrize("n,count,indels", [(40_000, 14, True),
                                            (40_000, 14, False),
                                            (1 << 18, 1100, True)],
                         ids=["fused", "fused -K 1", "census"])
def test_halves_over_wide_alphabet_match_jax(n, count, indels, monkeypatch):
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    text, pats = wide_text(n, count, 12, seed=count)
    db = SeqDB.from_entries(entries(text))
    assert db.alphabet_size >= 31
    want = list(JaxModel(JaxSeqDB.from_entries(entries(text)),
                         jax_build_pattern_set(pats, rev_comp=False), k=1,
                         indels=indels, mesh=None).engine_hits())
    m = PrimerMatchModel(db, build_pattern_set(pats, rev_comp=False), k=1,
                         indels=indels, device="cpu")
    assert m.engine == "halves"
    calls = []
    monkeypatch.setattr(ConvScanner, "scan_gated",
                        lambda self, *a, **kw: calls.append(1))
    assert list(m.engine_hits()) == want
    assert not calls
    sc = m._halves_ctx()[1]
    assert not sc.gate_alphabet_ok() and not sc.gated_available(n)
    assert sc._census_eligible(n) == (count > 1000)
    # every pattern's own copy, and planted edits (substitutions only
    # without indels)
    assert len(want) > count + count // (3 if indels else 8)


def test_cli_over_wide_alphabet_matches_jax(tmp_path, capsys, monkeypatch):
    text, pats = wide_text(30_000, 10, 12, seed=3)
    fasta = tmp_path / "wide.fasta"
    with open(fasta, "w") as f:
        for head, seq in entries(text):
            f.write(f">{head}\n")
            s = seq.decode()
            for i in range(0, len(s), 60):
                f.write(s[i : i + 60] + "\n")
    words = tmp_path / "pats.txt"
    words.write_text("\n".join(pats) + "\n")
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    monkeypatch.setenv("SAT_MESH", "0")
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    for flags in (["-k", "1"], ["-k", "1", "-c"], ["-K", "1"]):
        argv = ["-i", str(fasta), "-P", str(words)] + flags
        capsys.readouterr()
        assert jax_app.main(argv) == 0
        want = capsys.readouterr().out
        assert torch_app.main(argv) == 0
        assert capsys.readouterr().out == want
        assert want.count("\n") >= 10
