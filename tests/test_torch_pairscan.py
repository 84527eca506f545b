"""The port's mer hash (``ops/merhash.py``) and pairscan against the JAX
package's.

merhash: the template runs, the fold masks and shifts and every window's
value and reverse-complement value, over templates that stay inside the
64-bit register and ones that pass it (truncation and x86-style mask
wrap), on codes with EOS and N values that bleed into neighbouring
slots.  pairscan: the checkpoint file bytes and exit status for the
``CONFIGS`` of ``tests/test_pairscan.py``, resume from a checkpoint, and
``-e``'s exit status 2, on one synthesized normalized database.
"""

import random

import numpy as np
import pytest

from sequence_alignment_tools_tpu.ops import merhash as jax_mh
from sequence_alignment_tools_tpu_torch.apps.compress_seq import main as cs
from sequence_alignment_tools_tpu_torch.ops import merhash as torch_mh
from test_torch_seq_tools import run_both, write_fasta

TEMPLATES = ["1111", "11111111111111", "1" * 16, "11111111000011111111",
             "1" * 40, "11110000001111",
             "1111" + "0" * 20 + "1111", "11111" + "0" * 30 + "11111",
             "1111" + "0" * 58 + "1111", "110011001100111", "1011"]


@pytest.mark.parametrize("tstr", TEMPLATES, ids=lambda t: f"{len(t)}:{t[:8]}")
def test_merhash_parity(tstr):
    rng = np.random.default_rng(len(tstr))
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[rng.integers(0, 3000, 40)] = 4   # EOS
    codes[rng.integers(0, 3000, 20)] = 5   # N
    assert torch_mh.template_params(tstr) == jax_mh.template_params(tstr)
    assert torch_mh.fold_params(tstr) == jax_mh.fold_params(tstr)
    want = jax_mh.hash_values(codes, tstr)
    got = torch_mh.hash_values(codes, tstr)
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    assert len(np.unique(want[0])) > 50
    np.testing.assert_array_equal(torch_mh.rc32(want[0], want[2]),
                                  jax_mh.rc32(want[0], want[2]))


@pytest.fixture(scope="module")
def ps_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ps")
    rng = random.Random(31)
    fa = d / "ps.fasta"
    write_fasta(fa, [(f"p{e} pair {e}",
                      "".join(rng.choice("ACGT") for _ in range(400)))
                     for e in range(3)], width=400)
    assert cs(["-i", str(fa), "-n", "true"]) == 0
    return str(fa)


CONFIGS = [
    ["-m", "4", "-d", "0", "-D", "10"],
    ["-m", "5", "-d", "0", "-D", "6"],
    ["-m", "4", "-d", "3", "-D", "8"],
    # spans past the 64-bit template register: truncation + mask wrap
    ["-m", "4", "-d", "20", "-D", "30"],
    ["-m", "6", "-d", "0", "-D", "3"],
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: " ".join(c))
def test_pairscan_bitmap_parity(ps_db, tmp_path, monkeypatch, cfg):
    rc, out, _err, files = run_both(
        "pairscan", ["-i", ps_db, "-o", "ps.bm"] + cfg, tmp_path, monkeypatch)
    assert rc == 0 and out == b""
    data = files["ps.bm"]
    assert data.startswith(b"BEGIN\n0 0\n") and data.endswith(b"END\n")


def test_pairscan_resume(ps_db, tmp_path, monkeypatch):
    """A run to ``-D 5`` leaves a checkpoint; a run to ``-D 10`` resumes
    from it (span 6 on); a checkpoint cut at span 3 resumes there."""
    _rc, _o, _e, files = run_both(
        "pairscan", ["-i", ps_db, "-o", "ps.bm", "-m", "4", "-d", "0", "-D",
                     "5"], tmp_path / "first", monkeypatch)
    first = files["ps.bm"]

    def seeded(d, data=first):
        (d / "ps.bm").write_bytes(data)

    _rc, _o, _e, files = run_both(
        "pairscan", ["-i", ps_db, "-o", "ps.bm", "-m", "4", "-d", "0", "-D",
                     "10"], tmp_path / "resumed", monkeypatch, setup=seeded)
    assert files["ps.bm"] != first
    cut = first.replace(b"BEGIN\n0 0\n", b"BEGIN\n3 0\n", 1)
    _rc, _o, _e, files = run_both(
        "pairscan", ["-i", ps_db, "-o", "ps.bm", "-m", "4", "-d", "0", "-D",
                     "8"], tmp_path / "cut", monkeypatch,
        setup=lambda d: seeded(d, cut))


@pytest.mark.parametrize("thresh", ["100000", "5"])
def test_pairscan_exit_threshold(ps_db, tmp_path, monkeypatch, thresh):
    """``-e``: exit status 2 (and the final checkpoint) once fewer than the
    threshold bits of ``again`` remain unset; 0 when the scan ends first."""
    rc, _o, _e, files = run_both(
        "pairscan", ["-i", ps_db, "-o", "ps.bm", "-m", "4", "-d", "0", "-D",
                     "10", "-e", thresh], tmp_path, monkeypatch)
    assert rc == (2 if thresh == "100000" else 0)
    assert files["ps.bm"].endswith(b"END\n")


def test_pairscan_usage(tmp_path, monkeypatch):
    rc, _o, err, _f = run_both("pairscan", ["-m", "4"], tmp_path, monkeypatch)
    assert rc == 1 and err.startswith(b"Usage: pairscan")
