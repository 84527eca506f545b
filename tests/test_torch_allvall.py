"""The port's allvall family against the JAX package's.

A 2,120-base query (2,101 mers: two chunks, the first of 2,048 mers,
4,096 patterns under ``-r``) against a small background that holds an
exact copy of a first-chunk mer run, a one-substitution copy of a
second-chunk run and the reverse complement of a third: the bitmap bytes
of the port (host rung and plain device route) equal the JAX app's at
k = 0 and ``-K 1`` with ``-r`` here, ``-k 1`` (and ``-X``, ``-P``, ``-C``)
in ``tests/test_torch_allvall_kedit.py`` (the JAX side takes 6 to 18 s a
run on the CPU).  Then, on the port alone, the chunk and
merge invariance and the binary round trip of ``tests/test_allvall.py``,
and ``allvall_merge``, ``allvall_dump`` and ``allvall_tobm`` against the
JAX package's on the same bitmaps.
"""

import contextlib
import io
import os
import random

import numpy as np
import pytest

from sequence_alignment_tools_tpu.apps import allvall as jax_av
from sequence_alignment_tools_tpu_torch import __main__ as torch_main
from sequence_alignment_tools_tpu_torch.apps import allvall as torch_av
from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

_JAX_OUT: dict = {}


def write_fasta(path, name, s):
    with open(path, "w") as f:
        f.write(f">x {name}\n")
        for i in range(0, len(s), 60):
            f.write(s[i:i + 60] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def av_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_allvall")
    rng = random.Random(77)
    q = "".join(rng.choice("ACGT") for _ in range(2120))
    bg = [rng.choice("ACGT") for _ in range(600)]
    sub = list(q[2060:2100])
    sub[20] = "ACGT"[("ACGT".index(sub[20]) + 1) % 4]
    for at, v in ((30, q[100:140]), (200, "".join(sub)),
                  (400, reverse_comp(q[1000:1040]))):
        bg[at:at + len(v)] = list(v)
    # the small pair of tests/test_allvall.py for the invariance tests
    sq = "".join(rng.choice("ACGT") for _ in range(1200))
    b1 = "".join(rng.choice("ACGT") for _ in range(900))
    b2 = list(rng.choice("ACGT") for _ in range(900))
    b1 = b1[:300] + sq[100:140] + b1[340:]
    d2 = list(sq[600:640])
    d2[20] = "ACGT"[("ACGT".index(d2[20]) + 1) % 4]
    b2[500:540] = d2
    a = write_fasta(d / "bgA.fasta", "bgA", b1)
    b = write_fasta(d / "bgB.fasta", "bgB", "".join(b2))
    full = d / "bgF.fasta"
    full.write_text(open(a).read() + open(b).read())
    return {"q": write_fasta(d / "q.fasta", "query", q),
            "bg": write_fasta(d / "bg.fasta", "background", "".join(bg)),
            "sq": write_fasta(d / "sq.fasta", "small", sq),
            "a": a, "b": b, "full": str(full), "dir": str(d)}


def run_allvall(app, argv, out):
    if os.path.exists(out):
        os.unlink(out)  # allvall resumes from an existing output
    assert app.allvall_main(argv + ["-o", out, "-A"]) == 0
    return open(out, "rb").read()


def parity(av_files, flags, monkeypatch, host_scan, query="q", bg="bg"):
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_MESH", "0")
    argv = ["-i", av_files[query], "-b", av_files[bg], "-m", "20"] + flags
    key = tuple(argv)
    d = av_files["dir"]
    if key not in _JAX_OUT:
        monkeypatch.setenv("SAT_HOST_SCAN", "1")
        _JAX_OUT[key] = run_allvall(jax_av, argv, os.path.join(d, "j.bm"))
    monkeypatch.setenv("SAT_HOST_SCAN", host_scan)
    return _JAX_OUT[key], run_allvall(torch_av, argv, os.path.join(d, "t.bm"))


@pytest.mark.parametrize("host_scan", ["1", "0"])
@pytest.mark.parametrize("flags", [["-r"], ["-r", "-K", "1"]],
                         ids=["k0", "K1"])
def test_allvall_parity_two_chunks(av_files, flags, host_scan, monkeypatch):
    want, got = parity(av_files, flags, monkeypatch, host_scan)
    assert got == want
    bits, _s, pos = torch_av.read_bitmap(os.path.join(av_files["dir"],
                                                      "t.bm"))
    assert pos == 601 + 1  # the background's codes: EOS, 600 bases, EOS
    # the mers of the exact copy (first chunk) and of the reverse
    # complement end at these positions (one leading EOS)
    assert bits[121:142].all() and bits[1021:1042].all()
    # the one-substitution copy in the second chunk: only under -K 1
    assert bits[2081:2102].all() == ("-K" in flags)
    assert not bits[300:420].any()


def test_chunk_merge_invariance(av_files, monkeypatch):
    """The OR of the per-part bitmaps equals the run over the whole
    background (the reference's multi-process decomposition)."""
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    d = av_files["dir"]
    outs = []
    for name in ("full", "a", "b"):
        out = os.path.join(d, f"m_{name}.bm")
        run_allvall(torch_av, ["-i", av_files["sq"], "-b", av_files[name],
                               "-m", "20", "-K", "1"], out)
        outs.append(out)
    merged = os.path.join(d, "m_merged.bm")
    with contextlib.redirect_stderr(io.StringIO()):
        assert torch_av.merge_main(["-i", outs[1], "-i", outs[2], "-o",
                                    merged, "-A"]) == 0
    f, _, _ = torch_av.read_bitmap(outs[0])
    g, _, _ = torch_av.read_bitmap(merged)
    assert (f == g).all()
    assert f.sum() > 20
    assert f[121:142].all() and f[621:642].all()
    assert not f[300:420].any()


def test_merge_dump_tobm_against_jax(av_files, tmp_path, capsys):
    """allvall_merge, allvall_dump and allvall_tobm print and write the
    JAX package's bytes on the same bitmaps (ascii and binary)."""
    rng = np.random.default_rng(9)
    n = 1201 + 1
    x = rng.random(n) < 0.05
    y = rng.random(n) < 0.05
    y[:25] = True
    px, py = str(tmp_path / "x.bm"), str(tmp_path / "y.bm")
    with open(px, "wb") as f:
        torch_av.write_bitmap(f, x, ascii_out=True)
    with open(py, "wb") as f:
        torch_av.write_bitmap(f, y, ascii_out=False, span=3, pos=77)
    with open(tmp_path / "y_jax.bm", "wb") as f:
        jax_av.write_bitmap(f, y, ascii_out=False, span=3, pos=77)
    assert open(py, "rb").read() == (tmp_path / "y_jax.bm").read_bytes()
    for ascii_flag in ([], ["-A"]):
        outs = []
        for app, tag in ((jax_av, "j"), (torch_av, "t")):
            out = str(tmp_path / f"z_{tag}.bm")
            assert app.merge_main(["-i", py, "-o", out] + ascii_flag
                                  + [px]) == 0
            outs.append(open(out, "rb").read())
            assert app.tobm_main(["-i", py, "-o", out + ".tobm"]
                                 + ascii_flag) == 0
            outs.append(open(out + ".tobm", "rb").read())
        assert outs[:2] == outs[2:]
        err = capsys.readouterr().err
        assert err.count("Final unset") == 2
    for app in (jax_av, torch_av):
        assert app.dump_main(["-i", av_files["sq"], "-d", px,
                              "-m", "20"]) == 0
    dumps = capsys.readouterr().out
    half = len(dumps) // 2
    assert dumps[:half] == dumps[half:] and dumps.startswith(">")


def test_binary_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    bits = rng.random(5000) < 0.1
    pb = tmp_path / "x.bm"
    with open(pb, "wb") as f:
        torch_av.write_bitmap(f, bits, ascii_out=False, span=3, pos=77)
    got, span, pos = torch_av.read_bitmap(str(pb))
    assert (got == bits).all() and span == 3 and pos == 77
    pa = tmp_path / "x_a.bm"
    assert torch_av.tobm_main(["-i", str(pb), "-o", str(pa), "-A"]) == 0
    got2, span2, pos2 = torch_av.read_bitmap(str(pa))
    assert (got2 == bits).all() and (span2, pos2) == (3, 77)


def test_allvall_dispatcher(av_files, monkeypatch):
    want, _got = parity(av_files, ["-r", "-K", "1"], monkeypatch, "0")
    out = os.path.join(av_files["dir"], "disp.bm")
    monkeypatch.setattr("sys.argv", ["sat", "allvall", "-i", av_files["q"],
                                     "-b", av_files["bg"], "-m", "20",
                                     "-r", "-K", "1", "-o", out, "-A"])
    assert torch_main.main() == 0
    assert open(out, "rb").read() == want
