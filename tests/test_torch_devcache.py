"""One device copy per host code array, across scanners.

The JAX package keeps its device copy of a code array in a module-level
cache keyed by the host array's identity, dropped with the array
(``sequence_alignment_tools_tpu/ops/conv_scan.py::_device_form``); the
port's ``conv_scan.device_form`` does the same per ``torch.device``, for
``ConvScanner`` and ``SellersScanner`` alike.  On the CPU: two scanners
over one array share one tensor, a new array gets a new tensor, the entry
goes with the array, a read-only or memory-mapped array is copied once,
and an xmers or allvall run with several batches or chunks uploads its
database once.
"""

import gc
import io
import weakref

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu_torch.apps import allvall as torch_allvall
from sequence_alignment_tools_tpu_torch.apps import xmers as torch_xmers
from sequence_alignment_tools_tpu_torch.apps.compress_seq import main as cs
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.ops import conv_scan
from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
    ConvScanner,
    device_form,
)
from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
from tests.conftest import make_synthetic_fasta

CPU = torch.device("cpu")


def small_db(n=4096, seed=1):
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    codes[0] = 4
    return SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([1]),
                 entry_lengths=np.array([n - 1]), headers=["e1 test"])


def scanners(db):
    tables = build_tables(build_pattern_set(["ACGTACGTAC", "TTGACCA"],
                                            rev_comp=True), db, wc=False,
                          textn=False)
    return (ConvScanner(tables, k=0, device="cpu"),
            ConvScanner(tables, k=1, device="cpu"),
            SellersScanner(tables, k=1, device="cpu"))


def test_scanners_share_one_copy(monkeypatch):
    """Scans through three scanners over one array (the plain device
    route, ``SAT_HOST_SCAN=0``) upload it once, and the scanners' device
    form is that one tensor."""
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    db = small_db()
    a, b, s = scanners(db)
    before = device_form.uploads
    for sc in (a, b, s, scanners(db)[2]):
        list(sc.scan(db.codes))
    assert device_form.uploads == before + 1
    t = device_form(db.codes, a.device)
    assert device_form(db.codes, s.device) is t
    assert device_form.uploads == before + 1
    assert t.dtype == torch.uint8 and torch.equal(
        t, torch.from_numpy(db.codes))
    # the copy does not alias the host array (it would keep it alive)
    assert t.data_ptr() != db.codes.ctypes.data
    other = db.codes.copy()
    list(a.scan(other))
    t2 = device_form(other, CPU)
    assert t2 is not t and torch.equal(t2, t)
    assert device_form.uploads == before + 2


def test_device_names_share_one_entry():
    codes = np.random.default_rng(5).integers(0, 4, 500).astype(np.uint8)
    before = device_form.uploads
    t = device_form(codes, CPU)
    assert device_form(codes, "cpu") is t
    assert device_form.uploads == before + 1


@pytest.mark.cuda
def test_cuda_device_names_share_one_entry():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes = np.random.default_rng(5).integers(0, 4, 500).astype(np.uint8)
    before = device_form.uploads
    t = device_form(codes, torch.device("cuda"))
    here = torch.device("cuda", torch.cuda.current_device())
    assert device_form(codes, here) is t
    assert device_form(codes, "cuda") is t
    assert device_form.uploads == before + 1
    assert torch.equal(t.cpu(), torch.from_numpy(codes))


def test_entry_drops_with_the_array():
    codes = np.random.default_rng(2).integers(0, 4, 1000).astype(np.uint8)
    t = device_form(codes, CPU)
    key = (id(codes), CPU)
    assert conv_scan._DEV_CACHE[key][1] is t
    gone = weakref.ref(t)
    del t, codes
    gc.collect()
    assert key not in conv_scan._DEV_CACHE
    assert gone() is None


@pytest.mark.parametrize("kind", ["read-only", "memmap", "int64"])
def test_readonly_and_memmap_copied_once(tmp_path, kind):
    base = np.random.default_rng(3).integers(0, 4, 777).astype(np.uint8)
    if kind == "read-only":
        codes = base.copy()
        codes.setflags(write=False)
    elif kind == "memmap":
        path = tmp_path / "codes.bin"
        base.tofile(path)
        codes = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        codes = base.astype(np.int64)
    before = device_form.uploads
    t = device_form(codes, CPU)
    assert device_form(codes, CPU) is t
    assert device_form.uploads == before + 1
    assert torch.equal(t, torch.from_numpy(base))


def test_xmers_uploads_its_database_once(tmp_path, monkeypatch):
    """Phases 1 and 2 build a model per batch: several batches, one
    upload."""
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    fasta = str(tmp_path / "x.fasta")
    make_synthetic_fasta(fasta, total=3000, seed=4)
    assert cs(["-i", fasta, "-n", "true"]) == 0
    opts = torch_xmers.parse_args(["-i", fasta, "-m", "12", "-K", "1",
                                   "-b", "600"])
    before = device_form.uploads
    out = io.StringIO()
    torch_xmers.run(opts, out)
    assert out.getvalue().count("\n") > 10
    assert device_form.uploads == before + 1


def test_allvall_uploads_its_background_once(tmp_path, monkeypatch):
    """Three chunks of 2,048 mers over one background, one upload."""
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    q = str(tmp_path / "q.fasta")
    b = str(tmp_path / "b.fasta")
    text = make_synthetic_fasta(q, n_entries=1, total=4500, seed=6)
    with open(b, "w") as f:
        f.write(">bg\n" + text[1000:1040] + "ACGT" * 50 + "\n")
    out = str(tmp_path / "o.bm")
    before = device_form.uploads
    assert torch_allvall.allvall_main(["-i", q, "-b", b, "-m", "20", "-K",
                                       "1", "-o", out, "-A"]) == 0
    assert device_form.uploads == before + 1
    bits, _s, _p = torch_allvall.read_bitmap(out)
    assert bits[1021:1042].all()
