"""The Sellers scan past one launch's patterns and past byte-sized k.

``csrc/sellers.cu`` takes a grid row per pattern, at most 65,535 a
launch (``cuda.sellers.PATTERN_BLOCK``), so a larger set takes one launch
per block of patterns into one output row; on the CPU ``sellers_scan``
runs its plain version per block and merges the rows the same way.  Here
the block is cut to 7 and a set of 20 patterns (k = 2, with and without
indels) goes through the port's ``SellersScanner`` in three blocks,
against the JAX scanner's XLA block DP.  Past k = 254 the kernel's
counters (no indels) take 16 bit planes; k = 255 over patterns of 300
bases on a short text is held against the JAX scanner too.  Tolerance 0:
every quantity is an integer.  On the card the kernel is held against
the plain version and the native Sellers rows at P = 70,000 and at
k = 255 (the ``cuda``-marked cases below; ``chip_smoke.py`` phase 8).
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.ops.sellers import (
    SellersScanner as JaxSellers,
)
from sequence_alignment_tools_tpu_torch.ops.cuda import sellers as cuda_sellers
from sequence_alignment_tools_tpu_torch.ops.cuda.sellers import (
    SellersTables,
    kernel_takes,
    sellers_ref,
    sellers_scan,
    sellers_tables,
)
from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
from sequence_alignment_tools_tpu_torch.utils import trace
from test_torch_sellers import EOS, both_tables, text_db, triples


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its plain PyTorch row DP is
    many small ops, and beside the other workers of a parallel (xdist)
    run their threads' spin waits made the pattern-block case about 100
    times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cut_patterns(codes, rng, count, length):
    """``count`` patterns of ``length`` bases cut from the text at random
    places, each with up to two substitutions."""
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes)
    pats = []
    for _ in range(count):
        at = int(rng.integers(0, len(text) - length))
        p = list(text[at : at + length])
        for _e in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, length))
            p[j] = "ACGT"[("ACGT".index(p[j]) + 1) % 4]
        pats.append("".join(p))
    return pats


def jax_triples(jt, codes, k, indels, block=1 << 12):
    return list(JaxSellers(jt, k=k, indels=indels, block=block).scan(codes))


def port_triples(pt, codes, k, indels):
    sc = SellersScanner(pt, k=k, indels=indels, device="cpu")
    sc.use_host = False
    assert sc.kernel_available(len(codes))
    return list(sc.scan(codes))


@pytest.mark.parametrize("indels", [True, False])
def test_pattern_blocks_match_jax(monkeypatch, indels):
    monkeypatch.setattr(cuda_sellers, "PATTERN_BLOCK", 7)
    n = 8_000
    codes, kw = text_db(n, 31, entries=5)
    rng = np.random.default_rng(5)
    pats = cut_patterns(codes, rng, 10, 34)
    jt, pt = both_tables(pats, kw)
    assert pt.P == 20
    st = sellers_tables(pt)
    assert [(lo, b.P) for lo, b in st.blocks()] == [(0, 7), (7, 7),
                                                     (14, 6)]
    want = jax_triples(jt, codes, 2, indels)
    assert port_triples(pt, codes, 2, indels) == want
    assert len({p for _e, p, _d in want}) >= 10
    # a cap below the count: the true count, and kept triples among the
    # full set
    full = sellers_scan(torch.from_numpy(codes), n, st, EOS, 2, indels,
                        1 << 16)
    row = sellers_scan(torch.from_numpy(codes), n, st, EOS, 2, indels, 5)
    assert int(row[0]) == int(full[0]) == len(want)
    assert len(triples(row, 5)) == 5
    assert triples(row, 5) <= triples(full) == {
        (e, p, d) for e, p, d in want}


@pytest.mark.parametrize("indels", [True, False])
def test_k255_long_patterns_match_jax(indels):
    n = 800
    codes, kw = text_db(n, 77, entries=2)
    pats = cut_patterns(codes, np.random.default_rng(6), 2, 300)
    jt, pt = both_tables(pats, kw)
    assert pt.Lmax == 300
    want = jax_triples(jt, codes, 255, indels, 1 << 10)
    assert port_triples(pt, codes, 255, indels) == want
    assert len(want) > n
    assert max(d for _e, _p, d in want) > 200


def test_kernel_takes_any_pattern_count_and_k():
    """70,000 patterns make two blocks; k up to 65,534 (16 counter
    planes)."""
    rng = np.random.default_rng(3)
    P, L = 70_000, 20
    acc = np.zeros((P, L, 1), np.uint32)
    acc[:, :, 0] = np.uint32(1) << rng.integers(0, 4, size=(P, L)).astype(
        np.uint32)
    st = SellersTables(torch.from_numpy(acc.view(np.int32)),
                       torch.full((P,), L, dtype=torch.int32), 5)
    assert [(lo, b.P) for lo, b in st.blocks()] == [(0, 65_535),
                                                     (65_535, 4_465)]
    assert all(b.peq.is_contiguous() for _lo, b in st.blocks())
    for k in (0, 254, 255, 65_534):
        assert kernel_takes(st, k)
    assert not kernel_takes(st, 65_535)


def big_pattern_case(P, n, seed):
    """A text of ``n`` bases in one entry and ``P`` 20-base patterns, a
    tenth of them cut from the text (so they hit); the port's tables.  No
    EOS: the native Sellers rows take Myers' column reset at an EOS, not
    the row DP's (ROADMAP.md queue 3, standing), so they are the
    reference only away from one; the EOS cases are held against plain
    (``test_torch_sellers.py``, and k = 255 below)."""
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.io.patterns import PatternSet
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables

    codes, kw = text_db(n, seed, entries=1)
    rng = np.random.default_rng(seed)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes)
    pats = ["".join("ACGT"[c] for c in rng.integers(0, 4, 20))
            for _ in range(P)]
    for i in range(0, P, 10):
        at = int(rng.integers(0, n - 20))
        pats[i] = text[at : at + 20]
    ps = PatternSet(patterns=[""] + pats, esb=[0] * (P + 1),
                    eeb=[0] * (P + 1), n_forward=P)
    return codes, build_tables(ps, SeqDB(**kw), wc=False, textn=False)


def native_rows(tables, k, codes, bits=24 * 64):
    """The native Sellers rows (``HostSellers``) over groups of patterns
    whose lengths sum to at most ``bits`` (one machine each);
    {(end, pid, dist)}."""
    from sequence_alignment_tools_tpu_torch.ops.host_scan import HostSellers
    from sequence_alignment_tools_tpu_torch.ops.tables import PatternTables

    out = set()
    lens = tables.lengths.astype(np.int64)
    per = max(bits // int(lens.max()), 1)
    for lo in range(0, tables.P, per):
        sl = slice(lo, min(lo + per, tables.P))
        hs = HostSellers(PatternTables(
            match=tables.match[sl], lengths=tables.lengths[sl],
            pat_codes=tables.pat_codes[sl], Lmax=tables.Lmax,
            alpha=tables.alpha, eos_code=tables.eos_code), k)
        assert hs.available()
        ends, pids, dist = hs.pairs(np.asarray(codes))
        out |= set(zip(ends.tolist(), (pids + lo).tolist(), dist.tolist()))
    return out


@pytest.mark.cuda
def test_cuda_70000_patterns():
    """P = 70,000 (two launches) at k = 2 with indels: the kernel equal to
    the plain version and to the native Sellers rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    codes, tables = big_pattern_case(70_000, 4_096, 8)
    st = sellers_tables(tables).to("cuda")
    dev = torch.from_numpy(codes).cuda()
    cap = 1 << 20
    before = trace.total("launch.sellers_scan")
    got = sellers_scan(dev, len(codes), st, EOS, 2, True, cap)
    want = sellers_ref(dev, len(codes), st, EOS, 2, True, cap)
    torch.cuda.synchronize()
    assert trace.total("launch.sellers_scan") == before + 2
    assert int(got[0]) == int(want[0]) > 0
    assert triples(got, cap) == triples(want, cap) == native_rows(
        tables, 2, codes)


@pytest.mark.cuda
@pytest.mark.parametrize("indels", [True, False])
def test_cuda_k255(indels):
    """k = 255 over patterns of 300 bases: the kernel equal to the plain
    version (the native rows take k <= 8 only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 20_000
    codes, kw = text_db(n, 78, entries=4)
    _jt, pt = both_tables(cut_patterns(codes, np.random.default_rng(7), 2,
                                       300), kw)
    st = sellers_tables(pt).to("cuda")
    dev = torch.from_numpy(codes).cuda()
    cap = 1 << 20
    got = sellers_scan(dev, n, st, EOS, 255, indels, cap)
    want = sellers_ref(dev, n, st, EOS, 255, indels, cap)
    torch.cuda.synchronize()
    assert int(got[0]) == int(want[0]) > n
    assert triples(got, cap) == triples(want, cap)
