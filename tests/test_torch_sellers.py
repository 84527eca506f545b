"""The port's Sellers k-edit scan against the JAX package's.

``sellers_ref`` (the plain PyTorch version of ``csrc/sellers.cu``) is held
against the JAX ``_sellers_block`` row DP, driven block by block with its
halos by the JAX ``SellersScanner.scan``: the same (end, pattern,
distance) triples, with indels on and off, k = 1, 2 and 4, long and short
patterns, EOS sprinkled through the text and an IUPAC alphabet under
``-w``.  Its hit sets are also held against the JAX Pallas Sellers kernel
(``scan_pairs`` with ``pallas_interpret = True``, as
``tests/test_sellers_kernel.py`` runs it).  Tolerance 0: every quantity
is an integer.  The CUDA kernel is held against the plain version on the
card (marked ``cuda``; ``chip_smoke.py`` does the same at full size).
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.io.database import SeqDB as JaxSeqDB
from sequence_alignment_tools_tpu.io.patterns import (
    build_pattern_set as jax_build_pattern_set,
)
from sequence_alignment_tools_tpu.ops.sellers import SEG
from sequence_alignment_tools_tpu.ops.sellers import (
    SellersScanner as JaxSellers,
)
from sequence_alignment_tools_tpu.ops.tables import (
    build_tables as jax_build_tables,
)
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.ops.cuda.sellers import (
    SellersTables,
    sellers_ref,
    sellers_scan,
    sellers_tables,
)
from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
from sequence_alignment_tools_tpu_torch.utils import trace

TABLE = b"ACGT\n"
EOS = 4
CAP = 1 << 16


def text_db(n, seed, entries=4):
    """Seeded ACGT codes with EOS sprinkled in, and the JAX and port
    SeqDB keyword arguments."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[np.sort(rng.integers(1, n - 1, size=entries - 1))] = EOS
    return codes, dict(codes=codes, table=TABLE, entry_starts=np.array([0]),
                       entry_lengths=np.array([n]), headers=["x"])


def long_patterns(codes, rng):
    """Patterns cut from the text (36 to 40 bases, some with 1 or 2 edits,
    so they hit) plus a short one."""
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes)
    pats = []
    for i, at in enumerate((700, 2600, 5100, 9000)):
        p = list(text[at : at + 36 + i])
        for _ in range(i % 3):
            j = int(rng.integers(3, len(p) - 3))
            p[j] = "ACGT"[("ACGT".index(p[j]) + 1) % 4]
        pats.append("".join(p))
    return pats + [text[1500:1513]]


def triples(row, cap=CAP):
    """{(end, pid, dist)} of a ``[count, pos, pid, dist]`` row."""
    row = row.cpu().numpy()
    c = min(int(row[0]), cap)
    return set(zip((row[1 : 1 + c] + 1).tolist(),
                   row[1 + cap : 1 + cap + c].tolist(),
                   row[1 + 2 * cap : 1 + 2 * cap + c].tolist()))


def both_tables(pats, kw, rev_comp=True, wc=False):
    jt = jax_build_tables(jax_build_pattern_set(pats, rev_comp=rev_comp),
                          JaxSeqDB(**kw), wc=wc, textn=False)
    pt = build_tables(build_pattern_set(pats, rev_comp=rev_comp),
                      SeqDB(**kw), wc=wc, textn=False)
    return jt, pt


@pytest.mark.parametrize("seed,k,indels", [(0, 1, True), (1, 2, True),
                                           (2, 4, True), (3, 2, False)])
def test_plain_distances_match_block_dp(seed, k, indels):
    n = 12_000
    codes, kw = text_db(n, seed)
    pats = long_patterns(codes, np.random.default_rng(seed))
    jt, pt = both_tables(pats, kw)
    want = {(e, p, d) for e, p, d in JaxSellers(
        jt, k=k, indels=indels, block=1 << 12).scan(codes)}
    row = sellers_ref(torch.from_numpy(codes), n, sellers_tables(pt), EOS,
                      k, indels, CAP)
    assert int(row[0]) == len(want)
    assert triples(row) == want
    assert len({p for _e, p, _d in want}) >= 4


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2)])
def test_plain_matches_jax_kernel(seed, k):
    """The hit set of the JAX Pallas Sellers kernel in interpret mode, with
    a multi-pattern boundary (a near-duplicate pattern) and a partial
    trailing segment."""
    n = 2 * SEG + 777
    codes, kw = text_db(n, seed, entries=3)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:6000])
    pats = [text[100:135], text[3000:3036], text[5000:5033]]
    pats.append(pats[0][:10] + "T" + pats[0][11:])
    jt, pt = both_tables(pats, kw)
    sc = JaxSellers(jt, k=k, indels=True)
    sc.pallas_interpret = True
    assert sc.kernel_available(n) and not sc.myers_available(n)
    ends, pids = sc.scan_pairs(codes)
    want = set(zip(ends.tolist(), pids.tolist()))
    row = sellers_ref(torch.from_numpy(codes), n, sellers_tables(pt), EOS,
                      k, True, CAP)
    assert {(e, p) for e, p, _d in triples(row)} == want and want


def test_iupac_alphabet():
    """-w over an IUPAC database (15 codes and EOS): accept sets are
    classes, not single codes."""
    rng = np.random.default_rng(11)
    n = 10_000
    table = b"ACGTRYSWKMBDHVN\n"
    base = rng.integers(0, 4, size=n)
    amb = rng.random(n) < 0.05
    base[amb] = rng.integers(4, 15, size=int(amb.sum()))
    base[[2000, 6000]] = 15
    codes = base.astype(np.uint8)
    kw = dict(codes=codes, table=table, entry_starts=np.array([0]),
              entry_lengths=np.array([n]), headers=["w"])
    text = "".join(chr(table[c]) for c in codes)
    pats = [text[300:334], "ACGRYTNNSWKTACGTTGCAAC", text[7000:7018]]
    jt, pt = both_tables(pats, kw, wc=True)
    for k in (1, 2):
        want = {(e, p, d) for e, p, d in JaxSellers(
            jt, k=k, indels=True, block=1 << 12).scan(codes)}
        row = sellers_ref(torch.from_numpy(codes), n, sellers_tables(pt),
                          15, k, True, CAP)
        assert triples(row) == want and want


def test_tables_and_cap():
    codes, kw = text_db(3000, 5)
    codes[200:700] = 0  # a poly-A run: hits at every position
    jt, pt = both_tables(["AAAAAAAAAA", "ACGTTGCAACGT"], kw, rev_comp=False)
    st = sellers_tables(pt)
    acc = st.acc.numpy().view(np.uint32)
    for p in range(pt.P):
        for j in range(pt.Lmax):
            for c in range(pt.alpha):
                assert bool((acc[p, j, c >> 5] >> (c & 31)) & 1) \
                    == bool(pt.match[p, j, c])
    full = sellers_ref(torch.from_numpy(codes), 3000, st, EOS, 1, True, CAP)
    row = sellers_ref(torch.from_numpy(codes), 3000, st, EOS, 1, True, 8)
    assert int(row[0]) == int(full[0]) > 490
    assert triples(row, 8) <= triples(full)


@pytest.mark.cuda
@pytest.mark.parametrize("k,indels", [(1, True), (2, True), (4, True),
                                      (2, False)])
def test_cuda_kernel_matches_plain(k, indels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 200_000
    codes, kw = text_db(n, k, entries=40)
    _jt, pt = both_tables(long_patterns(codes, np.random.default_rng(k)),
                          kw)
    st = sellers_tables(pt).to("cuda")
    dev = torch.from_numpy(codes).cuda()
    for nn in (n, n - 777):
        before = trace.total("launch.sellers_scan")
        got = sellers_scan(dev, nn, st, EOS, k, indels, CAP)
        want = sellers_ref(dev, nn, st, EOS, k, indels, CAP)
        torch.cuda.synchronize()
        assert trace.total("launch.sellers_scan") == before + 1
        assert int(got[0]) == int(want[0]) > 0
        assert triples(got) == triples(want)



@pytest.mark.cuda
@pytest.mark.parametrize("k,indels,longest", [(2, True, 3_000),
                                              (2, False, 3_000),
                                              (4, True, 3_000),
                                              (2, True, 7_500)])
def test_cuda_kernel_long_patterns(k, indels, longest):
    """Patterns of 1,800 to 3,000 bases (64 threads a block, the columns
    in shared memory) and up to 7,500 (the lower cells of the columns in
    device scratch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 120_000
    codes, kw = text_db(n, 40 + k, entries=6)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes)
    rng = np.random.default_rng(k)
    pats = []
    for i, (at, ln) in enumerate(((3_000, longest), (40_000, 2_500),
                                  (80_000, 1_800))):
        p = list(text[at : at + ln])
        for _ in range(i):
            j = int(rng.integers(10, ln - 10))
            p[j] = "ACGT"[("ACGT".index(p[j]) + 1) % 4]
        pats.append("".join(p))
    _jt, pt = both_tables(pats, kw)
    st = sellers_tables(pt).to("cuda")
    dev = torch.from_numpy(codes).cuda()
    for nn in (n, n - 777):
        got = sellers_scan(dev, nn, st, EOS, k, indels, CAP)
        want = sellers_ref(dev, nn, st, EOS, k, indels, CAP)
        torch.cuda.synchronize()
        assert int(got[0]) == int(want[0]) > 0
        assert triples(got) == triples(want)


@pytest.mark.cuda
@pytest.mark.parametrize("segc", [None, 32, 4096])
def test_cuda_block_bit_parallel_shapes(segc):
    """The shapes of the CPU model (``tests/test_torch_sellers_bp.py``):
    k 0 to 4 and k >= m, ragged lengths of 1 to 100, EOS-dense text,
    IUPAC-like classes, a 41-code alphabet, with and without indels; on
    a codes slice that is not 4-byte aligned too; and the EOS contract
    of ACGTAC on EOS CGTAC.  Kernel == plain, triple for triple."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from test_torch_sellers_bp import SHAPES, plant, random_tables

    for name, (k, indels, lens, alpha, eos_share, edits, _s, amb) in \
            SHAPES.items():
        rng = np.random.default_rng(sum(map(ord, name)))
        st = random_tables(rng, lens, alpha, amb)
        n = 30_000
        codes = rng.integers(0, alpha - 1, size=n).astype(np.uint8)
        plant(rng, codes, st, 200, edits)
        codes[rng.random(n) < eos_share] = alpha - 1
        st = st.to("cuda")
        dev = torch.from_numpy(
            np.concatenate([np.zeros(1, np.uint8), codes])).cuda()
        cap = 1 << 20  # k >= m: every position hits
        for cd in (dev[1:].clone(), dev[1:]):
            got = sellers_scan(cd, n - 5, st, alpha - 1, k, indels, cap,
                               segc)
            want = sellers_ref(cd, n - 5, st, alpha - 1, k, indels, cap)
            torch.cuda.synchronize()
            assert int(got[0]) == int(want[0]) > 0, name
            assert triples(got, cap) == triples(want, cap), name
    acc = torch.tensor([[[1], [2], [4], [8], [1], [2]]], dtype=torch.int32)
    st = SellersTables(acc, torch.tensor([6], dtype=torch.int32), 5).to(
        "cuda")
    for text, want in (([EOS, 1, 2, 3, 0, 1], 0), ([3, 1, 2, 3, 0, 1], 1)):
        got = sellers_scan(torch.tensor(text, dtype=torch.uint8).cuda(), 6,
                           st, EOS, 1, True, CAP, segc)
        assert int(got[0]) == want

