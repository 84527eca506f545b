"""The port's Myers k-edit scan against the JAX package's.

``myers_pairs_ref`` (the plain PyTorch version of ``csrc/myers.cu``) is
held against the JAX ``SellersScanner._myers_pairs`` with its Pallas
kernel in interpret mode, as ``tests/test_myers_kernel.py`` runs it, on
the same seeded text: k = 1, 2, 3, patterns packed two to a word,
segment-boundary straddles, EOS-adjacent plants and entries shorter than
the warm-up halo.  Tolerance 0: the candidate sets are sets of integers.
The layout builder ``myers_eqbits`` equals the JAX one.  The CUDA kernel
is held against the plain version on the card (marked ``cuda``;
``chip_smoke.py`` does the same at full size).
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.io.database import SeqDB as JaxSeqDB
from sequence_alignment_tools_tpu.io.patterns import (
    build_pattern_set as jax_build_pattern_set,
)
from sequence_alignment_tools_tpu.ops.pallas.myers_kernel import (
    myers_eqbits as jax_myers_eqbits,
)
from sequence_alignment_tools_tpu.ops.sellers import (
    SellersScanner as JaxSellers,
)
from sequence_alignment_tools_tpu.ops.tables import (
    build_tables as jax_build_tables,
)
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.ops.cuda.myers import (
    myers_eqbits,
    myers_pairs,
    myers_pairs_ref,
    myers_tables,
)
from sequence_alignment_tools_tpu_torch.ops.tables import build_tables

TABLE = b"ACGT\n"
EOS = 4
CAP = 1 << 16
PATS = ["ACGTACGTACGT", "TTGACCATGAC", "CCCGGGTTTAA"]


def make(n, pats, seed, eos_at=(), plant=()):
    """(JAX tables, port tables, codes) of a seeded one-entry text."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for at, s in plant:
        codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
    codes[list(eos_at)] = EOS
    kw = dict(codes=codes, table=TABLE, entry_starts=np.array([0]),
              entry_lengths=np.array([n]), headers=["e1"])
    jt = jax_build_tables(jax_build_pattern_set(pats), JaxSeqDB(**kw),
                          wc=False, textn=False)
    pt = build_tables(build_pattern_set(pats), SeqDB(**kw), wc=False,
                      textn=False)
    return jt, pt, codes


def jax_pairs(jt, codes, k):
    sc = JaxSellers(jt, k=k, indels=True)
    sc.pallas_interpret = True
    sc._MY_SEGC = 64  # tiny segments: a halo every 64 positions
    assert sc.myers_available(len(codes))
    ends, pids = sc._myers_pairs(codes)
    return set(zip(ends.tolist(), pids.tolist()))


def pairs(row, cap=CAP):
    """{(end, pid)} of a ``[count, pos (cap), pid (cap)]`` row, the end
    being the boundary pos + 1."""
    row = row.cpu().numpy()
    c = min(int(row[0]), cap)
    return set(zip((row[1 : 1 + c] + 1).tolist(),
                   row[1 + cap : 1 + cap + c].tolist()))


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 3)])
def test_plain_matches_jax_kernel(seed, k):
    n = 66_000
    plant = [(1000, "ACGTACGTACGT"), (64 * 37 - 5, "TTGACCATGAC"),
             (n - 11, "CCCGGGTTTAA"), (2000, "ACGTACCTACGT"),
             (3000, "ACGTACGACGT"), (4000, "ACGTAACGTACGT"),
             (5000, "ACCTACGTACCT")]
    jt, pt, codes = make(n, PATS, seed, (1500, 64 * 50, 7000), plant)
    want = jax_pairs(jt, codes, k)
    mt = myers_tables(pt)
    assert mt.nw == 2  # 12 + 1 + 11 bits share a word
    row = myers_pairs_ref(torch.from_numpy(codes), n, mt, EOS, k, CAP)
    assert int(row[0]) == len(want)
    assert pairs(row) == want
    assert len(want) > 8
    # the segment length is free: another one gives the same set
    row2 = myers_pairs_ref(torch.from_numpy(codes), n, mt, EOS, k, CAP,
                           segc=200)
    assert pairs(row2) == want


def test_eos_adjacent_and_short_entries():
    """Plants split by EOS, hits right before and after an EOS, and
    entries shorter than the warm-up halo (EOS every 9 positions)."""
    n = 66_000
    pats = ["ACGTTGCA", "GGATCCA"]
    eos_at = tuple(range(100, 3000, 137)) + tuple(range(9000, 9400, 9))
    plant = [(96, "ACGT"), (101, "TGCA"), (236, "ACGTTGCA"),
             (9001, "GGATCCA"), (9010, "GGTCCA"), (9019, "ACGTTGC")]
    jt, pt, codes = make(n, pats, 7, eos_at, plant)
    for k in (1, 2):
        want = jax_pairs(jt, codes, k)
        row = myers_pairs_ref(torch.from_numpy(codes), n, myers_tables(pt),
                              EOS, k, CAP)
        assert pairs(row) == want and want


def test_eqbits_layout_matches_jax():
    pats = ["ACGTACGTACGTACGTA", "TTGACCATGAC", "CCCGGGTTTAAGGC",
            "ACGRYTNNSWKT", "GGATCC"]
    _jt, pt, _codes = make(2000, pats, 3)
    jt = jax_build_tables(jax_build_pattern_set(pats, rev_comp=True),
                          JaxSeqDB(codes=_codes, table=TABLE,
                                   entry_starts=np.array([0]),
                                   entry_lengths=np.array([2000]),
                                   headers=["e1"]), wc=True, textn=False)
    pt = build_tables(build_pattern_set(pats, rev_comp=True),
                      SeqDB(codes=_codes, table=TABLE,
                            entry_starts=np.array([0]),
                            entry_lengths=np.array([2000]),
                            headers=["e1"]), wc=True, textn=False)
    assert myers_eqbits(pt) == jax_myers_eqbits(jt)
    mt = myers_tables(pt)
    eqwords, wordspec, lens, classes = jax_myers_eqbits(jt)
    for w, row in enumerate(eqwords):
        for ci, c in enumerate(classes):
            assert int(mt.eq[c, w]) == row[ci]
        assert tuple(mt.words_np[w, :2]) == wordspec[w]


def test_cap_keeps_the_true_count():
    n = 20_000
    jt, pt, codes = make(n, ["AAAAAAAA"], 5, plant=[(100, "A" * 400)])
    row = myers_pairs_ref(torch.from_numpy(codes), n, myers_tables(pt),
                          EOS, 1, 4)
    full = myers_pairs_ref(torch.from_numpy(codes), n, myers_tables(pt),
                           EOS, 1, CAP)
    assert int(row[0]) == int(full[0]) > 400
    assert pairs(row, 4) <= pairs(full)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3])
def test_cuda_kernel_matches_plain(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 200_000
    _jt, pt, codes = make(n, PATS + ["GATTACAGATTACA"], k,
                          tuple(range(50, n, 9973)),
                          [(1000, "ACGTACGTACGT"), (2000, "ACGTACCTACGT")])
    mt = myers_tables(pt).to("cuda")
    dev = torch.from_numpy(codes).cuda()
    for nn in (n, n - 777):
        before = myers_pairs.launches
        got = myers_pairs(dev, nn, mt, EOS, k, CAP)
        want = myers_pairs_ref(dev, nn, mt, EOS, k, CAP)
        torch.cuda.synchronize()
        assert myers_pairs.launches == before + 1
        assert int(got[0]) == int(want[0]) > 0
        assert pairs(got) == pairs(want)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", list(range(1, 17)) + [18, 22, 27, 32])
def test_cuda_kernel_each_word_count(nw):
    """Each instance of the kernel's dispatch: exact word counts 1 to 16,
    and counts that take the padded instances (20, 24, 28, 32 words),
    as singletons of 17 to 24 bases on text with EOS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(nw)
    pats = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
            for ln in rng.integers(17, 25, size=nw)]
    n = 50_000
    plant = [(500 + 1500 * i, p) for i, p in enumerate(pats)]
    _jt, pt, codes = make(n, pats, nw, tuple(range(77, n, 4093)), plant)
    mt = myers_tables(pt)
    assert mt.nw == nw
    mt = mt.to("cuda")
    dev = torch.from_numpy(codes).cuda()
    got = myers_pairs(dev, n, mt, EOS, 2, CAP)
    want = myers_pairs_ref(dev, n, mt, EOS, 2, CAP)
    torch.cuda.synchronize()
    assert int(got[0]) == int(want[0]) >= nw
    assert pairs(got) == pairs(want)
