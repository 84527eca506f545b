"""The rolling-code census of ``csrc/seed_slots.cu``, modelled on the CPU.

The CUDA kernel cannot run here, so its arithmetic is written out below in
numpy, as the kernel runs it: tiles of 1024 x 28 window starts, each
thread rolling one uint64 code per length class over its 28 consecutive
starts (``code(t + 1) = (code(t) - txt[t] alpha^(L-1)) alpha +
txt[t + L]``, text past n read as 0), the presence filter tested on
``h = code * GOLD``, and only then the host table probed at
``(h >> 32) & mask`` with linear probing and the duplicate chains walked.
The model is held against ``scan_slots_ref`` (the plain version) over 1 to
6 length classes of 8 to 24 bases, duplicate seeds, a seed across an EOS
and windows that cross the end of the text; the filter's host build
(``presence_filter``) is checked to set every key's two bits.  Tolerance
0: the outputs are sets of integers.  The kernel itself is held against
``scan_slots_ref`` on the card by the ``cuda``-marked cases of
``tests/test_torch_slots.py``.
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import PatternSet
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.cuda.slots import (
    GOLD,
    presence_filter,
    scan_slots_ref,
)
from sequence_alignment_tools_tpu_torch.ops.tables import build_tables

TABLE = b"ACGT\n"
EOS = 4
THREADS, RUN = 1024, 28
U64 = np.uint64


def filter_test(filt, fbits, codes):
    """The kernel's presence test of uint64 ``codes`` (bool array)."""
    h = codes * U64(GOLD)
    b1 = (h >> U64(64 - fbits)).astype(np.int64)
    b2 = ((h >> U64(64 - 2 * fbits)) & U64((1 << fbits) - 1)).astype(
        np.int64)
    words = filt.view(np.uint32)
    return (((words[b1 >> 5] >> (b1 & 31).astype(np.uint32))
             & (words[b2 >> 5] >> (b2 & 31).astype(np.uint32))) & 1) == 1


def model(codes, n, mt):
    """{(start, seed id)} of the kernel's census over ``codes[:n]``, and
    the number of starts that passed the filter."""
    a = U64(mt.alpha)
    keys = mt.keys.numpy().view(np.uint64)
    head, enext = mt.head.numpy(), mt.enext.numpy()
    epid, filt = mt.epid.numpy(), mt.filt.numpy()
    ntiles = -(-n // (THREADS * RUN))
    span = ntiles * THREADS * RUN + mt.Lmax
    txt = np.zeros(span, np.uint64)
    txt[:n] = codes[:n]
    s0 = np.arange(ntiles * THREADS, dtype=np.int64) * RUN  # one per thread
    found, passed = set(), 0
    for L, mask, off in mt.cls.tolist():
        pw = U64(mt.alpha ** (L - 1) % (1 << 64))
        code = np.zeros(len(s0), np.uint64)
        for j in range(L):
            code = code * a + txt[s0 + j]
        for r in range(RUN):
            if r > 0:
                code = (code - txt[s0 + r - 1] * pw) * a + txt[s0 + r + L - 1]
            live = s0 + r + L <= n
            ok = live & filter_test(filt, mt.fbits, code)
            passed += int(ok.sum())
            for t, c in zip((s0 + r)[ok].tolist(), code[ok].tolist()):
                slot = ((c * GOLD) % (1 << 64) >> 32) & mask
                while keys[off + slot] != ~U64(0):
                    if int(keys[off + slot]) == c:
                        e = head[off + slot]
                        while e >= 0:
                            found.add((t, int(epid[e])))
                            e = enext[e]
                        break
                    slot = (slot + 1) & mask
    return found, passed


def ref_pairs(codes, n, mt):
    row = scan_slots_ref(torch.from_numpy(codes), n, mt, 1 << 20)
    c = int(row[0])
    return set(zip(row[1 : 1 + c].tolist(),
                   row[(1 << 20) + 1 : (1 << 20) + 1 + c].tolist()))


def census(seeds, codes):
    """MerTables of the seed list over a one-entry database of codes."""
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
               entry_lengths=np.array([len(codes)]), headers=["e1"])
    ps = PatternSet(patterns=[""] + seeds, esb=[0] * (len(seeds) + 1),
                    eeb=[0] * (len(seeds) + 1), n_forward=len(seeds))
    sc = ConvScanner(build_tables(ps, db, wc=False, textn=False), k=0,
                     device="cpu")
    return sc._mer_dev()


CASES = [((20,), 60_000), ((8,), 40_000), ((10, 12), 70_000),
         ((8, 13, 17, 24), 58_000), ((9, 11, 14, 16, 21, 24), 61_111),
         ((8, 10, 12, 14, 16, 18), 30_000)]


def census_case(lengths, n):
    """(codes, seeds, MerTables): seeds cut from the text (so they hit)
    and random ones, 25 duplicated; one seed ending at the end of the
    text; a seed planted across an EOS (its halves hit, the whole does
    not)."""
    rng = np.random.default_rng(sum(lengths) + n)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    text = "".join("ACGT"[c] for c in codes)
    seeds = []
    for L in lengths:
        for _ in range(300 // len(lengths)):
            at = int(rng.integers(0, n - L))
            seeds.append(text[at : at + L])
            seeds.append("".join("ACGT"[c] for c in rng.integers(0, 4, L)))
    seeds += seeds[:25]
    L = lengths[-1]
    seeds.append(text[n - L :])
    cut = "".join("ACGT"[c] for c in rng.integers(0, 4, 2 * L + 1))
    codes[n // 2 : n // 2 + 2 * L + 1] = [TABLE.index(c.encode())
                                          for c in cut]
    codes[n // 2 + L] = EOS
    seeds += [cut[:L], cut[L + 1 :], cut[1 : L + 1]]
    return codes, seeds, census(seeds, codes)


@pytest.mark.parametrize("lengths,n", CASES)
def test_model_matches_plain(lengths, n):
    codes, seeds, mt = census_case(lengths, n)
    L = lengths[-1]
    assert len(mt.lens) == len(lengths)
    want = ref_pairs(codes, n, mt)
    got, passed = model(codes, n, mt)
    assert got == want
    starts = {t for t, _s in want}
    assert {n // 2, n // 2 + L + 1, n - L} <= starts
    assert (n // 2 + 1, len(seeds) - 1) not in want  # across the EOS
    # the filter let through every hit and few of the other starts
    assert len(starts) <= passed < len(starts) + n * len(lengths) // 10
    # shorter text: windows that cross the new end do not hit
    m = n - L // 2
    got_m, _p = model(codes, m, mt)
    assert got_m == ref_pairs(codes, m, mt) == {
        (t, s) for t, s in want if t + len(seeds[s]) <= m}


@pytest.mark.parametrize("count", [1, 20, 5_000, 50_000, 100_000])
def test_presence_filter_has_no_false_negatives(count):
    """Every key passes the filter of its own key set, whatever its size;
    at most 128 KB; about 3% of random codes pass a full one."""
    rng = np.random.default_rng(count)
    keys = rng.integers(0, 1 << 62, size=count, dtype=np.int64).astype(
        np.uint64) * U64(3)
    filt, fbits = presence_filter(keys)
    assert 10 <= fbits <= 20 and filt.dtype == np.int32
    assert filt.size == (1 << fbits) // 32
    assert filter_test(filt, fbits, keys).all()
    other = rng.integers(0, 1 << 62, size=20_000, dtype=np.int64).astype(
        np.uint64) * U64(3) + U64(1)
    share = filter_test(filt, fbits, other).mean()
    assert share < (0.05 if count <= 50_000 else 0.1)


def test_filter_of_the_census_tables():
    """MerTables builds its filter from the keys it probes: every
    non-empty slot's key passes."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=5_000).astype(np.uint8)
    seeds = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
             for L in (8, 9, 10, 12, 20, 24) for _ in range(40)]
    mt = census(seeds, codes)
    keys = mt.keys.numpy().view(np.uint64)
    live = keys[keys != ~U64(0)]
    assert len(live) == len(set(seeds))
    assert filter_test(mt.filt.numpy(), mt.fbits, live).all()
    assert mt.to("cpu").filt.equal(mt.filt)
