"""A numpy model of the Myers kernel's word arithmetic against the plain
version and the JAX package.

``csrc/myers.cu`` does not run the recurrence of ``myers_pairs_ref`` word
for word: it moves field B of a paired word to the top of the word, sets
every bit outside the fields in the staged Eq rows (so that no carry or
shift crosses from field A into field B), keeps each score biased by
-(k + 1) and updates it from bit 31 of Ph and Mh (field A's top moved
there by a multiply) with arithmetic shifts, folds the hit
test into one OR per word and one sign test per character, reads its text
16 codes at a time with one has-zero-byte EOS test per 4 codes, rounds
its segment and halo up to multiples of 16, and runs one template per
exact word count up to 16 (then 20, 24, 28, 32 with inert padding
words).  :func:`kernel_model` repeats that arithmetic in uint32 numpy,
vectorised over segments, and is held against ``myers_pairs_ref``
(tolerance 0: sets of integer pairs and the true count) on singleton and
paired words, fields of 31 bases, k = 1 to 3, an EOS at every offset of a
16-code group, and word counts that take the padded templates; on one
case against the JAX package's Pallas kernel in interpret mode, as
``tests/test_torch_myers.py`` runs it.
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu_torch.ops.cuda.myers import (
    myers_pairs_ref,
    myers_segc,
    myers_tables,
)
from test_torch_myers import EOS, PATS, jax_pairs, make, pairs

CAP = 1 << 16
M32 = np.uint64(0xFFFFFFFF)


def template_words(nw):
    """The kernel's template word count for nw words (``pick``)."""
    if nw <= 16:
        return nw
    return -(-nw // 4) * 4


def word_constants(words, k):
    """The kernel's ``Words`` (launch<NW>): per word ones, gap, mul_a,
    fresh biased scores, pattern ids, over the template's words."""
    nw = len(words)
    NW = template_words(nw)
    c = {key: np.zeros(NW, np.uint64) for key in
         ("ones", "gap", "mul_a")}
    c.update({key: np.zeros(NW, np.int64) for key in
              ("s0a", "s0b", "pa", "pb", "la", "lb")})
    for w in range(NW):
        on = w < nw
        pair = on and words[w, 1] >= 0
        la = int(words[w, 2]) if on else 1
        lb = int(words[w, 3]) if pair else 0
        ma = (1 << la) - 1 if on else 0
        mb = ((1 << lb) - 1) << (32 - lb) if pair else 0
        c["ones"][w] = ma | mb
        c["gap"][w] = ~(ma | mb) & 0xFFFFFFFF
        c["mul_a"][w] = 1 << (32 - la) if on else 0
        c["s0a"][w] = la - (k + 1) if on else 1 << 24
        c["s0b"][w] = lb - (k + 1) if pair else 1 << 24
        c["pa"][w] = words[w, 0] if on else -1
        c["pb"][w] = words[w, 1] if pair else -1
        c["la"][w], c["lb"][w] = la, lb
    return c


def staged_eq(eq, c):
    """The kernel's shared Eq rows [256, NW]: field A kept, field B moved
    to the top, the gap bits set (every bit of a padding word)."""
    eq = eq.astype(np.int64) & 0xFFFFFFFF
    NW = len(c["ones"])
    out = np.repeat(c["gap"][None, :], 256, axis=0)
    for w in range(eq.shape[1]):
        la, lb = int(c["la"][w]), int(c["lb"][w])
        e = eq[:, w].astype(np.uint64)
        a = e & np.uint64((1 << la) - 1)
        b = ((e >> np.uint64(la + 1)) << np.uint64(32 - lb)) & M32 \
            if lb > 0 else np.uint64(0)
        out[:, w] = a | b | c["gap"][w]
    return out


def sign31(a):
    """int32(a) >> 31: -1 where bit 31 of the uint32 a is set, else 0."""
    return -((a >> np.uint64(31)) & np.uint64(1)).astype(np.int64)


def has_zero_byte(z):
    """The kernel's EOS test of a 4-code group (z = word ^ eos * 0x01010101)."""
    return (((z - np.uint64(0x01010101)) & M32) & (~z & M32)
            & np.uint64(0x80808080)) != 0


def kernel_model(codes, n, mt, eos, k, segc=None):
    """(true count, {(pos, pid)}) as ``csrc/myers.cu`` computes them."""
    words = mt.words_np
    c = word_constants(words, k)
    eq_s = staged_eq(mt.eq.numpy(), c)
    halo0 = mt.Lmax + k
    segc = segc or myers_segc(n, halo0)
    segc = -(-segc // 16) * 16
    halo = -(-halo0 // 16) * 16
    nseg = -(-n // segc)
    steps = halo + segc
    NW = len(c["ones"])
    start = np.arange(nseg, dtype=np.int64) * segc - halo
    pos = start[:, None] + np.arange(steps)[None, :]
    text = np.full(pos.shape, eos, np.uint64)
    inside = (pos >= 0) & (pos < n)
    text[inside] = codes[pos[inside]]
    # the 4-code groups as the kernel loads them, little-endian
    grp = text.reshape(nseg, steps // 4, 4)
    packed = (grp[:, :, 0] | (grp[:, :, 1] << np.uint64(8))
              | (grp[:, :, 2] << np.uint64(16)) | (grp[:, :, 3]
                                                    << np.uint64(24)))
    group_eos = has_zero_byte(packed ^ np.uint64(eos * 0x01010101))
    ones = c["ones"][None, :]
    pv = np.repeat(ones, nseg, axis=0).copy()
    mv = np.zeros_like(pv)
    sa = np.repeat(c["s0a"][None, :], nseg, axis=0).copy()
    sb = np.repeat(c["s0b"][None, :], nseg, axis=0).copy()
    two = np.uint64(2)
    found = set()
    count = 0
    for j in range(steps):
        ch = text[:, j]
        e = eq_s[ch.astype(np.int64)]
        xv = e | mv
        s = ((e & pv) + pv) & M32
        xh = (s ^ pv) | e
        ph = (mv | ~(xh | pv)) & M32
        mh = pv & xh
        sa = sa + sign31((mh * c["mul_a"]) & M32) \
            - sign31((ph * c["mul_a"]) & M32)
        sb = sb + sign31(mh) - sign31(ph)
        acc = np.bitwise_or.reduce(sa | sb, axis=1)
        phs = (ph * two) & M32
        mhs = (mh * two) & M32
        pv = (mhs | ~(xv | phs)) & ones
        mv = phs & xv & ones
        # the gap invariant the layout rests on
        assert not ((ph | mh) & c["gap"]).any()
        reset = group_eos[:, j // 4] & (ch == eos)
        pv = np.where(reset[:, None], ones, pv)
        mv = np.where(reset[:, None], 0, mv)
        sa = np.where(reset[:, None], c["s0a"][None, :], sa)
        sb = np.where(reset[:, None], c["s0b"][None, :], sb)
        acc = np.where(reset, 0, acc)
        if j < halo:
            continue
        for si in np.flatnonzero(acc < 0):
            p = int(pos[si, j])
            assert p < n  # past n the text is EOS, which never ends a hit
            for w in range(NW):
                for sc, pid in ((sa, c["pa"]), (sb, c["pb"])):
                    if sc[si, w] < 0:
                        assert pid[w] >= 0
                        found.add((p, int(pid[w])))
                        count += 1
    return count, found


def plain(codes, n, mt, k):
    row = myers_pairs_ref(torch.from_numpy(codes), n, mt, EOS, k, CAP)
    return int(row[0]), {(e - 1, p) for e, p in pairs(row)}


def random_pats(rng, count, lo, hi):
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
            for ln in rng.integers(lo, hi + 1, size=count)]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_pairs_and_singletons(k):
    """Paired words (12 + 1 + 11 bits), and 20-base singletons."""
    rng = np.random.default_rng(10 + k)
    pats = PATS + random_pats(rng, 2, 20, 20)
    plant = [(300, "ACGTACGTACGT"), (900, "ACGTACCTACGT"),
             (1500, pats[-1]), (2100, pats[-2][:9] + pats[-2][10:])]
    _jt, pt, codes = make(6000, pats, k, (700, 2500, 4444), plant)
    mt = myers_tables(pt)
    assert (mt.words_np[:, 1] >= 0).any() and (mt.words_np[:, 1] < 0).any()
    for segc in (64, 200, None):
        got = kernel_model(codes, len(codes), mt, EOS, k, segc)
        assert got == plain(codes, len(codes), mt, k)
    assert got[0] > 4


def test_fields_of_31_bases():
    """A 31-base singleton (field A's top at bit 30) and a full pair of
    15 + 1 + 16 bits (field B already at the top)."""
    rng = np.random.default_rng(3)
    p31, p15, p16 = random_pats(rng, 1, 31, 31) + random_pats(
        rng, 1, 15, 15) + random_pats(rng, 1, 16, 16)
    plant = [(100, p31), (500, p31[:12] + "A" + p31[13:]),
             (900, p15), (1300, p16[:5] + p16[6:]), (1700, p16)]
    _jt, pt, codes = make(4000, [p31, p15, p16], 3, (1200,), plant)
    mt = myers_tables(pt)
    lens = sorted(tuple(r) for r in mt.words_np[:, 2:].tolist())
    assert lens == [(16, 15), (31, 0)]
    for k in (1, 2):
        got = kernel_model(codes, len(codes), mt, EOS, k, 64)
        assert got == plain(codes, len(codes), mt, k) and got[0] > 0


def test_eos_at_every_offset_of_a_group():
    """An EOS at each offset 0..15 of a 16-code group, hits ending right
    before and starting right after each, and entries shorter than the
    halo."""
    pats = ["ACGTTGCA", "GGATCCA"]
    eos_at, plant = [], []
    for off in range(16):
        at = 160 * (off + 1) + off
        eos_at.append(at)
        plant += [(at - 8, "ACGTTGCA"), (at + 1, "GGATCCA")]
    eos_at += list(range(3000, 3300, 9))
    _jt, pt, codes = make(4096, pats, 7, tuple(eos_at), plant)
    mt = myers_tables(pt)
    for k in (1, 2):
        got = kernel_model(codes, len(codes), mt, EOS, k, 64)
        want = plain(codes, len(codes), mt, k)
        assert got == want
        ends = {p for p, _ in got[1]}
        assert all(at - 1 in ends for at in eos_at[:16])


@pytest.mark.parametrize("count", [1, 9, 17, 31])
def test_word_counts(count):
    """Word counts with an exact template (1, 5) and the padded ones
    (17 -> 20, 31 -> 32 singletons of 17 to 24 bases)."""
    rng = np.random.default_rng(100 + count)
    if count == 9:
        pats = random_pats(rng, 9, 9, 12)  # pairs: 5 words
    else:
        pats = random_pats(rng, count, 17, 24)
    plant = [(150 + 400 * i, p) for i, p in enumerate(pats[:6])]
    _jt, pt, codes = make(3000, pats, count, (1000,), plant)
    mt = myers_tables(pt)
    assert mt.nw == (5 if count == 9 else count)
    got = kernel_model(codes, len(codes), mt, EOS, 2, 64)
    assert got == plain(codes, len(codes), mt, 2) and got[0] >= len(plant)


def test_model_matches_jax_kernel():
    """One case through the JAX package's Pallas kernel (interpret
    mode)."""
    n = 8000
    plant = [(1000, "ACGTACGTACGT"), (64 * 37 - 5, "TTGACCATGAC"),
             (n - 11, "CCCGGGTTTAA"), (2000, "ACGTACCTACGT"),
             (3000, "ACGTACGACGT"), (4000, "ACGTAACGTACGT")]
    jt, pt, codes = make(n, PATS, 4, (1500, 64 * 50, 7000), plant)
    want = jax_pairs(jt, codes, 2)
    count, got = kernel_model(codes, n, myers_tables(pt), EOS, 2, 64)
    assert {(p + 1, q) for p, q in got} == want and count == len(want)
