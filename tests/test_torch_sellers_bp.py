"""The block bit-parallel form of ``csrc/sellers.cu``, modelled on the CPU.

The CUDA kernel cannot run here, so its recurrence is written out below
exactly as one thread of it runs, in 32-bit words: Myers' block
recurrence with the active-word cutoff (indels), or bit-sliced saturating
mismatch counters (no indels); the EOS rule (a fresh column at every EOS
and at the warm-up start, only row 1 matching on the first character
after it, nothing reported at the EOS); ragged lengths read at each
pattern's own top bit; the text cut into segments with a warm-up halo of
Lmax + k rounded up to 32 characters, text outside [0, n) read as EOS.
The model runs on the kernel's own accept words (``SellersTables.peq``)
and is held against ``sellers_ref`` (the plain version) on 25 shapes and
against the JAX scanner on four (its XLA block DP on three, its Pallas
kernel in interpret mode on one).  Tolerance 0: every quantity is an integer.
The kernel itself is held against ``sellers_ref`` on the card by the
``cuda``-marked cases of ``tests/test_torch_sellers.py``.
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.ops.sellers import (
    SellersScanner as JaxSellers,
)
from sequence_alignment_tools_tpu_torch.ops.cuda.sellers import (
    SellersTables,
    peq_words,
    sellers_ref,
    sellers_tables,
)
from test_torch_sellers import EOS, both_tables, text_db, triples

M32 = 0xFFFFFFFF
CAP = 1 << 16


def advance(P, M, eq, hin, hmask):
    """One word of Myers' block recurrence (csrc/sellers.cu::advance)."""
    xv = eq | M
    if hin < 0:
        eq |= 1
    xh = ((((eq & P) + P) & M32) ^ P) | eq
    ph = M | (~(xh | P) & M32)
    mh = P & xh
    hout = 1 if ph & hmask else (-1 if mh & hmask else 0)
    ph = ((ph << 1) & M32) | int(hin > 0)
    mh = ((mh << 1) & M32) | int(hin < 0)
    return mh | (~(xv | ph) & M32), ph & xv, hout


def lane_indels(txt, start, own0, n, peq, m, alpha, eos, k, p, out):
    """One thread with indels over ``txt`` (text from ``start``)."""
    W, top = (m + 31) >> 5, (m - 1) & 31

    def hmask(b):
        return 1 << top if b == W - 1 else 1 << 31

    def rows(b):
        return top + 1 if b == W - 1 else 32

    y0 = min(W - 1, max(-(-k // 32), 1) - 1)
    sy0 = 32 * y0 + rows(y0)
    Pv, Mv = [M32] * W, [0] * W
    y, sy, first = y0, sy0, True
    for i, c in enumerate(txt):
        if c == eos:
            Pv[: y0 + 1], Mv[: y0 + 1] = [M32] * (y0 + 1), [0] * (y0 + 1)
            y, sy, first = y0, sy0, True
            continue
        col = peq[:, min(c, alpha)]
        carry = 0
        for b in range(y + 1):
            eq = (col[0] & 1 if b == 0 else 0) if first else col[b]
            Pv[b], Mv[b], carry = advance(Pv[b], Mv[b], eq, carry, hmask(b))
        sy += carry
        if y < W - 1 and sy - carry <= k:
            eq = 0 if first else col[y + 1]
            if eq & 1 or carry < 0:
                y += 1
                sy += rows(y) - carry
                Pv[y], Mv[y], c2 = advance(M32, 0, eq, carry, hmask(y))
                sy += c2
        while y > 0 and sy >= k + 32:
            rm = (1 << rows(y)) - 1
            sy -= bin(Pv[y] & rm).count("1") - bin(Mv[y] & rm).count("1")
            y -= 1
        first = False
        pos = start + i
        if y == W - 1 and sy <= k and own0 <= pos < n:
            out.add((pos, p, sy))


def lane_counts(txt, start, own0, n, peq, m, alpha, eos, k, p, out):
    """One thread without indels: q bit planes of saturating counters."""
    W, top = (m + 31) >> 5, (m - 1) & 31
    s = k + 1
    q = next(q for q in (1, 2, 4, 8) if s < 1 << q)  # planes past s: zero

    def fresh():
        return [M32 if (s >> i) & 1 else 0 for i in range(q)]

    def saturated(pl):
        e = M32
        for i in range(q):
            e &= pl[i] if (s >> i) & 1 else ~pl[i] & M32
        return e

    def step(pl, cin, mis):
        """csrc/sellers.cu::count_step: returns the bits that left."""
        left = [(pl[i] >> 31) & 1 for i in range(q)]
        for i in range(q):
            pl[i] = ((pl[i] << 1) & M32) | cin[i]
        cr = mis & ~saturated(pl) & M32
        for i in range(q):
            pl[i], cr = pl[i] ^ cr, pl[i] & cr
        return left

    def value(pl):
        return sum(((pl[i] >> top) & 1) << i for i in range(q))

    pls = [fresh() for _ in range(W)]
    y = 0
    for i, c in enumerate(txt):
        if c == eos:
            pls[0], y = fresh(), 0
            continue
        col = peq[:, min(c, alpha)]
        cin = [0] * q
        for b in range(y + 1):
            cin = step(pls[b], cin, ~col[b] & M32)
        if y < W - 1 and sum(cin[i] << i for i in range(q)) < s:
            y += 1  # row 1 of the next word takes word y's old bottom
            pls[y] = fresh()
            step(pls[y], cin, ~col[y] & M32)
        while y > 0:
            rm = M32 if y < W - 1 else (1 << (top + 1)) - 1
            if saturated(pls[y]) & rm != rm:
                break
            y -= 1
        pos = start + i
        if y == W - 1 and value(pls[y]) <= k and own0 <= pos < n:
            out.add((pos, p, value(pls[y])))


def model(codes, n, st, eos, k, indels, segc):
    """{(pos, p, d)} of the kernel's recurrence over ``codes[:n]``, one
    thread per (segment of ``segc`` positions, pattern)."""
    halo = -(-(st.Lmax + k) // 32) * 32
    peq = st.peq.numpy().view(np.uint32).astype(np.int64)
    lens = st.lens.numpy()
    lane = lane_indels if indels else lane_counts
    out = set()
    for own0 in range(0, n, segc):
        start = own0 - halo
        txt = [int(codes[x]) if 0 <= x < n else eos
               for x in range(start, own0 + segc)]
        for p in range(st.P):
            lane(txt, start, own0, n, peq[p], int(lens[p]),
                 st.alpha, eos, k, p, out)
    return out


def ref_triples(codes, n, st, eos, k, indels):
    row = sellers_ref(torch.from_numpy(codes), n, st, eos, k, indels, CAP)
    assert int(row[0]) <= CAP
    return {(e - 1, p, d) for e, p, d in triples(row)}


def random_tables(rng, lens, alpha, amb=0.0):
    """SellersTables of random patterns over codes [0, alpha - 1) (the
    last code is EOS), each position accepting one code, or with
    probability ``amb`` one to three more (IUPAC-like classes)."""
    Lmax, aw = max(lens), -(-alpha // 32)
    acc = np.zeros((len(lens), Lmax, aw), np.uint32)
    for p, m in enumerate(lens):
        for j in range(m):
            extra = int(rng.integers(1, 4)) if rng.random() < amb else 0
            for c in rng.integers(0, alpha - 1, size=1 + extra):
                acc[p, j, c >> 5] |= np.uint32(1 << (int(c) & 31))
    return SellersTables(torch.from_numpy(acc.view(np.int32)),
                         torch.from_numpy(np.asarray(lens, np.int32)), alpha)


def plant(rng, codes, st, count, edits):
    """Write ``count`` copies of random patterns (an accepted code per
    position, ``edits`` of them changed) into the text."""
    acc = st.acc.numpy().view(np.uint32)
    for _ in range(count):
        p = int(rng.integers(0, st.P))
        m = int(st.lens[p])
        if m + 2 >= len(codes):
            continue
        at = int(rng.integers(1, len(codes) - m))
        for j in range(m):
            ok = [c for c in range(st.alpha)
                  if (acc[p, j, c >> 5] >> (c & 31)) & 1]
            codes[at + j] = ok[int(rng.integers(0, len(ok)))]
        for _e in range(edits):
            codes[at + int(rng.integers(0, m))] = rng.integers(
                0, st.alpha - 1)


# (k, indels, pattern lengths, alphabet, share of EOS, planted edits,
# segment length, ambiguous share)
SHAPES = {
    "k0": (0, True, [20, 33, 40], 5, 0.03, 0, 64, 0.0),
    "k1": (1, True, [32, 36, 40], 5, 0.03, 1, 64, 0.0),
    "k2": (2, True, [33, 40, 40, 38], 5, 0.03, 2, 96, 0.0),
    "k3": (3, True, [25, 45], 5, 0.05, 2, 64, 0.0),
    "k4": (4, True, [40, 31], 5, 0.05, 3, 128, 0.0),
    "k>=m": (4, True, [1, 2, 3, 4, 5], 5, 0.2, 1, 64, 0.0),
    "k>=m, short entries": (3, True, [1, 2, 3], 5, 0.4, 0, 32, 0.0),
    "m 60 to 100": (2, True, [60, 64, 65, 96, 100], 5, 0.01, 2, 256, 0.0),
    "m 1 to 100": (2, True, [1, 7, 31, 32, 33, 63, 64, 99, 100], 5, 0.02, 1,
                   256, 0.0),
    "m 64, k 4": (4, True, [64, 64], 5, 0.02, 2, 64, 0.0),
    "no indels k0": (0, False, [20, 40], 5, 0.03, 0, 64, 0.0),
    "no indels k1": (1, False, [33, 40], 5, 0.03, 1, 64, 0.0),
    "no indels k2": (2, False, [36, 64, 65], 5, 0.03, 2, 96, 0.0),
    "no indels k4": (4, False, [40, 70], 5, 0.03, 3, 128, 0.0),
    "no indels k>=m": (3, False, [1, 2, 3, 6], 5, 0.2, 1, 64, 0.0),
    "no indels m 1 to 100": (2, False, [1, 31, 32, 33, 99, 100], 5, 0.02, 1,
                             256, 0.0),
    "IUPAC classes": (2, True, [35, 40, 22], 16, 0.03, 2, 64, 0.3),
    "IUPAC classes, no indels": (2, False, [35, 40], 16, 0.03, 2, 64, 0.3),
    "41-code alphabet": (1, True, [34, 40, 12], 41, 0.03, 1, 64, 0.0),
    "41-code alphabet k3": (3, True, [50, 8], 41, 0.05, 2, 64, 0.1),
    "41-code alphabet, no indels": (2, False, [34, 40], 41, 0.03, 2, 64,
                                    0.0),
    "segments of 32": (2, True, [36, 40], 5, 0.02, 2, 32, 0.0),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_model_matches_plain(name):
    k, indels, lens, alpha, eos_share, edits, segc, amb = SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    st = random_tables(rng, lens, alpha, amb)
    n = 1500
    codes = rng.integers(0, alpha - 1, size=n).astype(np.uint8)
    plant(rng, codes, st, 12, edits)
    codes[rng.random(n) < eos_share] = alpha - 1
    want = ref_triples(codes, n, st, alpha - 1, k, indels)
    assert model(codes, n, st, alpha - 1, k, indels, segc) == want
    assert want


def test_eos_contract_acgtac():
    """Pattern ACGTAC at k = 1 on the text EOS CGTAC: Myers' column reset
    would report position 5 (the A deleted, d = 1); the Sellers row DP
    reports nothing, because its EOS column is (0, k + 1, ...).  The
    model masks the first character after the EOS to row 1 and agrees."""
    codes = np.array([EOS, 1, 2, 3, 0, 1], np.uint8)
    acc = np.zeros((1, 6, 1), np.uint32)
    for j, c in enumerate([0, 1, 2, 3, 0, 1]):
        acc[0, j, 0] = 1 << c
    st = SellersTables(torch.from_numpy(acc.view(np.int32)),
                       torch.tensor([6], dtype=torch.int32), 5)
    assert ref_triples(codes, 6, st, EOS, 1, True) == set()
    assert model(codes, 6, st, EOS, 1, True, 32) == set()
    # without the EOS the deletion counts: the model reports it too
    codes[0] = 3
    want = ref_triples(codes, 6, st, EOS, 1, True)
    assert (5, 0, 1) in want
    assert model(codes, 6, st, EOS, 1, True, 32) == want


@pytest.mark.parametrize("indels", [True, False])
def test_long_pattern(indels):
    """One pattern of 2,000 bases (63 words, the last ragged) aligned
    with the text with two edits, beside a short one: the aligned stretch
    walks every word."""
    rng = np.random.default_rng(77)
    n = 4500
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    long_p = codes[1200:3200].copy()
    long_p[[500, 1500]] = (long_p[[500, 1500]] + 1) % 4
    acc = np.zeros((2, 2000, 1), np.uint32)
    acc[0, np.arange(2000), 0] = 1 << long_p.astype(np.uint32)
    acc[1, np.arange(40), 0] = 1 << codes[4000:4040].astype(np.uint32)
    st = SellersTables(torch.from_numpy(acc.view(np.int32)),
                       torch.tensor([2000, 40], dtype=torch.int32), 5)
    codes[[600, 4300]] = EOS
    want = ref_triples(codes, n, st, EOS, 2, indels)
    assert {p for _pos, p, _d in want} == {0, 1}
    assert model(codes, n, st, EOS, 2, indels, 2048) == want


def test_peq_words():
    """``peq_words`` sets bit i of word b at code c exactly when position
    32 b + i accepts c, and nothing past a pattern's length or in the
    past-the-alphabet column."""
    rng = np.random.default_rng(5)
    st = random_tables(rng, [1, 31, 32, 33, 70], 41, 0.5)
    acc = st.acc.numpy().view(np.uint32)
    peq = st.peq.numpy().view(np.uint32)
    assert peq.shape == (5, 3, 42)
    assert not peq[:, :, 41].any()
    for p, m in enumerate(st.lens.tolist()):
        for j in range(96):
            for c in range(41):
                bit = (peq[p, j >> 5, c] >> (j & 31)) & 1
                want = j < m and (acc[p, j, c >> 5] >> (c & 31)) & 1
                assert bool(bit) == bool(want)
    np.testing.assert_array_equal(
        peq_words(st.acc.numpy(), st.lens.numpy(), 41).view(np.uint32), peq)


@pytest.mark.parametrize("k,indels", [(1, True), (2, True), (2, False)])
def test_model_matches_jax_scanner(k, indels):
    """The JAX scanner's triples (its XLA block DP) on EOS-sprinkled text
    with patterns cut from it, through the port's table builder."""
    n = 6000
    codes, kw = text_db(n, 40 + k, entries=5)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes)
    pats = [text[300:336], text[2000:2040], text[4100:4133], text[5000:5013]]
    jt, pt = both_tables(pats, kw)
    want = {(e - 1, p, d) for e, p, d in JaxSellers(
        jt, k=k, indels=indels, block=1 << 12).scan(codes)}
    got = model(codes, n, sellers_tables(pt), EOS, k, indels, 512)
    assert got == want and len({p for _e, p, _d in want}) >= 4


def test_model_matches_jax_kernel():
    """The JAX Pallas Sellers kernel in interpret mode: the same
    (end, pattern) set."""
    n = 4096 + 300
    codes, kw = text_db(n, 9, entries=3)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes)
    pats = [text[100:135], text[3000:3036]]
    pats.append(pats[0][:10] + "T" + pats[0][11:])
    jt, pt = both_tables(pats, kw)
    sc = JaxSellers(jt, k=2, indels=True)
    sc.pallas_interpret = True
    ends, pids = sc.scan_pairs(codes)
    want = set(zip(ends.tolist(), pids.tolist()))
    got = model(codes, n, sellers_tables(pt), EOS, 2, True, 1024)
    assert {(pos + 1, p) for pos, p, _d in got} == want and want
