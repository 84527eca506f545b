"""The scan filter's host side: ``filter_tables`` and the word recurrence.

``csrc/scan_filter.cu`` scores 32 window starts per word operation over
the operands of ``filter_tables`` (accept and kill classes per pattern
position, jend, kp, the poison flag).  The kernel cannot run on the CPU,
so this file holds a numpy model of its recurrence (class masks per
32-position word, funnel shift by the position, AND for kp = 0, a
bit-sliced miss counter that kills at kp + 1, kill masks) and requires it
to equal ``scan_occupancy_ref`` bit for bit on every case: literal DNA,
IUPAC under ``-w``, ``-K 1`` / ``-K 2`` poisoned, a 41-code alphabet,
Lmax 1, 33, 64 and 200 (2, 4 and 16 counter planes), thresholds <= 0 and
above every score, a position with an empty accept set, P = 2048, the
per-code mask rows, EOS-dense text whose length is not a multiple of 32,
and texts of 1 and 33 positions.  Weights outside the 0/1 + poison form raise ``ValueError``.  The
same cases run the CUDA kernel against the plain version on the card
(``tests/test_torch_scan_kernel.py``, marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
    filter_tables,
    scan_occupancy_ref,
)
from sequence_alignment_tools_tpu_torch.ops.tables import (
    build_tables,
    device_tables,
)

DNA = b"ACGT\n"
IUPAC = b"ACGTRYSWKMBDHVN\n"
WIDE = b"ACDEFGHIKLMNPQRSTVWYBJOUXZ0123456789*-+.\n"  # 41 codes


def make_db(table, n, seed, eos_every=0, letters=None):
    """Random codes over ``table`` (EOS last), EOS every ``eos_every``
    positions on average (0: three entries); returns (db, text)."""
    rng = np.random.default_rng(seed)
    eos = len(table) - 1
    hi = letters or eos
    codes = rng.integers(0, hi, size=n).astype(np.uint8)
    if eos_every:
        codes[rng.random(n) < 1.0 / eos_every] = eos
    else:
        codes[[0, n // 3, 2 * n // 3]] = eos
    db = SeqDB(codes=codes, table=table, entry_starts=np.array([1]),
               entry_lengths=np.array([n - 1]), headers=["f"])
    text = "".join(chr(table[c]) if c != eos else "A" for c in codes)
    return db, text


def cut(text, rng, count, lo, hi, plant_edits=0):
    """``count`` patterns cut from ``text`` (lengths lo..hi), a few with
    substitutions drawn from the text's own letters."""
    letters = sorted(set(text))
    out = []
    for i in range(count):
        ln = int(rng.integers(lo, hi + 1))
        at = int(rng.integers(0, len(text) - ln))
        p = list(text[at : at + ln])
        for _ in range(plant_edits if i % 2 else 0):
            j = int(rng.integers(0, ln))
            p[j] = letters[int(rng.integers(0, len(letters)))]
        out.append("".join(p))
    return out


def dt_case(table, n, seed, pats, k, poison, wc=False, rev_comp=False,
            eos_every=0, letters=None, n_cut=0):
    db, _ = make_db(table, n, seed, eos_every, letters)
    t = build_tables(build_pattern_set(pats, rev_comp=rev_comp), db, wc=wc,
                     textn=False)
    dt = device_tables(t, k, poison, "cpu")
    return (torch.from_numpy(db.codes), n - n_cut, int(db.eos_code),
            dt.weights16, dt.thresholds)


def _text(table, n, seed, eos_every=0, letters=None):
    return make_db(table, n, seed, eos_every, letters)[1]


def case_inputs(name):
    """(codes, n, eos, w int16 [Lmax, alpha, P], thr int32 [P]) of one
    named case, all on the CPU, made from fixed seeds."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "literal DNA":
        pats = cut(_text(DNA, 1 << 14, 1), rng, 12, 13, 18)
        return dt_case(DNA, 1 << 14, 1, pats, 0, False, rev_comp=True)
    if name == "-K 1 poisoned":
        pats = cut(_text(DNA, 1 << 14, 2), rng, 10, 13, 18, 1)
        return dt_case(DNA, 1 << 14, 2, pats, 1, True, rev_comp=True,
                       eos_every=300)
    if name == "-K 2 poisoned":
        pats = cut(_text(DNA, 1 << 14, 3), rng, 10, 13, 18, 2)
        return dt_case(DNA, 1 << 14, 3, pats, 2, True, rev_comp=True,
                       eos_every=300)
    if name == "IUPAC -w":
        text = _text(IUPAC, 1 << 14, 4, letters=15)
        pats = cut(text, rng, 8, 12, 16) + ["ACGRYTNNSWKT", "NNNNACGTNN"]
        return dt_case(IUPAC, 1 << 14, 4, pats, 0, False, wc=True,
                       letters=15)
    if name == "IUPAC -w, k=1 poisoned":
        text = _text(IUPAC, 1 << 14, 5, letters=15)
        pats = cut(text, rng, 8, 12, 16, 1) + ["ACGRYTNNSWKT"]
        return dt_case(IUPAC, 1 << 14, 5, pats, 1, True, wc=True,
                       letters=15, eos_every=500)
    if name == "wide alphabet (41 codes)":
        pats = cut(_text(WIDE, 1 << 14, 6), rng, 12, 5, 9, 1)
        return dt_case(WIDE, 1 << 14, 6, pats, 0, False)
    if name == "wide alphabet, k=1 poisoned":
        pats = cut(_text(WIDE, 1 << 14, 7), rng, 12, 5, 9, 1)
        return dt_case(WIDE, 1 << 14, 7, pats, 1, True, eos_every=200)
    if name == "Lmax 1":
        return dt_case(DNA, 1 << 12, 8, ["A", "G"], 0, False)
    if name == "Lmax 33, k=3 poisoned":
        pats = cut(_text(DNA, 1 << 14, 9), rng, 6, 25, 33, 3)
        return dt_case(DNA, 1 << 14, 9, pats, 3, True, rev_comp=True)
    if name == "Lmax 200, k=20 poisoned":
        pats = cut(_text(DNA, 1 << 14, 10), rng, 4, 150, 200, 15)
        return dt_case(DNA, 1 << 14, 10, pats, 20, True, eos_every=3000)
    if name == "Lmax 200, k=0":
        pats = cut(_text(DNA, 1 << 14, 11), rng, 4, 150, 200)
        return dt_case(DNA, 1 << 14, 11, pats, 0, False)
    if name == "thr <= 0":
        pats = cut(_text(DNA, 1 << 12, 12), rng, 3, 8, 12)
        return dt_case(DNA, 1 << 12, 12, pats, 14, False)
    if name == "thr <= 0, poisoned, EOS-dense":
        pats = cut(_text(DNA, 1 << 12, 13), rng, 3, 10, 12)
        return dt_case(DNA, 1 << 12, 13, pats, 14, True, eos_every=3)
    if name == "empty accept set":
        text = _text(DNA, 1 << 13, 14)
        p = text[3000:3012]
        pats = [p[:5] + "Z" + p[6:], "ACGTZZACGT"]
        return dt_case(DNA, 1 << 13, 14, pats, 1, False)
    if name == "P=2048":
        pats = cut(_text(DNA, 1 << 13, 15), rng, 2048, 10, 20, 1)
        return dt_case(DNA, 1 << 13, 15, pats, 0, False)
    if name == "odd n, EOS-dense":
        pats = cut(_text(DNA, 1 << 14, 16), rng, 10, 8, 12, 1)
        return dt_case(DNA, 1 << 14, 16, pats, 1, True, rev_comp=True,
                       eos_every=25, n_cut=13)
    if name == "IUPAC -w, -K 2 poisoned":
        text = _text(IUPAC, 1 << 14, 18, letters=15)
        pats = cut(text, rng, 8, 12, 16, 2)
        return dt_case(IUPAC, 1 << 14, 18, pats, 2, True, wc=True,
                       letters=15, eos_every=400)
    if name == "wide alphabet, -K 2 poisoned":
        pats = cut(_text(WIDE, 1 << 14, 19), rng, 12, 6, 10, 2)
        return dt_case(WIDE, 1 << 14, 19, pats, 2, True, eos_every=300)
    if name == "Lmax 64, k=8 poisoned":
        pats = cut(_text(DNA, 1 << 14, 20), rng, 6, 40, 64, 6)
        return dt_case(DNA, 1 << 14, 20, pats, 8, True, rev_comp=True,
                       eos_every=2000)
    if name == "P=2048, -K 2 poisoned":
        pats = cut(_text(DNA, 1 << 12, 21), rng, 2048, 12, 20, 2)
        return dt_case(DNA, 1 << 12, 21, pats, 2, True, eos_every=500)
    if name == "no pattern can hit (thr > len)":
        pats = cut(_text(DNA, 1 << 12, 22), rng, 6, 8, 12)
        return dt_case(DNA, 1 << 12, 22, pats, -1, False)
    if name == "n=1":
        pats = ["A", "C", "GT"]
        return dt_case(DNA, 64, 23, pats, 0, False, n_cut=63)
    if name == "n=33, Lmax 40, k=1 poisoned":
        pats = cut(_text(DNA, 64, 24), rng, 4, 30, 40, 1)
        return dt_case(DNA, 64, 24, pats, 1, True, n_cut=31)
    if name == "per-code rows, k=2 poisoned":
        db, _ = make_db(WIDE, 1 << 13, 25, letters=40)
        Lmax, alpha, P = 12, len(WIDE), 40
        w = (rng.random((Lmax, alpha, P)) < 0.3).astype(np.int16)
        w[:, alpha - 1, :] = -(Lmax + 3)
        thr = np.full(P, Lmax - 2, np.int32)
        return (torch.from_numpy(db.codes), (1 << 13) - 5, alpha - 1,
                torch.from_numpy(w), torch.from_numpy(thr))
    if name == "per-code rows (random accept sets)":
        db, _ = make_db(WIDE, 1 << 13, 17, letters=40)
        Lmax, alpha, P = 10, len(WIDE), 60
        w = (rng.random((Lmax, alpha, P)) < 0.3).astype(np.int16)
        w[:, alpha - 1, :] = 0
        thr = np.full(P, Lmax - 1, np.int32)
        return (torch.from_numpy(db.codes), 1 << 13, alpha - 1,
                torch.from_numpy(w), torch.from_numpy(thr))
    raise KeyError(name)


CASES = ["literal DNA", "-K 1 poisoned", "-K 2 poisoned", "IUPAC -w",
         "IUPAC -w, k=1 poisoned", "wide alphabet (41 codes)",
         "wide alphabet, k=1 poisoned", "Lmax 1", "Lmax 33, k=3 poisoned",
         "Lmax 200, k=20 poisoned", "Lmax 200, k=0", "thr <= 0",
         "thr <= 0, poisoned, EOS-dense", "empty accept set", "P=2048",
         "odd n, EOS-dense", "per-code rows (random accept sets)",
         "IUPAC -w, -K 2 poisoned", "wide alphabet, -K 2 poisoned",
         "Lmax 64, k=8 poisoned", "P=2048, -K 2 poisoned",
         "no pattern can hit (thr > len)", "n=1",
         "n=33, Lmax 40, k=1 poisoned", "per-code rows, k=2 poisoned"]


def word_model(ft, codes, n, eos):
    """numpy model of ``scan_filter.cu``'s recurrence: occ [nmb] bool.

    Per class and position j one 32-bit word per microblock (bit b: the
    code at 32 m + b + j lies in the class, text past n read as eos), then
    per pattern an alive word per microblock: ANDed with the accept words
    (kp = 0), or a bit-sliced miss counter that kills a start at kp + 1;
    kill words clear starts; kp < 0 never hits, kp >= jend only kills.
    Vectorised over patterns; no early exit (it changes no result)."""
    bits = ft.bits.numpy().view(np.uint32)
    ent = ft.ent.numpy().astype(np.int64)
    pat = ft.pat.numpy().astype(np.int64)
    P, J = ft.P, ft.J
    nmb = max(-(-n // 32), 1)
    text = np.full(nmb * 32 + J + 32, eos, np.int64)
    text[:n] = codes[:n]
    member = ((bits[:, text >> 5] >> (text & 31)) & 1).astype(bool)
    if ft.direct:
        cls = member
    else:
        off = ft.cls_off.numpy()
        rows = ft.cls_rows.numpy()
        cls = np.stack([member[rows[off[c] : off[c + 1]]].any(axis=0)
                        for c in range(len(off) - 1)]) if len(off) > 1 \
            else np.zeros((0, len(text)), bool)
    C = len(cls)
    words = np.zeros((C + 1, max(J, 1), nmb), np.uint32)  # row C: empty
    for j in range(J):
        seg = cls[:, j : j + nmb * 32].reshape(C, nmb, 32)
        words[:C, j] = (seg.astype(np.uint64) << np.arange(
            32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    jend = pat[:, 0] & 0xFFFF
    poison = ((pat[:, 0] >> 16) & 1).astype(bool)
    kp = pat[:, 1]
    acc_id = np.where(ent[..., 0] < 0, C, ent[..., 0]) if J else ent[..., 0]
    kill_id = np.where(ent[..., 1] < 0, C, ent[..., 1]) if J else ent[..., 1]
    and_mode = kp == 0
    count_mode = (kp > 0) & (kp < jend)
    top = (kp + 1).astype(np.uint64)
    planes = max((int(t).bit_length() for t in top[count_mode]), default=1)
    c = np.zeros((planes, P, nmb), np.uint32)
    alive = np.full((P, nmb), 0xFFFFFFFF, np.uint32)
    full = np.uint32(0xFFFFFFFF)
    for j in range(J):
        act = (j < jend)[:, None]
        a = words[acc_id[:, j], j]
        kw = words[kill_id[:, j], j]
        alive = np.where(act & poison[:, None], alive & ~kw, alive)
        alive = np.where(act & and_mode[:, None], alive & a, alive)
        carry = ~a & alive
        at_top = np.full((P, nmb), full, np.uint32)
        for i in range(planes):
            t = c[i] & carry
            c[i] ^= carry
            carry = t
            bit = ((top >> np.uint64(i)) & np.uint64(1)).astype(bool)
            at_top &= np.where(bit[:, None], c[i], ~c[i])
        alive = np.where(act & count_mode[:, None], alive & ~at_top, alive)
    hit = (kp >= 0)[:, None] & (alive != 0)
    return hit.any(axis=0)


@pytest.mark.parametrize("name", CASES)
def test_word_model_equals_plain(name):
    codes, n, eos, w, thr = case_inputs(name)
    ft = filter_tables(w, thr)
    assert filter_tables(w, thr) is ft  # built once per tensor pair
    want = scan_occupancy_ref(codes, w, thr, n, eos).numpy()
    got = word_model(ft, codes.numpy(), n, eos)
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    # every case decides something: neither all nor no microblocks, but
    # where the thresholds admit every window
    if name.startswith("thr <= 0") and "poisoned" not in name:
        assert want.all()
    elif name.startswith("no pattern"):
        assert not want.any()
    elif name not in ("Lmax 1", "n=1", "n=33, Lmax 40, k=1 poisoned"):
        assert want.any() and not want.all()


def test_tables_form():
    """Classes, jend, kp and the poison flag of a small set; the mask-row
    choice: one row per class while they are few, one per code past
    that."""
    _codes, _n, _eos, w, thr = case_inputs("-K 2 poisoned")
    ft = filter_tables(w, thr)
    wn = w.numpy()
    assert ft.direct and ft.R == 5  # A, C, G, T and the EOS kill set
    lengths = (wn[:, :4, :] == 1).any(axis=1).sum(axis=0)
    assert np.array_equal(ft.pat[:, 0].numpy() & 0xFFFF, lengths)
    assert ((ft.pat[:, 0].numpy() >> 16) == 1).all()
    assert np.array_equal(ft.pat[:, 1].numpy(), lengths - thr.numpy())
    bits = ft.bits.numpy().view(np.uint32)
    ent = ft.ent.numpy()
    for p in range(0, ft.P, 3):
        for j in range(ft.J):
            for col, want in ((0, wn[j, :, p] == 1), (1, wn[j, :, p] < 0)):
                cid = ent[p, j, col]
                got = np.zeros(wn.shape[1], bool) if cid < 0 else np.array(
                    [(bits[cid, c >> 5] >> (c & 31)) & 1
                     for c in range(wn.shape[1])], bool)
                assert np.array_equal(got, want)
    _c, _n, _e, w2, thr2 = case_inputs("per-code rows (random accept sets)")
    ft2 = filter_tables(w2, thr2)
    assert not ft2.direct and ft2.R <= 41 < len(ft2.cls_off) - 1


@pytest.mark.parametrize("bad", ["weight 2", "weak poison", "alphabet 300"])
def test_nonconforming_weights_raise(bad):
    _codes, _n, _eos, w, thr = case_inputs("-K 2 poisoned")
    w = w.clone()
    if bad == "weight 2":
        w[0, 0, 0] = 2
    elif bad == "weak poison":
        w[0, 4, 0] = -1  # a window with one EOS can still reach len - 2
    else:
        w = torch.zeros((4, 300, 2), dtype=torch.int16)
        thr = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        filter_tables(w, thr)
