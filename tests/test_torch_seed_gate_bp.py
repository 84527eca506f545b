"""A numpy model of the seed_gate kernel's bit-parallel enumeration and
warp queue against the plain version.

``csrc/seed_gate.cu`` does not score windows one start at a time: a warp
stages the text of M candidate microblocks (with a margin of Lg + band on
each side), builds one 32-bit mask per mask row of
``scan_kernel.filter_tables`` and 32-position word, and a seed's 32-start
hit word is the AND of its funnel-shifted class masks (a bit-sliced miss
counter where the seed allows misses).  Hits go into a per-warp queue of
64 entries, 32 at a time through the gate DP, each window read from the
staged text where it lies inside the current tile, else from device
memory.  :func:`kernel_model` repeats that (M = 8, the kernel's four
lanes per microblock over its seeds; and the layouts timed beside it,
M = 32, one lane per microblock, and M = 1, the lanes over the seeds),
checks the queue's
bound and that every staged read equals a read of the whole text, and is
held against ``seed_gate_ref`` (tolerance 0: the survivor sets and the
true count; with cap 1 the count and a kept survivor).  Cases: halves at
k = 1, ``-K 1`` (band 0), k = 2, bases with ``-3 8``, IUPAC seeds under
``-w``, seeds that straddle a microblock boundary or an EOS, 2,048 seeds,
and cap 1.  ``seed_gate_ref`` is held against the JAX package in
``tests/test_torch_seed_gate.py``.
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
)
from sequence_alignment_tools_tpu_torch.ops.compact import compact_mask
from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
    filter_tables,
    scan_occupancy,
)
from sequence_alignment_tools_tpu_torch.ops.cuda.seed_gate import (
    seed_gate_ref,
)
from sequence_alignment_tools_tpu_torch.ops.gate import gate_ok_ref
from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

TABLE = b"ACGT\n"
EOS = 4
M32 = (1 << 32) - 1
KNONE = -1     # no class (0xffffffff in the kernel)
OUT = 0xFF     # a staged position outside [0, n)
SENTINEL = 30  # gate.cuh's code outside [0, n)
PRIMERS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
           "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "TCATGAAGTAAAC",
           "TTGGCTGCTGCCCCCAG", "AGAAAAGGGGGAAA"]


def geometry(J, Lmax, Lg, band):
    """(Wq, E, hi) of ``seed_gate.cu``'s ``geometry``."""
    Wq = 2 + ((J - 1) >> 5 if J > 0 else 0)
    E = -(-min(Lg + band, 64) // 4) * 4
    return Wq, E, max(32 * Wq, 31 + Lmax + E)


def funnel(lo, hi, s):
    return ((hi << 32 | lo) >> s) & M32


class Warp:
    """One warp's shared state: staged text, mask rows, the queue."""

    def __init__(self, ft, codes, n, eos, Lmax, gt):
        self.ft, self.codes, self.n, self.eos = ft, codes, n, eos
        self.bits = ft.bits.numpy().astype(np.int64) & M32
        self.ent = ft.ent.numpy()
        self.pat = ft.pat.numpy()
        self.cls_off = ft.cls_off.numpy()
        self.cls_rows = ft.cls_rows.numpy()
        self.gt = gt
        self.Wq, self.E, self.hi = geometry(ft.J, Lmax, gt.Lg, gt.band)
        self.queue = []  # (anchor, sid, slot)
        self.peak = 0
        self.staged_reads = 0

    def stage(self, t0s):
        """Stage the tile's text and build its mask rows [R][Wq][M]."""
        self.t0s = t0s
        span = self.E + self.hi
        self.txt = []
        for t0 in t0s:
            pos = t0 - self.E + np.arange(span)
            row = np.full(span, OUT, np.int64)
            ok = (pos >= 0) & (pos < self.n) & (t0 >= 0)
            row[ok] = self.codes[pos[ok]]
            self.txt.append(row)
        R = len(self.bits)
        self.masks = np.zeros((R, self.Wq, len(t0s)), np.int64)
        for m, t0 in enumerate(t0s):
            if t0 < 0:
                continue
            for q in range(self.Wq):
                c = self.txt[m][self.E + 32 * q: self.E + 32 * q + 32].copy()
                c[c == OUT] = self.eos
                for r in range(R):
                    inset = (self.bits[r, c >> 5] >> (c & 31)) & 1
                    self.masks[r, q, m] = int((inset << np.arange(32)).sum())

    def class_mask(self, cls, j, m):
        if cls == KNONE:
            return 0
        q, s = j >> 5, j & 31
        rows = ([cls] if self.ft.direct else
                self.cls_rows[self.cls_off[cls]: self.cls_off[cls + 1]])
        out = 0
        for r in rows:
            out |= funnel(int(self.masks[r, q, m]),
                          int(self.masks[r, q + 1, m]), s)
        return out

    def seed_word(self, p, m):
        """The kernel's ``seed_word``: the 32-start hit word of seed p on
        microblock m (the counter planes as bit-sliced words)."""
        jend = int(self.pat[p, 0]) & 0xFFFF
        poison = (int(self.pat[p, 0]) >> 16) & 1
        kp = int(self.pat[p, 1])
        if kp < 0:
            return 0
        e = self.ent[p]
        alive = M32
        if kp >= jend:
            for j in range(jend):
                if poison:
                    alive &= ~self.class_mask(int(e[j, 1]), j, m) & M32
            return alive
        if kp == 0:
            for j in range(jend):
                alive &= self.class_mask(int(e[j, 0]), j, m)
                if not alive:
                    break
            return alive
        top = kp + 1
        b = top.bit_length()
        planes = [0] * b
        for j in range(jend):
            if not alive:
                break
            if poison:
                alive &= ~self.class_mask(int(e[j, 1]), j, m) & M32
            carry = ~self.class_mask(int(e[j, 0]), j, m) & alive & M32
            at_top = M32
            for i in range(b):
                t = planes[i] & carry
                planes[i] ^= carry
                carry = t
                at_top &= planes[i] if (top >> i) & 1 else ~planes[i] & M32
            alive &= ~at_top & M32
        return alive

    def window(self, anchor, sid, slot):
        """The gate window as the kernel reads it (staged text inside the
        current tile's microblock, else device memory), checked against a
        read of the whole text."""
        gdir = int(self.gt.gdir_np[sid])
        out = []
        for j in range(self.gt.Lg + self.gt.band):
            idx = anchor + j if gdir > 0 else anchor + gdir - j
            glob = int(self.codes[idx]) if 0 <= idx < self.n else SENTINEL
            c = glob
            if slot >= 0:
                off = idx - (self.t0s[slot] - self.E)
                if 0 <= off < self.E + self.hi:
                    c = int(self.txt[slot][off])
                    c = SENTINEL if c == OUT else c
                    self.staged_reads += 1
            assert c == glob
            out.append(c)
        return out

    def flush(self, cnt, indels, survivors):
        batch = self.queue[:cnt]
        self.queue = self.queue[cnt:]
        for a, s, sl in batch:
            self.window(a, s, sl)
        codes = torch.from_numpy(self.codes)
        a = torch.tensor([b[0] for b in batch], dtype=torch.long)
        s = torch.tensor([b[1] for b in batch], dtype=torch.long)
        ok = gate_ok_ref(codes, a, s, self.gt, indels, self.n)
        survivors += [(int(x), int(y)) for x, y, o in zip(a, s, ok) if o]

    def push(self, lanes, indels, survivors):
        """The ballot loop: lanes = [(hit word, t0, seed, len, slot)]."""
        hw = [ln[0] for ln in lanes]
        while any(hw):
            for lane, (w, (_, t0, s, ln, sl)) in enumerate(zip(hw, lanes)):
                if w:
                    b = (w & -w).bit_length() - 1
                    hw[lane] = w & (w - 1)
                    self.queue.append((t0 + b + ln, s, sl))
            self.peak = max(self.peak, len(self.queue))
            assert len(self.queue) < 64
            if len(self.queue) >= 32:
                self.flush(32, indels, survivors)


def kernel_model(codes, n, dt, mb_count, mb_idx, gt, eos, indels, cap, M):
    """(true count, kept survivors, warp) as ``csrc/seed_gate.cu``
    computes them with M microblocks per warp, one warp walking every
    tile in order."""
    ft = filter_tables(dt.weights16, dt.thresholds)
    Lmax = dt.weights16.shape[0]
    lengths = dt.lengths.numpy()
    live = min(int(mb_count), mb_idx.numel())
    idx = mb_idx.numpy()
    warp = Warp(ft, codes, n, eos, Lmax, gt)
    survivors = []
    P = ft.P
    per_mb = 32 // M
    for tile in range(-(-live // M)):
        for i in range(len(warp.queue)):  # earlier tiles: device memory
            a, s, _ = warp.queue[i]
            warp.queue[i] = (a, s, -1)
        t0s = [int(idx[tile * M + m]) * 32 if tile * M + m < live else -1
               for m in range(M)]
        warp.stage(t0s)
        for rd in range(-(-P // per_mb)):
            lanes = []
            for lane in range(32):
                m, s = lane % M, lane // M + rd * per_mb
                t0 = t0s[m]
                room = n - t0 if t0 >= 0 else 0
                valid = M32 if room >= 32 else (1 << max(room, 0)) - 1
                w = warp.seed_word(s, m) & valid if valid and s < P else 0
                lanes.append((w, t0, s, int(lengths[s]) if s < P else 0, m))
            warp.push(lanes, indels, survivors)
    if warp.queue:
        warp.flush(len(warp.queue), indels, survivors)
    return len(survivors), survivors[:cap], warp


def make_db(n, seed, eos_every=3000, plants=()):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for at, s in plants:
        codes[at: at + len(s)] = [TABLE.index(c.encode()) for c in s]
    codes[::eos_every] = EOS
    return SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
                 entry_lengths=np.array([n]), headers=["e1"])


def setup(db, pats, k, indels, wc=False, tplen=0, rev_comp=True, node=0):
    """(engine, seed tables, gate tables) of the port's pigeonhole engine
    on the CPU, as ``chip_smoke.py``'s ``gate_setup``."""
    ps = build_pattern_set(pats, rev_comp=rev_comp, tplen=tplen)
    m = PrimerMatchModel(db, ps, k=k, indels=indels, wc=wc, node=node,
                         device="cpu")
    if m.engine == "halves":
        _o, sc, _b, dirs, ext, geomB = m._halves_ctx()
    else:
        _o, _s, sc, _b, dirs, ext, geomB = m._bases_ctx()
    gate = m._engine_gate(sc, dirs, ext, geomB, lambda p0: p0 + 1)
    return m.engine, sc._tables_dev(), sc._gate_dev(gate)


def survivor_set(row, cap):
    row = row.numpy().astype(np.int64)
    m = min(int(row[0]), cap)
    return int(row[0]), set(zip(row[1: 1 + m].tolist(),
                                row[1 + cap: 1 + cap + m].tolist()))


def check(db, dt, gt, indels, M, cap=1 << 16, eos=EOS, n=None):
    codes = db.codes
    n = n or len(codes)
    ct = torch.from_numpy(codes)
    occ = scan_occupancy(ct, dt.weights16, dt.thresholds, n, eos)
    mb_count, mb_idx = compact_mask(occ, occ.numel())
    want_c, want = survivor_set(seed_gate_ref(
        ct, n, dt, mb_count, mb_idx, gt, eos, indels, 1 << 20), 1 << 20)
    count, kept, warp = kernel_model(codes, n, dt, mb_count, mb_idx, gt, eos,
                                     indels, cap, M)
    assert count == want_c > 0
    if cap >= want_c:
        assert set(kept) == want and len(kept) == count
    else:
        assert len(kept) == cap and set(kept) <= want
    assert warp.staged_reads > 0
    return warp


def variants(rng, pats):
    """Each primer and its reverse complement, exact and with one
    substitution, deletion or insertion."""
    out = []
    for p in pats:
        for s in (p, reverse_comp(p)):
            out.append(s)
            for kind in range(3):
                i = int(rng.integers(2, len(s) - 2))
                if kind == 0:
                    out.append(s[:i] + "ACGT"[("ACGT".index(s[i]) + 1) % 4]
                               + s[i + 1:])
                elif kind == 1:
                    out.append(s[:i] + s[i + 1:])
                else:
                    out.append(s[:i] + "G" + s[i:])
    return out


@pytest.fixture(scope="module")
def primer_db():
    """2^14 positions, EOS every 3,000, every primer variant planted;
    some plants straddle a microblock boundary (start 32 m - 5) and one
    is cut by an EOS."""
    rng = np.random.default_rng(21)
    plants = [(64 * (i + 2) * 3 + (27 if i % 2 else 0), v)
              for i, v in enumerate(variants(rng, PRIMERS))]
    plants.append((2990, PRIMERS[0]))  # cut by the EOS at 3000
    return make_db(1 << 14, 8, plants=plants)


@pytest.mark.parametrize("M", [32, 8, 1])
@pytest.mark.parametrize("name,k,indels,tplen,node", [
    ("halves k=1", 1, True, 0, 0), ("halves -K 1", 1, False, 0, 0),
    ("halves k=2", 2, True, 0, 11), ("bases k=1 -3 8", 1, True, 8, 0)])
def test_engines(primer_db, M, name, k, indels, tplen, node):
    engine, dt, gt = setup(primer_db, PRIMERS, k, indels, tplen=tplen,
                           node=node)
    assert engine == name.split()[0]
    if not indels:
        assert gt.band == 0
    warp = check(primer_db, dt, gt, indels, M)
    assert warp.peak >= 32  # the queue flushed during the tiles


def test_microblock_boundary_and_eos(primer_db):
    """Seeds that start 5 before a microblock ends (their windows span
    two microblocks), and the odd length n: the last microblock's starts
    past n are dropped."""
    _e, dt, gt = setup(primer_db, PRIMERS, 1, True)
    n = len(primer_db.codes) - 77
    check(primer_db, dt, gt, True, 32, n=n)


def test_iupac_seeds_under_w():
    """Degenerate primers over an IUPAC database (-w): classes of several
    codes, and N in the text."""
    rng = np.random.default_rng(4)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    n = 1 << 14
    base = rng.integers(0, 4, size=n)
    amb = rng.random(n) < 0.03
    base[amb] = rng.integers(4, 15, size=int(amb.sum()))
    seq = table[base].tobytes()
    db = SeqDB.from_entries([("w1", seq[: n // 2]), ("w2", seq[n // 2:])])
    text = seq.decode()
    pats = [text[i: i + 16] for i in range(500, n - 100, n // 6)]
    pats = [p.replace(p[5], "N", 1) if i % 2 else p
            for i, p in enumerate(pats)] + ["ACGRYTNNSWKTAC"]
    engine, dt, gt = setup(db, pats, 1, True, wc=True)
    assert engine == "halves"
    check(db, dt, gt, True, 32, eos=int(db.eos_code))


def test_2048_seeds():
    """1,024 primers, forward only: 2,048 half seeds."""
    rng = np.random.default_rng(5)
    db = make_db(1 << 13, 6)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in db.codes)
    pats = [text[i: i + int(ln)] for i, ln in
            zip(rng.integers(1, len(text) - 30, size=1024),
                rng.integers(14, 25, size=1024))]
    _e, dt, gt = setup(db, pats, 1, True, rev_comp=False)
    assert dt.lengths.numel() == 2048
    check(db, dt, gt, True, 32)


def test_cap_1(primer_db):
    _e, dt, gt = setup(primer_db, PRIMERS, 2, True, node=11)
    check(primer_db, dt, gt, True, 32, cap=1)
