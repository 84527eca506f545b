"""A numpy model of the slot gate kernel's schedule (``csrc/gate_slots.cu``)
against the plain version and the JAX package's gate.

The kernel cannot run here, so its data flow is modelled step for step:
each thread walks its slots grid-stride (i, i + s, ...), with the next
three in flight as the kernel keeps them (slot i + s: its 32-byte seed
record from :func:`seed_records` applied and its first four window codes
loaded, clamped into [0, n) with the sentinel applied at use; i + 2 s: its
record loaded; i + 3 s: the slot read); a slot's rows run the band-B row
of exactly 2 B + 1 cells over a sliding window of codes (one new code a
row, fetched a row ahead past the first four) or, at B = 0, one mismatch
count; an accept word past row 5 comes from the gate bits a row ahead.
Its survivors (anchor, sid) and true count are held against
``gate_slots_ref`` and the JAX ``_gate_ok`` at k = 0 to 3 with and without
indels, on slot rows in census order (hits grouped by tile, tiles cut
across threads), with windows at both text ends and across EOS, and at
cap 1.  (The file keeps its first name: a per-warp queue that refilled
lanes from the warp's batch was measured on the card and dropped,
PERF.md section 6.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.ops import gate as jax_gate
from sequence_alignment_tools_tpu_torch.ops.cuda.slots import (
    REC_ROWS,
    gate_slots,
    gate_slots_ref,
    scan_slots_ref,
    seed_records,
)
from sequence_alignment_tools_tpu_torch.ops.gate import GateTables
from test_torch_seed_gate import seed_tables
from test_torch_slots import mer_scanner, pairs

TABLE = b"ACGT\n"
EOS = 4
SENTINEL = 30
PRE = 4  # window codes fetched with a batch


def miss(acc, c):
    return 1 - ((acc >> min(c, 31)) & 1)


def band_row(D, win, acc, p, inf, B):
    """gate.cuh's band_row: row p of the banded DP, in place."""
    W = 2 * B + 1
    prev = inf
    rowmin = inf
    for d in range(W):
        nxt = D[d + 1] if d + 1 < W else inf
        v = D[d] + miss(acc, win[d])
        if d + 1 < W:
            v = min(v, nxt + 1)
        if d > 0:
            v = min(v, prev + 1)
        if d < B:
            t = p + d - B
            if t == 0:
                v = nxt + 1
            if t < 0:
                v = inf
        v = min(v, inf)
        D[d] = v
        prev = v
        rowmin = min(rowmin, v)
    return rowmin


class Slot:
    """A slot in the kernel's pipeline (the registers of one stage)."""

    def __init__(self):
        self.start, self.sid = 0, -1
        self.rec = [0] * 8
        self.raw = [0] * PRE
        self.inside = 0


def run_slot(cur, codes, n, bits, B, k):
    """The rows of one slot as the kernel runs them: True when it
    passes."""
    inf = k + 1
    anchor = cur.start + cur.rec[0]
    glen, gdir = cur.rec[1], cur.rec[2]
    base = anchor if gdir > 0 else anchor + gdir
    step = 1 if gdir > 0 else -1
    acc = [x & 0xFFFFFFFF for x in cur.rec[3:8]]
    pre = 0
    for j in range(PRE):
        pre |= (cur.raw[j] if (cur.inside >> j) & 1 else SENTINEL) << (8 * j)
    if glen == 0:
        return True

    def load(j):
        idx = base + step * j
        return int(codes[min(max(idx, 0), n - 1)]), 0 <= idx < n

    D = [min(d - B, inf) if d >= B else inf for d in range(2 * B + 1)]
    win = [SENTINEL] * (B + 1)
    for j in range(B):
        c, ok = load(j)
        win.append((pre >> (8 * j)) & 0xFF if j < PRE
                   else (c if ok else SENTINEL))
    nx = nx_in = accn = None
    if B >= PRE:
        nx, nx_in = load(B)
    miss_count = 0
    for p in range(1, glen + 1):
        j = p - 1 + B
        c = (pre >> (8 * j)) & 0xFF if j < PRE else (nx if nx_in
                                                      else SENTINEL)
        a = acc[p - 1] if p <= REC_ROWS else accn
        if p < glen:
            if j + 1 >= PRE:
                nx, nx_in = load(j + 1)
            if p >= REC_ROWS:
                accn = int(bits[cur.sid, p])
        if B == 0:
            miss_count += miss(a, c)
            rowmin = miss_count
        else:
            win = win[1:] + [c]
            rowmin = band_row(D, win, a, p, inf, B)
        if rowmin > k:
            return False
    return True


def model_gate_slots(codes, n, slots, rec, bits, Lg, k, band, cap, threads):
    """The kernel's survivors (anchor, sid), in emission order (threads
    in turn), and its true count."""
    cap_in = (len(slots) - 1) // 2
    live = min(int(slots[0]), cap_in)
    bits = bits.astype(np.uint32)

    def fetch_slot(x, i):
        x.sid = -1
        if i < live:
            x.start, x.sid = int(slots[1 + i]), int(slots[1 + cap_in + i])

    def fetch_rec(x):
        if x.sid >= 0:
            x.rec = [int(v) for v in rec[x.sid]]

    def fetch_codes(x):
        if x.sid >= 0:
            anchor = x.start + x.rec[0]
            base = anchor if x.rec[2] > 0 else anchor + x.rec[2]
            step = 1 if x.rec[2] > 0 else -1
            x.inside = 0
            for j in range(PRE):
                idx = base + step * j
                x.raw[j] = int(codes[min(max(idx, 0), n - 1)])
                x.inside |= int(0 <= idx < n) << j

    def copy(x):
        y = Slot()
        y.start, y.sid, y.rec = x.start, x.sid, list(x.rec)
        y.raw, y.inside = list(x.raw), x.inside
        return y

    emitted = []
    for i0 in range(threads):
        s1, s2, s3 = Slot(), Slot(), Slot()
        fetch_slot(s1, i0)
        fetch_slot(s2, i0 + threads)
        fetch_slot(s3, i0 + 2 * threads)
        fetch_rec(s1)
        fetch_rec(s2)
        fetch_codes(s1)
        for i in range(i0, live, threads):
            cur = copy(s1)
            s1 = copy(s2)
            fetch_codes(s1)
            s2 = copy(s3)
            fetch_rec(s2)
            s3 = Slot()
            fetch_slot(s3, i + 3 * threads)
            if run_slot(cur, codes, n, bits, band, k):
                emitted.append((cur.start + cur.rec[0], cur.sid))
    return emitted[:cap], len(emitted)


def census_order(row, tile, seed):
    """The slots of a plain row in census order: grouped by tile of
    ``tile`` starts, tiles in a random order, hits in a random order
    within their tile (the kernel's staging order is free)."""
    rng = np.random.default_rng(seed)
    cap = (row.numel() - 1) // 2
    prs = pairs(row)
    by_tile = {}
    for t, s in prs:
        by_tile.setdefault(t // tile, []).append((t, s))
    out = []
    for key in rng.permutation(sorted(by_tile)):
        hits = by_tile[int(key)]
        out += [hits[i] for i in rng.permutation(len(hits))]
    new = torch.zeros_like(row)
    new[0] = row[0]
    m = len(out)
    new[1 : 1 + m] = torch.tensor([t for t, _ in out], dtype=torch.int32)
    new[1 + cap : 1 + cap + m] = torch.tensor([s for _, s in out],
                                              dtype=torch.int32)
    return new


@pytest.fixture(scope="module")
def gate_case():
    """6,000 positions of random ACGT with EOS every 700, 48 random
    4-base seeds (two at each text end, their windows reaching past it),
    extensions of 3 to 9 bases both ways, the slot row in census order
    over tiles of 256 starts."""
    rng = np.random.default_rng(47)
    n = 6_000
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[::700] = EOS
    seeds = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=4))
             for _ in range(48)]
    # lmatch seeds (even) read right, rmatch seeds (odd) left: windows
    # past both ends
    for at, s in ((0, seeds[1]), (5, seeds[3]), (n - 4, seeds[0]),
                  (n - 9, seeds[2])):
        codes[at : at + 4] = [TABLE.index(c.encode()) for c in s]
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["e1"])
    exts = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
            for ln in rng.integers(3, 10, size=48)]
    # the end plants' extensions accept only the text's end codes, so a
    # window read past an end must see the sentinel to miss
    exts[0], exts[1] = seeds[0][-1] * 4, seeds[1][0] * 4
    dirs = np.asarray([1, -1] * 24, np.int32)
    offs = np.where(dirs > 0, 0, 4).astype(np.int32)
    _sc, mt = mer_scanner(seed_tables(db, seeds))
    tcodes = torch.from_numpy(codes)
    row = census_order(scan_slots_ref(tcodes, n, mt, 1 << 12), 256, 5)
    return db, tcodes, mt, row, exts, dirs, offs


CASES = [(k, indels) for k in range(4) for indels in (True, False)]


@pytest.mark.parametrize("k,indels", CASES,
                         ids=[f"k{k}-{'indels' if i else 'subs'}"
                              for k, i in CASES])
def test_queue_model_matches_plain_and_jax(gate_case, k, indels):
    db, codes, mt, row, exts, dirs, offs = gate_case
    n = len(codes)
    band = k if indels else 0
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, k, band, False,
                                   False)
    jt = jax_gate.GateTables.from_seed_meta(db, exts, dirs, offs, k, band,
                                            False, False)
    rec = seed_records(mt.lengths, gt).numpy()
    live = int(row[0])
    assert live > 1_000 and live % 32 != 0
    want = gate_slots_ref(codes, n, row, mt.lengths, gt, indels, 1 << 12)
    got, count = model_gate_slots(db.codes, n, row.numpy(), rec,
                                  gt.bits_np, gt.Lg, k, band, 1 << 12, 37)
    assert count == len(got) == int(want[0]) > 0
    assert sorted(got) == pairs(want)
    # the JAX gate on every slot
    starts = row[1 : 1 + live].long()
    sids = row[1 + (row.numel() - 1) // 2 :][:live].long()
    anchors = (starts + mt.lengths[sids].long()).numpy()
    ok = np.asarray(jax_gate.ExtendGate(jt, indels)(
        jnp.asarray(db.codes), anchors, sids.numpy().astype(np.int32)))
    assert sorted(got) == sorted(zip(anchors[ok].tolist(),
                                     sids.numpy()[ok].tolist()))
    # the wrapper's plain version on the same row, and windows at the ends
    assert pairs(gate_slots(codes, n, row, mt.lengths, gt, indels,
                            1 << 12)) == pairs(want)
    ends = {a for a, _s in got} | {a for a in anchors}
    assert min(ends) <= 8 and max(ends) >= n - 1
    # cap 1: the true count, one survivor
    one, count1 = model_gate_slots(db.codes, n, row.numpy(), rec,
                                   gt.bits_np, gt.Lg, k, band, 1, 300)
    assert count1 == count and len(one) == 1 and one[0] in set(got)


def test_seed_records_layout(gate_case):
    db, _codes, mt, _row, exts, dirs, offs = gate_case
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, 1, 1, False, False)
    rec = seed_records(mt.lengths, gt)
    assert rec.dtype == torch.int32 and rec.shape == (len(exts), 8)
    assert rec.is_contiguous() and rec.data_ptr() % 16 == 0
    assert torch.equal(rec[:, 0], mt.lengths)
    assert torch.equal(rec[:, 1], gt.glen) and torch.equal(rec[:, 2],
                                                           gt.gdir)
    assert torch.equal(rec[:, 3:8], gt.bits[:, :REC_ROWS])
    assert seed_records(mt.lengths, gt) is rec  # built once
    short = GateTables(np.ones((2, 3, 5), bool), np.array([3, 2]),
                       np.array([1, -1]), np.array([0, 4]), 1, 1)
    srec = seed_records(torch.tensor([4, 4], dtype=torch.int32), short)
    assert torch.equal(srec[:, 3:6], short.bits) and srec[:, 6:].eq(0).all()
