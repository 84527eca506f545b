"""The seed-slot and slot-gate functions against the JAX package.

``scan_slots`` and ``gate_slots`` run their plain PyTorch versions on CPU
tensors.  All comparisons are exact (integer results, set equality):

- ``scan_slots_ref``, reduced per window start to (count, sum of seed
  ids), against the Pallas kernel ``pallas_scan_slots`` in interpret mode
  (the configurations of ``tests/test_slots_kernel.py`` and its poly-A
  overflow case), with the text window the TPU kernel packs beside a slot
  checked to be the text ``gate_slots`` reads;
- the census hash tables against the JAX scanner's;
- ``gate_slots_ref`` against the JAX ``_gate_ok``, and on the slots of
  ``pallas_scan_slots`` between ``pallas_gate_slots`` (interpret mode:
  survivors or escapes) and the exact native extension;
- the CUDA kernels against the plain versions on the card (marked
  ``cuda``; ``chip_smoke.py`` does the same at full size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.engine.extend import (
    BatchSeedExtender,
    Extender,
)
from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.ops import gate as jax_gate
from sequence_alignment_tools_tpu.ops.conv_scan import (
    ConvScanner as JaxConvScanner,
)
from sequence_alignment_tools_tpu.ops.pallas.scan_kernel import (
    SLOT_WB,
    kernel_weights,
    pallas_gate_slots,
    pallas_scan_slots,
    pos_exact_ok,
    slots_gate_table,
)
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.cuda.slots import (
    gate_slots,
    gate_slots_ref,
    scan_slots,
    scan_slots_ref,
    slot_gated_hits,
)
from sequence_alignment_tools_tpu_torch.ops.gate import GateTables
from test_slots_kernel import _decode, _mk
from test_torch_gate import DIRS, PATS, mutate, seed_meta
from test_torch_seed_gate import seed_tables

TABLE = b"ACGT\n"
EOS = 4
T, CAP, NW = 1024, 128, 6


def mer_scanner(tables):
    sc = ConvScanner(tables, k=0, device="cpu")
    sc.use_host = False
    return sc, sc._mer_dev()


def pairs(row):
    """Sorted (column 0, column 1) pairs of a [count, col, col] row."""
    cap = (row.numel() - 1) // 2
    m = min(int(row[0]), cap)
    return sorted(zip(row[1 : 1 + m].tolist(),
                      row[1 + cap : 1 + cap + m].tolist()))


def per_start(row, n):
    """{start: (count, sum of seed ids)} of a scan_slots row, starts < n."""
    out = {}
    for t, s in pairs(row):
        if t < n:
            c, sm = out.get(t, (0, 0))
            out[t] = (c + 1, sm + s)
    return out


def tpu_slots(codes, tables):
    assert pos_exact_ok(tables, 0)
    W, thr, classes = kernel_weights(tables, 0, False, fold=False)
    slots, counts = pallas_scan_slots(
        codes, W, thr, classes=classes, Lmax=tables.Lmax, T=T, NW=NW,
        cap=CAP, interpret=True, n_pat=tables.P)
    return np.asarray(slots), np.asarray(counts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_slots_matches_pallas_slots(seed):
    n = 3 * T - 200  # a partial last tile
    pats = ["ACGTA", "CGT", "TTACG", "ACGT"]
    db, tables = _mk(n, pats, seed=seed,
                     plant=[(T - 2, "ACGTA"), (2 * T - 1, "CGT"),
                            (n - 4, "CGT"), (500, "TTACG")])
    slots, counts = tpu_slots(db.codes, tables)
    want = {t: v for t, v in _decode(slots, counts, T, CAP, NW).items()
            if t < n}
    # the TPU kernel scans its zero pad too: give the port the same text
    padded = np.concatenate([np.asarray(db.codes),
                             np.zeros(8 * NW, np.uint8)])
    _sc, mt = mer_scanner(tables)
    row = scan_slots(torch.from_numpy(padded), len(padded), mt, 1 << 14)
    got = per_start(row, n)
    assert got == {t: (cnt, sid) for t, (cnt, sid, _w) in want.items()}
    assert len(got) >= 4 and any(c > 1 for c, _ in got.values())
    # the window the TPU kernel packs beside a slot is the resident text
    # gate_slots reads: code c of the window is codes[t - SLOT_WB + c]
    for t, (_cnt, _sid, win) in want.items():
        for c in range(8 * NW):
            src = t - SLOT_WB + c
            assert win[c] == (int(padded[src]) if src >= 0 else 0)


def test_scan_slots_overflow_keeps_true_count():
    """Poly-A text against 'AA': every start hits.  The TPU kernel reports
    per-row true counts past its cap; the port's row keeps the true count
    and the first cap entries."""
    n = T
    db, tables = _mk(n, ["AA"], seed=1)
    db.codes[:] = 0
    _slots, counts = tpu_slots(db.codes, tables)
    padded = np.concatenate([np.asarray(db.codes), np.zeros(8, np.uint8)])
    _sc, mt = mer_scanner(tables)
    row = scan_slots(torch.from_numpy(padded), len(padded), mt, CAP)
    assert int(row[0]) == len(padded) - 1 > CAP
    starts = row[1 : 1 + CAP]
    assert len(set(starts.tolist())) == CAP and int(starts.max()) < n + 7
    assert row[1 + CAP :].eq(0).all()
    full = scan_slots(torch.from_numpy(padded), len(padded), mt, 1 << 12)
    assert len(per_start(full, n)) == int(counts[0, :, 0].sum()) == T
    # without the pad no window reaches past n
    assert int(scan_slots(torch.from_numpy(db.codes.copy()), n, mt,
                          CAP)[0]) == n - 1


@pytest.fixture(scope="module")
def slot_db():
    """Random ACGT (4 tiles less 100 positions), two EOS, each pattern
    planted exact and with one edit, one plant cut by EOS."""
    rng = np.random.default_rng(17)
    n = 4 * T - 100
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for i, p in enumerate(PATS):
        for at, s in ((150 + 600 * i, p),
                      (450 + 600 * i, mutate(rng, p, 1, True))):
            codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
    codes[[1000, 3000]] = EOS
    codes[150 + 600 * 2 + 11] = EOS
    return SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
                 entry_lengths=np.array([n]), headers=["e1"])


def brute_pairs(codes, seeds):
    n = len(codes)
    out = []
    for s, seed in enumerate(seeds):
        sc = np.array([TABLE.index(c.encode()) for c in seed], np.uint8)
        hit = np.ones(n - len(sc) + 1, bool)
        for j, c in enumerate(sc):
            hit &= codes[j : j + len(hit)] == c
        out += [(int(t), s) for t in np.flatnonzero(hit)]
    return sorted(out)


@pytest.mark.parametrize("direction", sorted(DIRS))
def test_scan_slots_matches_brute_force(slot_db, direction):
    """Mixed seed lengths, a duplicated seed and windows at the array
    end: every (start, seed) pair, with t + len <= n."""
    seeds = seed_meta(1, DIRS[direction])[0]
    seeds = seeds + [seeds[0], slot_db.decode(len(slot_db.codes) - 7,
                                              len(slot_db.codes))]
    _sc, mt = mer_scanner(seed_tables(slot_db, seeds))
    codes = torch.from_numpy(slot_db.codes)
    want = brute_pairs(slot_db.codes, seeds)
    assert pairs(scan_slots_ref(codes, len(codes), mt, 4096)) == want
    assert len(want) >= len(seeds) and (len(codes) - 7, len(seeds) - 1) \
        in want
    m = len(codes) - 1000
    assert pairs(scan_slots(codes, m, mt, 4096)) == brute_pairs(
        slot_db.codes[:m], seeds)
    row = scan_slots_ref(codes, len(codes), mt, 3)
    assert int(row[0]) == len(want) and set(pairs(row)) <= set(want)


@pytest.mark.parametrize("name", ["mixed-lengths", "dna-short", "iupac"])
def test_mer_tables_match_jax(slot_db, name):
    """keys / head / enext / epid (and the native sidecars) per length
    equal the JAX scanner's on the same numpy PatternTables."""
    rng = np.random.default_rng(3)
    if name == "mixed-lengths":
        seeds = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
                 for ln in rng.integers(8, 25, size=400)]
        seeds += seeds[:9]
    elif name == "dna-short":
        seeds = seed_meta(1, DIRS["mixed"])[0] + ["ACGT", "ACGT", "TTGA"]
    else:
        seeds = ["".join("ACGTN"[c] for c in rng.integers(0, 5, size=12))
                 for _ in range(60)]
    tables = seed_tables(slot_db, [s.replace("N", "\n") for s in seeds])
    jsc = JaxConvScanner(tables, k=0, use_pallas=False)
    if jsc._mer_native(jsc._by_len(), slot_db.codes,
                       len(slot_db.codes)) is None:
        pytest.skip("native toolchain unavailable")
    sc, mt = mer_scanner(tables)
    assert sc._by_len() == jsc._by_len()
    got, want = sc._mer_tables(), jsc._mer_tables_c
    assert sorted(got) == sorted(want) == mt.lens
    for L in want:
        for g, w in zip(got[L], want[L]):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and np.array_equal(g, w)
            else:
                assert g == w
    assert mt.P == tables.P and mt.Lmax == max(want)
    assert mt.keys.numel() == sum(w[4] for w in want.values())


def gate_pair(db, k, indels, direction="mixed"):
    seeds, exts, dirs, offs, geomA = seed_meta(k, DIRS[direction])
    band = k if indels else 0
    args = (db, exts, dirs, offs, k, band, False, False)
    return (seeds, exts, dirs, offs, geomA,
            GateTables.from_seed_meta(*args),
            jax_gate.GateTables.from_seed_meta(*args))


@pytest.mark.parametrize("k,indels", [(1, True), (1, False), (2, True),
                                      (2, False)])
def test_gate_slots_matches_jax_gate(slot_db, k, indels):
    seeds, _e, _d, _o, _g, gt, jt = gate_pair(slot_db, k, indels)
    _sc, mt = mer_scanner(seed_tables(slot_db, seeds))
    codes = torch.from_numpy(slot_db.codes)
    n = len(codes)
    slots = scan_slots(codes, n, mt, 4096)
    starts, sids = map(np.asarray, zip(*pairs(slots)))
    anchors = starts + np.asarray([len(seeds[s]) for s in sids])
    ok = np.asarray(jax_gate.ExtendGate(jt, indels)(
        jnp.asarray(slot_db.codes), anchors, sids.astype(np.int32)))
    want = sorted(zip(anchors[ok].tolist(), sids[ok].tolist()))
    assert len(PATS) <= len(want) < len(starts)
    assert pairs(gate_slots(codes, n, slots, mt.lengths, gt, indels,
                            4096)) == want
    assert pairs(gate_slots_ref(codes, n, slots, mt.lengths, gt, indels,
                                4096)) == want
    row = gate_slots(codes, n, slots, mt.lengths, gt, indels, 2)
    assert int(row[0]) == len(want) and set(pairs(row)) <= set(want)
    packed = slot_gated_hits(codes, n, mt, gt, indels, 4096, 4096)
    assert int(packed[0]) == len(starts) and pairs(packed[1:]) == want
    # a short slot list gates only what it kept
    few = scan_slots(codes, n, mt, 5)
    kept = set(pairs(few))
    got = pairs(gate_slots(codes, n, few, mt.lengths, gt, indels, 4096))
    assert set(got) == {(a, s) for a, s in want
                        if (a - len(seeds[s]), s) in kept}


@pytest.mark.parametrize("k,indels", [(1, True), (1, False), (2, True)])
def test_gate_slots_between_pallas_gate_and_extension(slot_db, k, indels):
    """On the slots of ``pallas_scan_slots``: the port's exact gate keeps a
    subset of what ``pallas_gate_slots`` keeps or escapes (its gate is a
    prefix of the exact one) and a superset of the slots whose exact
    native extension succeeds."""
    seeds, exts, dirs, offs, geomA, gt, jt = gate_pair(slot_db, k, indels)
    tables = seed_tables(slot_db, seeds)
    n = len(slot_db.codes)
    slots, counts = tpu_slots(slot_db.codes, tables)
    LgT = max(1, min(6, int(jt.glen_np.max())))
    lens = tuple(sorted({int(x) for x in tables.lengths}))
    kept, kcounts = pallas_gate_slots(
        jnp.asarray(slots), jnp.asarray(counts),
        jnp.asarray(slots_gate_table(jt, tables.lengths, LgT)[None]),
        NW=NW, cap=CAP, LgT=LgT, kk=k, band=k if indels else 0,
        indels=indels, lens=lens, T=T, n=n, Lmax=tables.Lmax,
        interpret=True)
    kept, kcounts = np.asarray(kept), np.asarray(kcounts)
    tpu_starts = set()
    for i in range(kept.shape[0]):
        for r in range(8):
            for meta in kept[i, r, : int(kcounts[i, r, 0])]:
                tpu_starts.add(i * T + ((int(meta) & 0x7FFFFFFF) >> 15))
    all_starts = {t for t in _decode(slots, counts, T, CAP, NW) if t < n}
    _sc, mt = mer_scanner(tables)
    codes = torch.from_numpy(slot_db.codes)
    row = scan_slots(codes, n, mt, 4096)
    assert {t for t, _s in pairs(row)} <= all_starts
    surv = pairs(gate_slots(codes, n, row, mt.lengths, gt, indels, 4096))
    surv_starts = {a - len(seeds[s]) for a, s in surv}
    assert surv_starts <= tpu_starts < all_starts
    S = len(seeds)
    batch = BatchSeedExtender(
        Extender(k, "\n", False, False, indels, False), slot_db, dirs, exts,
        np.zeros(S, np.int32), np.zeros(S, np.int32), geomA, offs)
    starts, sids = map(np.asarray, zip(*pairs(row)))
    anchors = starts + np.asarray([len(seeds[s]) for s in sids])
    ok, _end, _val = batch(anchors, sids.astype(np.int32))
    passers = set(zip(anchors[ok != 0].tolist(), sids[ok != 0].tolist()))
    assert len(passers) >= len(PATS) and passers <= set(surv)


@pytest.mark.cuda
@pytest.mark.parametrize("k,indels", [(1, True), (1, False), (2, True)])
def test_cuda_kernels_match_plain(slot_db, k, indels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    seeds, _e, _d, _o, _g, gt, _jt = gate_pair(slot_db, k, indels)
    sc = ConvScanner(seed_tables(slot_db, seeds), k=0, device="cuda")
    mt, gt = sc._mer_dev(), gt.to("cuda")
    codes = torch.from_numpy(slot_db.codes).cuda()
    for n in (len(slot_db.codes), len(slot_db.codes) - 1000):
        for cap in (4096, 3):
            before = scan_slots.launches, gate_slots.launches
            got = scan_slots(codes, n, mt, cap)
            want = scan_slots_ref(codes, n, mt, 4096)
            full = scan_slots(codes, n, mt, 4096)
            ggot = gate_slots(codes, n, full, mt.lengths, gt, indels, cap)
            gwant = gate_slots_ref(codes, n, full, mt.lengths, gt, indels,
                                   4096)
            torch.cuda.synchronize()
            assert (scan_slots.launches, gate_slots.launches) == (
                before[0] + 2, before[1] + 1)
            assert int(got[0]) == int(want[0]) > 0
            assert int(ggot[0]) == int(gwant[0]) > 0
            assert set(pairs(got.cpu())) <= set(pairs(want.cpu()))
            assert set(pairs(ggot.cpu())) <= set(pairs(gwant.cpu()))
            if cap == 4096:
                assert pairs(got.cpu()) == pairs(want.cpu())
                assert pairs(ggot.cpu()) == pairs(gwant.cpu())


@pytest.mark.cuda
def test_cuda_census_shapes():
    """The rolling-code census on the card against the plain version on
    the shapes of ``tests/test_torch_census_roll.py`` (1 to 6 length
    classes, duplicates, a seed across an EOS, a window ending at n), at
    a full cap, at cap 1 (the staged output's overflow) and on a codes
    slice that is not 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from test_torch_census_roll import CASES, census_case

    for lengths, n in CASES:
        codes, _seeds, mt = census_case(lengths, n)
        mt = mt.to("cuda")
        dev = torch.from_numpy(
            np.concatenate([np.zeros(1, np.uint8), codes])).cuda()
        for cd in (dev[1:].clone(), dev[1:]):
            for m in (n, n - 7):
                want = scan_slots_ref(cd, m, mt, 1 << 16)
                got = scan_slots(cd, m, mt, 1 << 16)
                one = scan_slots(cd, m, mt, 1)
                torch.cuda.synchronize()
                assert int(got[0]) == int(one[0]) == int(want[0]) > 0
                assert pairs(got.cpu()) == pairs(want.cpu())
                assert set(pairs(one.cpu())) <= set(pairs(want.cpu()))


@pytest.mark.cuda
def test_cuda_gate_slots_every_band():
    """Every compiled instance of the slot gate (the mismatch count, and
    the banded DP at bands 1 to 8) against the plain version on a slot
    list of many batches: 64 random 5-base seeds over 2^17 positions with
    EOS every 5,000 bases, extensions of 4 to 14 bases both ways, slots
    at both text ends; at a full cap and at cap 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(29)
    n = 1 << 17
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[::5000] = EOS
    seeds = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=5))
             for _ in range(64)]
    # the lmatch seed 0 at the end, the rmatch seed 1 at the start: their
    # windows reach past the text's ends
    for at, s in ((0, seeds[1]), (n - 5, seeds[0])):
        codes[at : at + 5] = [TABLE.index(c.encode()) for c in s]
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["e1"])
    exts = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
            for ln in rng.integers(4, 15, size=64)]
    exts[0], exts[1] = seeds[0][-1] * 6, seeds[1][0] * 6
    dirs = np.asarray([1, -1] * 32, np.int32)
    offs = np.where(dirs > 0, 0, 5).astype(np.int32)
    sc = ConvScanner(seed_tables(db, seeds), k=0, device="cuda")
    mt = sc._mer_dev()
    dev = torch.from_numpy(codes).cuda()
    slots = scan_slots(dev, n, mt, 1 << 16)
    torch.cuda.synchronize()
    assert 5_000 < int(slots[0]) < 1 << 16
    for k, indels in [(k, True) for k in range(1, 9)] + [(1, False),
                                                         (3, False)]:
        gt = GateTables.from_seed_meta(db, exts, dirs, offs, k,
                                       k if indels else 0, False,
                                       False).to("cuda")
        want = gate_slots_ref(dev, n, slots, mt.lengths, gt, indels, 1 << 16)
        got = gate_slots(dev, n, slots, mt.lengths, gt, indels, 1 << 16)
        one = gate_slots(dev, n, slots, mt.lengths, gt, indels, 1)
        torch.cuda.synchronize()
        assert int(got[0]) == int(one[0]) == int(want[0]) > 0, (k, indels)
        assert pairs(got.cpu()) == pairs(want.cpu()), (k, indels)
        assert set(pairs(one.cpu())) <= set(pairs(want.cpu()))
