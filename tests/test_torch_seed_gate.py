"""The gated seed scan against a brute-force enumeration and the JAX
package.

``seed_gate`` runs its plain PyTorch version on CPU tensors.  It is held
against every exact seed hit found by brute force and gated by the JAX
``ops.gate._gate_ok``; its enumeration (under a gate that passes all),
reduced per window start to (sum of seed ids, count) and per microblock
to a count, is held against the Pallas scan kernel's "pos" and "counts"
emits (interpret mode).  All comparisons are exact.  The CUDA kernel is
held against the plain version on the card (marked ``cuda``;
``chip_smoke.py`` does the same at full size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import PatternSet
from sequence_alignment_tools_tpu.ops import gate as jax_gate
from sequence_alignment_tools_tpu.ops.pallas.scan_kernel import (
    _kernel_out,
    kernel_weights,
    pallas_microhits,
)
from sequence_alignment_tools_tpu.ops.tables import build_tables
from sequence_alignment_tools_tpu_torch.ops.compact import compact_mask
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
    scan_occupancy,
)
from sequence_alignment_tools_tpu_torch.ops.cuda.seed_gate import (
    gated_hits,
    seed_gate,
    seed_gate_ref,
)
from sequence_alignment_tools_tpu_torch.ops.gate import GateTables
from sequence_alignment_tools_tpu_torch.ops.tables import device_tables
from test_torch_gate import mutate

TABLE = b"ACGT\n"
EOS = 4
MB = 32
PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "TCATGAAGTAAAC",
        "TTGGCTGCTGCCCCCAG", "AGAAAAGGGGGAAA",
        # its left half extends the first pattern's: both seeds hit at
        # one start
        "AGAAGCGTTTACGGA"]


@pytest.fixture(scope="module")
def block():
    """A 2^14 block of random ACGT with EOS every 3000 bases, each pattern
    planted exact and with 1 and 2 edits, one split by EOS and one
    ending at the block end."""
    rng = np.random.default_rng(5)
    n = 1 << 14
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    at = 150
    for p in PATS:
        for nmut in (0, 1, 2):
            s = mutate(rng, p, nmut, True) if nmut else p
            codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
            at += 500
    codes[::3000] = EOS
    codes[150 + 500 * 3 + 7] = EOS
    p = PATS[6]
    codes[n - len(p) :] = [TABLE.index(c.encode()) for c in p]
    return SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
                 entry_lengths=np.array([n]), headers=["e1"])


def halves_meta(k):
    """The halves engine's seeds and gate metadata for PATS: seed 2i is
    the left half (extends right), seed 2i + 1 the right half (extends
    left over the left half)."""
    seeds, exts, dirs, offs = [], [], [], []
    for p in PATS:
        h1, h2 = p[: len(p) // 2], p[len(p) // 2 :]
        seeds += [h1, h2]
        exts += [h2, h1]
        dirs += [1, -1]
        offs += [0, len(h2)]
    return seeds, exts, np.asarray(dirs, np.int32), np.asarray(offs,
                                                              np.int32)


def seed_tables(db, seeds):
    ps = PatternSet(patterns=[""] + seeds, esb=[0] * (len(seeds) + 1),
                    eeb=[0] * (len(seeds) + 1), n_forward=len(seeds))
    return build_tables(ps, db, wc=False, textn=False)


def brute_seed_hits(db, seeds):
    """Every (start, seed) exact match, text past n read as EOS."""
    n = len(db.codes)
    text = np.concatenate([db.codes, np.full(32, EOS, np.uint8)])
    out = []
    for s, seed in enumerate(seeds):
        sc = np.array([TABLE.index(c.encode()) for c in seed], np.uint8)
        hit = np.ones(n, bool)
        for j, c in enumerate(sc):
            hit &= text[j : j + n] == c
        out += [(int(t), s) for t in np.flatnonzero(hit)]
    return sorted(out)


def scanner_parts(db, seeds):
    sc = ConvScanner(seed_tables(db, seeds), k=0, device="cpu")
    sc.use_host = False
    return sc, sc._tables_dev()


def all_microblocks(n):
    nmb = -(-n // MB)
    return torch.tensor(nmb), torch.arange(nmb)


def survivors(row, cap):
    """Sorted (anchor, sid) pairs of a [count, anchors, sids] row."""
    count = int(row[0])
    m = min(count, cap)
    return sorted(zip(row[1 : 1 + m].tolist(),
                      row[1 + cap : 1 + cap + m].tolist()))


@pytest.mark.parametrize("k,indels", [(1, True), (1, False), (2, True)])
def test_seed_gate_matches_brute_force(block, k, indels):
    db = block
    n = len(db.codes)
    seeds, exts, dirs, offs = halves_meta(k)
    band = k if indels else 0
    sc, dt = scanner_parts(db, seeds)
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, k, band, False,
                                   False)
    hits = brute_seed_hits(db, seeds)
    anchors = np.array([t + len(seeds[s]) for t, s in hits], np.int64)
    sids = np.array([s for _, s in hits], np.int32)
    jt = jax_gate.GateTables.from_seed_meta(db, exts, dirs, offs, k, band,
                                            False, False)
    ok = np.asarray(jax_gate.ExtendGate(jt, indels)(
        jnp.asarray(db.codes), anchors, sids))
    want = sorted(zip(anchors[ok].tolist(), sids[ok].tolist()))
    assert 0 < len(want) < len(hits)
    codes = torch.from_numpy(db.codes)
    cap = 4096
    mb_count, mb_idx = all_microblocks(n)
    row = seed_gate_ref(codes, n, dt, mb_count, mb_idx, gt, EOS, indels, cap)
    assert int(row[0]) == len(want)
    assert survivors(row, cap) == want
    # on a CPU tensor the wrapper is the plain version, and no launch
    before = seed_gate.launches
    assert torch.equal(seed_gate(codes, n, dt, mb_count, mb_idx, gt, EOS,
                                 indels, cap), row)
    assert seed_gate.launches == before
    # the pipeline: the filter's candidate microblocks lose no survivor
    packed = gated_hits(codes, n, dt, gt, EOS, indels, 1024, cap)
    occ = scan_occupancy(codes, dt.weights16, dt.thresholds, n, EOS)
    assert int(packed[0]) == int(occ.sum()) <= 1024
    assert survivors(packed[1:], cap) == want
    got_a, got_s = sc.scan_gated(db.codes, gt, indels, k)
    assert sorted(zip(got_a.tolist(), got_s.tolist())) == want


def test_enumeration_matches_pallas_emits(block):
    """Under a gate that passes every seed hit, the enumeration reduced
    per window start to (sum of seed ids, count) equals the Pallas "pos"
    emit, and per microblock equals the "counts" emit, where the JAX form
    reads real text (it pads past n with code 0, the port reads EOS)."""
    db = block
    n = len(db.codes)
    seeds, _exts, _dirs, _offs = halves_meta(1)
    _sc, dt = scanner_parts(db, seeds)
    tables = seed_tables(db, seeds)
    S, Lmax = tables.P, tables.Lmax
    open_gate = GateTables.from_seed_meta(
        db, [""] * S, np.ones(S, np.int32), np.zeros(S, np.int32), 1, 1,
        False, False)
    cap = 8192
    mb_count, mb_idx = all_microblocks(n)
    row = seed_gate_ref(torch.from_numpy(db.codes), n, dt, mb_count, mb_idx,
                        open_gate, EOS, True, cap)
    pairs = survivors(row, cap)
    assert pairs == sorted((t + len(seeds[s]), s)
                           for t, s in brute_seed_hits(db, seeds))
    cnt = np.zeros(n, np.int64)
    idsum = np.zeros(n, np.int64)
    for a, s in pairs:
        t = a - len(seeds[s])
        cnt[t] += 1
        idsum[t] += s
    W, thr, classes = kernel_weights(tables, 0, False, fold=False)
    kw = dict(classes=classes, Lmax=Lmax, T=8192, MB=MB, interpret=True,
              n_pat=S)
    pos = np.asarray(_kernel_out(jnp.asarray(db.codes), W, thr, emit="pos",
                                 **kw))
    words = pos[:, 0].transpose(0, 2, 1).reshape(-1)[:n].astype(np.int64)
    live = n - Lmax + 1
    want = np.where(cnt > 0, (idsum << 8) | np.minimum(cnt, 255), -256)
    assert (cnt[:live] > 1).any()  # multi-seed starts are covered
    assert np.array_equal(words[:live], want[:live])
    counts = np.asarray(pallas_microhits(
        jnp.asarray(db.codes), W, thr, occupancy=False, **kw))
    nmb = live // MB
    per_mb = cnt[: nmb * MB].reshape(nmb, MB).sum(axis=1)
    assert np.array_equal(counts[:nmb].astype(np.int64), per_mb)


def test_overflow_reports_true_counts_and_retries(block):
    db = block
    n = len(db.codes)
    seeds, exts, dirs, offs = halves_meta(1)
    sc, dt = scanner_parts(db, seeds)
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, 1, 1, False, False)
    codes = torch.from_numpy(db.codes)
    full = gated_hits(codes, n, dt, gt, EOS, True, 1024, 4096)
    mb_true, surv_true = int(full[0]), int(full[1])
    assert mb_true > 1 and surv_true > 1
    small = gated_hits(codes, n, dt, gt, EOS, True, 1, 1)
    assert small.shape == (4,)
    assert int(small[0]) == mb_true
    assert 1 <= int(small[1]) <= surv_true  # one microblock's survivors
    capped = gated_hits(codes, n, dt, gt, EOS, True, 1024, 1)
    assert int(capped[1]) == surv_true
    # the scanner's microblock cap is every microblock; its survivor cap
    # grows past the true count on overflow and stays grown
    assert sc._gated_caps(n)[0] == n // MB >= mb_true
    sc._gsurv_cap = 1
    a, s = sc.scan_gated(db.codes, gt, True, 1)
    assert sorted(zip(a.tolist(), s.tolist())) == survivors(full[1:], 4096)
    assert sc._gsurv_cap >= surv_true
    assert sc._gated_caps(n)[1] == sc._gsurv_cap
    stream = list(sc.scan_gated_stream(
        [db.codes, db.codes[:0], db.codes], gt, True, 1, depth=2))
    assert [i for i, _, _ in stream] == [0, 1, 2]
    assert len(stream[1][1]) == 0
    for i in (0, 2):
        assert sorted(zip(stream[i][1].tolist(), stream[i][2].tolist())) \
            == survivors(full[1:], 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("k,indels", [(1, True), (1, False), (2, True)])
def test_cuda_kernel_matches_plain(block, k, indels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    db = block
    seeds, exts, dirs, offs = halves_meta(k)
    dt = device_tables(seed_tables(db, seeds), 0, False, "cuda")
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, k,
                                   k if indels else 0, False,
                                   False).to("cuda")
    codes = torch.from_numpy(db.codes).cuda()
    for n in (len(db.codes), len(db.codes) - 1000):
        occ = scan_occupancy(codes, dt.weights16, dt.thresholds, n, EOS)
        mb_count, mb_idx = compact_mask(occ, 1024)
        before = seed_gate.launches
        got = seed_gate(codes, n, dt, mb_count, mb_idx, gt, EOS, indels, 4096)
        want = seed_gate_ref(codes, n, dt, mb_count, mb_idx, gt, EOS, indels,
                             4096)
        torch.cuda.synchronize()
        assert seed_gate.launches == before + 1
        assert int(got[0]) == int(want[0]) > 0
        assert survivors(got.cpu(), 4096) == survivors(want.cpu(), 4096)


@pytest.mark.cuda
def test_cuda_queue_flushes_many_times(block):
    """Five-base half seeds over every microblock: hundreds of seed hits,
    so the per-warp queue flushes many times, and at cap 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    db = block
    n = len(db.codes)
    short = ["ACGTTGCAAC", "GGATCCATGC", "TTAGCCAGTA", "CAGTACGATC",
             "GTCAGTTACG", "ATGCGTACCA"]
    seeds, exts, dirs, offs = [], [], [], []
    for p in short:
        seeds += [p[:5], p[5:]]
        exts += [p[5:], p[:5]]
        dirs += [1, -1]
        offs += [0, 5]
    dirs, offs = np.asarray(dirs, np.int32), np.asarray(offs, np.int32)
    dt = device_tables(seed_tables(db, seeds), 0, False, "cuda")
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, 1, 1, False,
                                   False).to("cuda")
    open_gate = GateTables.from_seed_meta(
        db, [""] * len(seeds), np.ones(len(seeds), np.int32),
        np.zeros(len(seeds), np.int32), 1, 1, False, False).to("cuda")
    codes = torch.from_numpy(db.codes).cuda()
    mb_count, mb_idx = all_microblocks(n)
    mb_count, mb_idx = mb_count.cuda(), mb_idx.cuda()
    cap = 1 << 14
    for g in (open_gate, gt):
        want = seed_gate_ref(codes, n, dt, mb_count, mb_idx, g, EOS, True,
                             cap)
        for c in (cap, 1):
            got = seed_gate(codes, n, dt, mb_count, mb_idx, g, EOS, True, c)
            torch.cuda.synchronize()
            assert int(got[0]) == int(want[0]) > 0
            kept = survivors(got.cpu(), c)
            assert set(kept) <= set(survivors(want.cpu(), cap))
            if c == cap:
                assert kept == survivors(want.cpu(), cap)
        if g is open_gate:
            assert int(want[0]) > 3 * 32  # every seed hit: three flushes
