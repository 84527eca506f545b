"""The port's extension gate against the JAX package's.

``GateTables.from_seed_meta`` and ``gate_ok_ref`` are held against
``sequence_alignment_tools_tpu.ops.gate`` on the same seeded inputs
(exact equality), and the gate is checked to be a superset of the exact
native extension (``engine/extend.BatchSeedExtender``) on planted
variants.
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
from sequence_alignment_tools_tpu_torch.ops.gate import (
    ExtendGate,
    GateTables,
    gate_ok_ref,
)

TABLE = b"ACGT\n"
EOS = 4
PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "TCATGAAGTAAAC"]


def mutate(rng, pat, nmut, indels):
    s = list(pat)
    for _ in range(nmut):
        op = int(rng.integers(0, 3)) if indels else 0
        i = int(rng.integers(0, len(s)))
        if op == 0:
            s[i] = "ACGT"[("ACGT".index(s[i]) + 1 + int(rng.integers(0, 3)))
                          % 4]
        elif op == 1:
            del s[i]
        else:
            s.insert(i, "ACGT"[int(rng.integers(0, 4))])
    return "".join(s)


def seed_meta(k, dirs):
    """Half seeds of PATS: an lmatch seed (dir +1) extends over the right
    half, an rmatch seed (dir -1) over the left half, offset by the seed
    length; geomA/geomB as the halves engine sets them."""
    seeds, exts, offs, geomA = [], [], [], []
    for p, d in zip(PATS, dirs):
        h1, h2 = p[: len(p) // 2], p[len(p) // 2 :]
        seeds.append(h1 if d > 0 else h2)
        exts.append(h2 if d > 0 else h1)
        offs.append(0 if d > 0 else len(h2))
        geomA.append(0 if d > 0 else len(p) + k)
    return (seeds, exts, np.asarray(dirs, np.int32),
            np.asarray(offs, np.int32), np.asarray(geomA, np.int32))


@pytest.fixture(scope="module")
def planted():
    """Random ACGT with EOS every 1500 bases; each pattern planted exact,
    with 1 and 2 edits, and next to EOS; returns (db, plants) with plants
    the (start, pattern index) of every planted copy."""
    rng = np.random.default_rng(41)
    n = 24_000
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    plants = []
    at = 200
    for i, p in enumerate(PATS):
        for nmut in (0, 1, 2, 1):
            s = mutate(rng, p, nmut, True) if nmut else p
            codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
            plants.append((at, i))
            at += 600
    codes[::1500] = EOS
    # one plant cut by EOS in its extension, one touching the array end
    codes[plants[5][0] + 10] = EOS
    p = PATS[2]
    codes[n - len(p) :] = [TABLE.index(c.encode()) for c in p]
    plants.append((n - len(p), 2))
    db = SeqDB(codes=codes, table=TABLE,
               entry_starts=np.array([0]), entry_lengths=np.array([n]),
               headers=["e1"])
    return db, plants


def candidates(db, plants, seeds, dirs, rng, count=600):
    """(anchors, sids): every planted copy's seed anchor (+-2), plus
    random anchors, some within Lg of 0 and of n."""
    n = len(db.codes)
    anchors, sids = [], []
    for at, i in plants:
        p = PATS[i]
        a = at + (len(p) // 2 if dirs[i] > 0 else len(p))
        for da in (-2, -1, 0, 1, 2):
            anchors.append(a + da)
            sids.append(i)
    S = len(seeds)
    edge = np.concatenate([np.arange(0, 12), np.arange(n - 12, n)])
    anchors += edge.tolist()
    sids += rng.integers(0, S, len(edge)).tolist()
    anchors += rng.integers(0, n, count).tolist()
    sids += rng.integers(0, S, count).tolist()
    return np.asarray(anchors, np.int64), np.asarray(sids, np.int32)


DIRS = {"lmatch": [1] * len(PATS), "rmatch": [-1] * len(PATS),
        "mixed": [1, -1] * (len(PATS) // 2)}


@pytest.mark.parametrize("wc", [False, True])
@pytest.mark.parametrize("direction", sorted(DIRS))
def test_gate_tables_match_jax(planted, direction, wc):
    db, _ = planted
    _seeds, exts, dirs, offs, _ = seed_meta(1, DIRS[direction])
    want = jax_gate.GateTables.from_seed_meta(db, exts, dirs, offs, 1, 1,
                                              wc, False)
    got = GateTables.from_seed_meta(db, exts, dirs, offs, 1, 1, wc, False)
    assert np.array_equal(got.bits_np, want.bits_np)
    assert np.array_equal(got.glen_np, want.glen_np)
    assert np.array_equal(got.dir_np, want.dir_np)
    assert np.array_equal(got.gdir_np, np.asarray(want.gdir))
    assert torch.equal(got.bits, torch.from_numpy(want.bits_np))
    assert (got.Lg, got.alpha, got.k, got.band) == \
        (want.Lg, want.alpha, want.k, want.band)
    assert got.to("cpu").gdir.dtype == torch.int32


@pytest.mark.parametrize("direction", ["lmatch", "rmatch"])
@pytest.mark.parametrize("indels", [True, False])
@pytest.mark.parametrize("k", [1, 2])
def test_gate_ok_matches_jax(planted, k, indels, direction):
    db, plants = planted
    rng = np.random.default_rng(100 + k)
    seeds, exts, dirs, offs, _ = seed_meta(k, DIRS[direction])
    band = k if indels else 0
    jt = jax_gate.GateTables.from_seed_meta(db, exts, dirs, offs, k, band,
                                            False, False)
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, k, band, False,
                                   False)
    anchors, sids = candidates(db, plants, seeds, dirs, rng)
    n = len(db.codes)
    want = np.asarray(jax_gate.ExtendGate(jt, indels)(
        jnp.asarray(db.codes), anchors, sids))
    codes = torch.from_numpy(db.codes)
    got = gate_ok_ref(codes, torch.from_numpy(anchors),
                      torch.from_numpy(sids), gt, indels, n).numpy()
    assert want.any() and not want.all()
    assert np.array_equal(got, want)
    assert np.array_equal(
        ExtendGate(gt, indels)(codes, anchors, sids).numpy(), want)


def test_gate_edge_rules(planted):
    """An empty extension passes; an anchor whose whole window lies
    outside [0, n) fails (every slot reads the sentinel)."""
    db, _ = planted
    n = len(db.codes)
    exts = ["", "ACGTAC"]
    gt = GateTables.from_seed_meta(db, exts, np.array([1, 1]),
                                   np.array([0, 0]), 1, 1, False, False)
    ok = gate_ok_ref(torch.from_numpy(db.codes),
                     torch.tensor([n + 50, n + 50, 5]),
                     torch.tensor([0, 1, 0]), gt, True, n)
    assert ok.tolist() == [True, False, True]


@pytest.mark.parametrize("k,indels", [(1, True), (2, True), (1, False),
                                      (2, False)])
def test_gate_superset_of_extension(planted, k, indels):
    """Wherever the exact batched extension says ok, the gate says ok
    (the converse may differ: the gate ignores constraints and charges
    every edit 1)."""
    db, plants = planted
    rng = np.random.default_rng(7 + k)
    seeds, exts, dirs, offs, geomA = seed_meta(k, DIRS["mixed"])
    S = len(seeds)
    ext = Extender(k, "\n", False, False, indels, False)
    batch = BatchSeedExtender(ext, db, dirs, exts, np.zeros(S, np.int32),
                              np.zeros(S, np.int32), geomA, offs)
    gt = GateTables.from_seed_meta(db, exts, dirs, offs, k,
                                   k if indels else 0, False, False)
    anchors, sids = candidates(db, plants, seeds, dirs, rng, count=2000)
    ok_true, _, _ = batch(anchors, sids)
    ok_gate = gate_ok_ref(torch.from_numpy(db.codes),
                          torch.from_numpy(anchors), torch.from_numpy(sids),
                          gt, indels, len(db.codes)).numpy()
    assert ok_true.sum() >= len(PATS)
    missed = ok_true & ~ok_gate
    assert not missed.any(), f"gate lost {missed.sum()} true-ok candidates"
