"""The fused scan's filter and packed row against the JAX package.

``scan_occupancy`` runs its plain PyTorch version on CPU tensors; that
version is held against the JAX scanner's hit set, against the Pallas
filter's mask (interpret mode) and, through ``scan_hits``, against
``pallas_scan_hits``.  The CUDA kernel itself is held against the plain
version on the card (marked ``cuda``; ``chip_smoke.py`` does the same at
full size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu.ops.conv_scan import ConvScanner as JaxScanner
from sequence_alignment_tools_tpu.ops.pallas.scan_kernel import (
    kernel_weights,
    pallas_microhits,
    pallas_scan_hits,
)
from sequence_alignment_tools_tpu.ops.tables import build_tables, conv_weights
from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
    long_form,
    scan_hits,
    scan_occupancy,
    scan_occupancy_ref,
)
from sequence_alignment_tools_tpu_torch.ops.tables import device_tables

PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA"]
TABLE = b"ACGT\n"
EOS = 4
MB = 32


def planted_db(n=(1 << 17) - 77, seed=11):
    """Random ACGT in six entries split by EOS; every pattern
    planted exactly, once with one substitution, once across an EOS
    (no hit at any k under poison), and one ending at the array end."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    step = n // 6
    eos_at = np.arange(0, n - step // 2, step)
    starts = eos_at + 1

    def put(at, s):
        codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]

    for i, p in enumerate(PATS):
        put(int(starts[i % len(starts)]) + 500 + 900 * i, p)
        sub = p[:5] + "ACGT"[("ACGT".index(p[5]) + 1) % 4] + p[6:]
        put(int(starts[(i + 2) % len(starts)]) + 700 + 900 * i, sub)
    # straddling the EOS at eos_at[3]
    put(int(eos_at[3]) - 6, PATS[1])
    put(n - len(PATS[2]), PATS[2])
    codes[eos_at] = EOS
    db = SeqDB(codes=codes, table=TABLE, entry_starts=starts,
               entry_lengths=np.minimum(step - 1, n - starts),
               headers=[f"e{i}" for i in range(len(starts))])
    return db


@pytest.fixture(scope="module")
def db():
    return planted_db()


def _tables(db, rev_comp=True):
    return build_tables(build_pattern_set(PATS, rev_comp=rev_comp), db,
                        wc=False, textn=False)


def _jax_hits(tables, k, codes):
    sc = JaxScanner(tables, k=k, block=1 << 15, use_pallas=False)
    sc.use_host = False  # the XLA block path
    return list(sc.scan(codes))


def decode(row, cap_mb, hit_cap, P, lengths, n):
    """(end, pid, mism) list from a packed ``pallas_scan_hits`` row."""
    row = np.asarray(row).astype(np.int64)
    mb_count, hit_count = int(row[0]), int(row[1])
    assert mb_count <= cap_mb and hit_count <= hit_cap
    mb_idx = row[2 : 2 + cap_mb]
    hits = row[2 + cap_mb : 2 + cap_mb + hit_cap][:hit_count]
    if long_form(cap_mb, P):
        idx, mism = hits, row[2 + cap_mb + hit_cap :][:hit_count]
    else:
        idx, mism = hits & 0xFFFFFF, hits >> 24
    starts = mb_idx[idx // (MB * P)] * MB + (idx // P) % MB
    pid = idx % P
    keep = starts < n
    return sorted(zip((starts + lengths[pid])[keep].tolist(),
                      pid[keep].tolist(), mism[keep].tolist()))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_occupancy_is_the_hit_microblocks(db, k):
    tables = _tables(db)
    hits = _jax_hits(tables, k, db.codes)
    # the exact plants and the one at the end; the substituted ones at k > 0
    assert len(hits) >= (1 + (k > 0)) * len(PATS) + 1
    straddle_end = int(db.entry_starts[3]) - 7 + len(PATS[1])
    assert not [h for h in hits if h[0] == straddle_end and h[1] == 1]
    dt = device_tables(tables, k, k > 0, "cpu")
    codes = torch.from_numpy(db.codes)
    n = len(db.codes)
    occ = scan_occupancy_ref(codes, dt.weights16, dt.thresholds, n, EOS)
    assert occ.shape == (-(-n // MB),)
    want = sorted({(e - int(tables.lengths[p])) // MB for e, p, _ in hits})
    assert np.flatnonzero(occ.numpy()).tolist() == want
    # on a CPU tensor the wrapper is the plain version, and no launch
    before = scan_occupancy.launches
    assert torch.equal(
        scan_occupancy(codes, dt.weights16, dt.thresholds, n, EOS), occ)
    assert scan_occupancy.launches == before


@pytest.mark.parametrize("k", [0, 1, 2])
def test_occupancy_within_pallas_filter(db, k):
    """The exact filter's mask is a subset of the Pallas kernel's (whose
    base-class fold only adds candidates)."""
    tables = _tables(db)
    W, thr, classes = kernel_weights(tables, k, k > 0)
    mask = np.asarray(pallas_microhits(
        jnp.asarray(db.codes), W, thr, classes=classes, Lmax=tables.Lmax,
        T=8192, MB=MB, interpret=True, n_pat=tables.P, occupancy=True))
    dt = device_tables(tables, k, k > 0, "cpu")
    occ = scan_occupancy_ref(torch.from_numpy(db.codes), dt.weights16,
                             dt.thresholds, len(db.codes), EOS).numpy()
    assert occ.any()
    assert len(mask) >= len(occ)
    assert not (occ & ~mask[: len(occ)]).any()


@pytest.mark.parametrize("k", [0, 1, 2])
def test_scan_hits_matches_pallas_scan_hits(db, k):
    tables = _tables(db)
    n, P = len(db.codes), tables.P
    cap_mb, hit_cap = 256, 512
    W, thr, classes = kernel_weights(tables, k, k > 0)
    row = pallas_scan_hits(
        jnp.asarray(db.codes), W, thr,
        jnp.asarray(conv_weights(tables, k, k > 0)),
        jnp.asarray(tables.lengths.astype(np.float32) - k),
        jnp.asarray(tables.lengths), classes=classes, alpha=tables.alpha,
        Lmax=tables.Lmax, eos_code=tables.eos_code, T=8192, MB=MB,
        cap_mb=cap_mb, hit_cap=hit_cap, interpret=True)
    dt = device_tables(tables, k, k > 0, "cpu")
    got = scan_hits(torch.from_numpy(db.codes), n, dt, EOS, cap_mb, hit_cap)
    assert got.dtype == torch.int32
    assert got.shape == (2 + cap_mb + hit_cap,)
    want = decode(row, cap_mb, hit_cap, P, tables.lengths, n)
    assert decode(got.numpy(), cap_mb, hit_cap, P, tables.lengths, n) == want
    assert int(got[1]) == int(row[1]) == len(want)
    assert want == sorted(_jax_hits(tables, k, db.codes))


def test_scan_hits_long_form_and_overflow(db):
    """Past 24 index bits the row carries mismatches in their own section;
    too-small caps report the true counts (the caller's retry signal)."""
    rng = np.random.default_rng(3)
    fillers = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=14))
               for _ in range(150 - len(PATS))]
    tables = build_tables(build_pattern_set(PATS + fillers, rev_comp=False),
                          db, wc=False, textn=False)
    n, P = len(db.codes), tables.P
    dt = device_tables(tables, 1, True, "cpu")
    codes = torch.from_numpy(db.codes)
    short = scan_hits(codes, n, dt, EOS, 256, 512)
    cap_mb = 1 << 12
    assert long_form(cap_mb, P)
    long = scan_hits(codes, n, dt, EOS, cap_mb, 512)
    assert long.shape == (2 + cap_mb + 2 * 512,)
    assert decode(long.numpy(), cap_mb, 512, P, tables.lengths, n) == \
        decode(short.numpy(), 256, 512, P, tables.lengths, n)
    assert int(scan_hits(codes, n, dt, EOS, 1, 512)[0]) == int(short[0]) > 1
    assert int(scan_hits(codes, n, dt, EOS, 256, 1)[1]) == int(short[1]) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1])
def test_cuda_kernel_matches_plain(db, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tables = _tables(db)
    dt = device_tables(tables, k, k > 0, "cuda")
    codes = torch.from_numpy(db.codes).cuda()
    for n in (len(db.codes), len(db.codes) - 1000):
        before = scan_occupancy.launches
        got = scan_occupancy(codes, dt.weights16, dt.thresholds, n, EOS)
        want = scan_occupancy_ref(codes, dt.weights16, dt.thresholds, n, EOS)
        torch.cuda.synchronize()
        assert scan_occupancy.launches == before + 1
        assert torch.equal(got, want)
