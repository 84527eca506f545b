"""The k-edit filter engine's scan in blocks (``SellersScanner``
past ``_KEDIT_BLOCK`` positions, which a whole genome takes on the card).

On the CPU, with the plain PyTorch versions of the Myers and Sellers
kernels and ``_KEDIT_BLOCK`` lowered to 4,096 positions, a seeded genome
of four blocks with 1- and 2-edit copies of the primers planted across
each block seam, ending inside each halo and starting inside it: the
filter engine's hits in blocks equal its hits in one scan and the plain
reference's (``gpubench/reference/filter.py``); the candidate sets of
``scan_pairs``, ``scan_pairs_stream`` and ``scan`` equal the unblocked
ones; the counters ``scan.blocks``, ``cand.verify_in`` and
``cand.verify_ok`` equal counts made by hand.  Both kinds: Myers (primers
of at most 31 bases, more than one launch's words) and Sellers (longer
primers).  A ``cuda`` case holds the blocked kernels against the plain
ones on the card.
"""

import numpy as np
import pytest
import torch

from gpubench.reference import Reference
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
)
from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
from sequence_alignment_tools_tpu_torch.utils import trace

TABLE = b"ACGT\n"
EOS = 4
K = 2
BLOCK = 4096
N = 3 * BLOCK + 1500           # four blocks, the last one short
ENTRY = 3001                   # an end of sequence every ENTRY positions
SEARCH = {"engine": "filter", "k": K, "indels": True, "rev_comp": True}
# (primer lengths, the kernel that takes them)
KINDS = {"myers": ([16, 17, 18, 19, 20, 21, 22, 23] * 3, "myers"),
         "sellers": ([32, 35, 38, 40], "sellers")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edited(p: str, edits: int, rng) -> str:
    """``p`` with a substitution, then (for 2) an insertion."""
    i = int(rng.integers(2, len(p) - 2))
    p = p[:i] + "ACGT"[("ACGT".index(p[i]) + 1) % 4] + p[i + 1:]
    if edits > 1:
        j = int(rng.integers(2, len(p) - 2))
        p = p[:j] + "ACGT"[int(rng.integers(4))] + p[j:]
    return p


def genome(kind: str, seed: int):
    """(db, primers, planted): a random genome with copies of the
    primers planted at every seam of the blocks: one ending inside the
    next block's halo (2 edits) and one starting there and straddling the
    seam (1 edit); ``planted`` their (end, pattern id)."""
    rng = np.random.default_rng(seed)
    lengths, _ = KINDS[kind]
    pats = ["".join("ACGT"[c] for c in rng.integers(0, 4, ln))
            for ln in lengths]
    codes = rng.integers(0, 4, N).astype(np.uint8)
    eos_at = np.arange(0, N, ENTRY)
    codes[eos_at] = EOS
    planted = []
    i = 0
    for seam in range(BLOCK, N, BLOCK):
        for place, edits in (("halo_end", 2), ("straddle", 1)):
            p = pats[i % len(pats)]
            copy = edited(p, edits, rng)
            start = (seam - 3 - len(copy) if place == "halo_end"
                     else seam - 2)
            codes[start:start + len(copy)] = [TABLE.index(c.encode())
                                              for c in copy]
            planted.append((start + len(copy), i % len(pats) + 1))
            i += 1
    db = SeqDB(codes=codes, table=TABLE, entry_starts=eos_at + 1,
               entry_lengths=np.minimum(ENTRY - 1, N - eos_at - 1),
               headers=[f"e{j}" for j in range(len(eos_at))])
    return db, pats, planted


def model(db, pats):
    m = PrimerMatchModel(db, build_pattern_set(pats, rev_comp=True), k=K,
                         mesh=None, device="cpu")
    m.use_host = False          # the plain versions of the kernels
    assert m.engine == "filter"
    return m


def rows(hits) -> np.ndarray:
    r = np.array([(h.end, h.pid, h.alignment.editdist()) for h in hits],
                 np.int64).reshape(-1, 3)
    return r[np.lexsort((r[:, 2], r[:, 1], r[:, 0]))]


def scanner(db, pats, block=None):
    sc = SellersScanner(build_tables(build_pattern_set(pats, rev_comp=True),
                                     db, wc=False, textn=False),
                        k=K, device="cpu")
    sc.use_host = False
    if block:
        sc._KEDIT_BLOCK = block
    return sc


def pairs(ends, pids):
    return set(zip(ends.tolist(), pids.tolist()))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_blocked_hits_equal_one_scan_and_the_reference(monkeypatch, kind,
                                                       seed):
    db, pats, planted = genome(kind, seed)
    whole = rows(model(db, pats).hits())
    monkeypatch.setattr(SellersScanner, "_KEDIT_BLOCK", BLOCK)
    monkeypatch.setenv("SAT_ROUTE_VERBOSE", "1")
    m = model(db, pats)
    sc = m._filter_ctx()[0]
    assert sc._kind(N) == KINDS[kind][1]
    assert len(sc._blocks(N)) == 4
    blocked = rows(m.hits())
    assert sc._routes_done and all("blocked: 4 blocks" in r
                                   for r in sc._routes_done)
    want = Reference(db.codes, db.table, "cpu").answer(SEARCH, pats)
    assert np.array_equal(blocked, whole)
    assert np.array_equal(blocked, want)
    # every planted copy is found, at its end or within 2k + 1 of it
    for end, pid in planted:
        assert any(r[1] == pid and abs(r[0] - end) <= 2 * K + 1
                   for r in blocked.tolist()), (end, pid)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_blocked_candidates_equal_one_scan(kind):
    db, pats, planted = genome(kind, 3)
    one = scanner(db, pats)
    ends, pids = one.scan_pairs(db.codes)
    want = pairs(ends, pids)
    assert len(want) == len(ends)
    assert all((e, p - 1) in want for e, p in planted)
    sc = scanner(db, pats, BLOCK)
    got_e, got_p = sc.scan_pairs(db.codes)
    assert got_e.dtype == np.int64
    assert len(got_e) == len(ends) and pairs(got_e, got_p) == want
    # the stream, three arrays deep, of a blocked array and a short one
    short = db.codes[:BLOCK // 2]
    se, sp = one.scan_pairs(short)
    got = list(sc.scan_pairs_stream(iter([db.codes, short, db.codes]),
                                    depth=3))
    assert [i for i, _e, _p in got] == [0, 1, 2]
    for i, e, p in got:
        assert pairs(e, p) == (pairs(se, sp) if i == 1 else want)
        assert len(e) == (len(se) if i == 1 else len(ends))
    # scan's (end, pid, mindist) stream, in order (the Sellers kernel)
    assert list(sc.scan(db.codes)) == list(one.scan(db.codes))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_counters_match_hand_counts(monkeypatch, kind):
    db, pats, _planted = genome(kind, 4)
    monkeypatch.setattr(SellersScanner, "_KEDIT_BLOCK", BLOCK)
    names = ("scan.blocks", "cand.verify_in", "cand.verify_ok")
    before = {c: trace.total(c) for c in names}
    m = model(db, pats)
    engine = list(m.engine_hits())
    grew = {c: trace.total(c) - v for c, v in before.items()}
    # the candidates again (four more blocks), clustered by hand: per
    # pattern, cut where two successive ends lie more than 2k + 1 apart
    ends, pids = m._filter_ctx()[0].scan_pairs(db.codes)
    order = np.lexsort((ends, pids))
    e, p = ends[order], pids[order]
    new = np.ones(len(e), bool)
    new[1:] = (p[1:] != p[:-1]) | (e[1:] - e[:-1] > 2 * K + 1)
    assert grew["scan.blocks"] == 4
    assert trace.total("scan.blocks") - before["scan.blocks"] == 8
    assert grew["cand.verify_in"] == int(new.sum()) > 0
    assert grew["cand.verify_ok"] == len(engine) > 0
    # an unblocked scan counts no block
    b0 = trace.total("scan.blocks")
    scanner(db, pats, N).scan_pairs(db.codes)
    assert trace.total("scan.blocks") == b0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cuda_blocked_kernels_equal_plain(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    db, pats, planted = genome(kind, 5)
    want_e, want_p = scanner(db, pats).scan_pairs(db.codes)
    sc = SellersScanner(build_tables(build_pattern_set(pats, rev_comp=True),
                                     db, wc=False, textn=False),
                        k=K, device="cuda")
    sc.use_host = False
    sc._KEDIT_BLOCK = BLOCK
    assert sc._kind(N) == KINDS[kind][1]
    launches = f"launch.{'myers_pairs' if kind == 'myers' else 'sellers_scan'}"
    before = trace.total(launches)
    got_e, got_p = sc.scan_pairs(db.codes)
    assert trace.total(launches) > before
    assert pairs(got_e, got_p) == pairs(want_e, want_p)
    assert len(got_e) == len(want_e)
    assert all((e, p - 1) in pairs(got_e, got_p) for e, p in planted)
