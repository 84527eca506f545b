"""The census keyed by prefixes: exact literal sets past 2,048 patterns
whose longest pattern the int64 base-alpha register cannot hold.

``ConvScanner`` enters a pattern longer than the key K (the longest with
K * log2(alpha) < 62) under the code of its first K codes and verifies
the rest of each candidate on the host after the fetch.  On the CPU, with
the host machines off (``use_host = False``), the census runs its plain
version ``scan_slots_ref``.  Over a protein database (the I = L alphabet,
2,100 peptides of 7 to 45 residues, K = 14) and a DNA database (2,100
probes of 20 to 60 bases, K = 26), both from ``make_synthetic_fasta``,
with copies planted for a pattern and its extension (one key), a
duplicate pattern, an end of sequence right after a copy's first K codes
and a key that ends at the array's last position:

- the hits equal the same scanner's pattern-blocked rung and the JAX
  package's scanner (its native shift-and machine, over groups of
  patterns that its state holds);
- the route line names the prefix census;
- ``census.prefix_in`` and ``census.prefix_ok`` equal counts made by
  hand;
- the gated routes keep their own: ``scan_gated`` of at most 2,048 such
  patterns takes the filter and ``seed_gate``, the whole set is not
  offered to the slot gate, and ``scan_seed_arrays`` drops its gate.

A DNA set past a prefix bound (2,100 probes behind one 30-base adapter,
or one probe past ``_PREFIX_LMAX``) keeps the pattern-blocked rung; with
the bounds lifted the prefix census finds the same hits, its verify cut
into chunks.

The card's case is ``tests/test_torch_prefix_census_cuda.py``.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.ops.conv_scan import (
    ConvScanner as JaxScanner,
)
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import PatternSet
from sequence_alignment_tools_tpu_torch.io.translate import apply_charmap
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.gate import ExtendGate, GateTables
from sequence_alignment_tools_tpu_torch.ops.tables import (
    PatternTables,
    build_tables,
)
from sequence_alignment_tools_tpu_torch.utils import trace
from tests.conftest import make_synthetic_fasta

AAS = "ACDEFGHIKLMNPQRSTVWY"
TOTAL = (1 << 18) + 6_000  # past the census rung's 2^18 floor
# (alphabet, shortest, longest pattern, the census key, charmap)
KINDS = {"protein": (AAS, 7, 45, 14, 2), "dna": ("ACGT", 20, 60, 26, 0)}


def literal_tables(db, pats):
    ps = PatternSet(patterns=[""] + pats, esb=[0] * (len(pats) + 1),
                    eeb=[0] * (len(pats) + 1), n_forward=len(pats))
    return build_tables(ps, db, wc=False, textn=False)


def prefix_scanner(tables, device="cpu"):
    sc = ConvScanner(tables, k=0, device=device)
    sc.use_host = False
    return sc


def fold(rows, alpha):
    """The base-alpha code of each row of ``rows`` [m, L]."""
    code = np.zeros(len(rows), np.int64)
    for j in range(rows.shape[1]):
        code = code * alpha + rows[:, j]
    return code


def window_codes(codes, L, alpha):
    """The base-alpha code of every window of ``L`` codes."""
    return fold(np.lib.stride_tricks.sliding_window_view(
        np.asarray(codes, np.int64), L), alpha)


def jax_grouped(tables, codes, group=96):
    """The JAX package's scanner over groups of ``group`` patterns (each
    on its native shift-and machine), merged to the global (start,
    pattern) order."""
    out = []
    for off in range(0, tables.P, group):
        sl = slice(off, min(off + group, tables.P))
        sub = PatternTables(match=tables.match[sl],
                            lengths=tables.lengths[sl],
                            pat_codes=tables.pat_codes[sl], Lmax=tables.Lmax,
                            alpha=tables.alpha, eos_code=tables.eos_code,
                            code_chars=tables.code_chars)
        ref = JaxScanner(sub, k=0)
        ref.use_host = True
        assert ref._host_eligible(len(codes))
        out += [(end - int(sub.lengths[p]), off + p, end, m)
                for end, p, m in ref.scan(codes)]
    out.sort()
    return [(end, pid, m) for _s, pid, end, m in out]


def build_case(tmp, kind):
    """(codes, tables, named pattern ids): the database's codes less its
    last end of sequence, so the last code is the last letter."""
    letters, lo, hi, key, charmap = KINDS[kind]
    rng = np.random.default_rng(41)

    def rand(m):
        return "".join(rng.choice(list(letters), m))

    path = str(tmp / f"{kind}.fasta")
    make_synthetic_fasta(path, n_entries=4, total=TOTAL, seed=43,
                         alphabet=letters)
    ends = np.cumsum(SeqDB.from_fasta(path).entry_lengths)

    def site(at, m):
        """The first of at, at + 997, ... whose m letters lie in one
        entry."""
        while np.searchsorted(ends, at, "right") != np.searchsorted(
                ends, at + m - 1, "right"):
            at += 997
        return at

    base = rand(key + 4)
    ext = base + rand(6)
    other = next(c for c in letters if c != ext[len(base)])
    eos_pat, dup = rand(key + 5), rand(key + 8)
    end_pat = rand(key)
    end_pat += end_pat[-1] * 3  # its tail: the key's last letter again
    planted = [(site(5_000, len(ext)), ext),        # base, ext: one key
               (site(9_000, len(ext)), base + other),  # ext's tail fails
               (site(13_000, len(dup)), dup),
               (int(ends[0]) - key, eos_pat[:key]),  # an EOS after the key
               (TOTAL - key, end_pat[:key])]  # the key ends the array
    seq = make_synthetic_fasta(path, n_entries=4, total=TOTAL, seed=43,
                               planted=planted, alphabet=letters)
    db = apply_charmap(SeqDB.from_fasta(path), charmap)
    pats = [base, ext, eos_pat, end_pat, dup]
    while len(pats) < 2_100:
        L = int(rng.integers(lo, hi + 1))
        at = int(rng.integers(20_000, TOTAL - 2 * hi))
        pats.append(seq[at : at + L])
    pats += [seq[16_000 : 16_000 + hi], dup]  # the longest; dup again
    tables = literal_tables(db, pats)
    names = {"base": 0, "ext": 1, "eos": 2, "end": 3,
             "dup": (4, len(pats) - 1)}
    return db.codes[:-1], tables, names


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prefix_census")
    return {kind: build_case(tmp, kind) for kind in KINDS}


def open_gate(tables, k=1):
    """Gate tables that pass every window of four codes."""
    S = tables.P
    return GateTables(np.ones((S, 4, tables.alpha), bool), np.full(S, 4),
                      np.ones(S), np.zeros(S), k, k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_prefix_census_matches(cases, kind, monkeypatch):
    codes, tables, names = cases[kind]
    n = len(codes)
    key = KINDS[kind][3]
    sc = prefix_scanner(tables)
    assert sc._census_key() == key < tables.Lmax
    assert tables.P > sc._PBLOCK and not sc._radix_eligible()
    assert sc.census_serves(codes)
    # the plants: a key with an EOS after it, a key that ends the array
    keys = window_codes(codes, key, tables.alpha)
    code_of = fold(np.asarray(tables.pat_codes[:, :key], np.int64),
                   tables.alpha)
    eos_at = np.flatnonzero(keys == code_of[names["eos"]])
    assert len(eos_at) == 1 and codes[eos_at[0] + key] == tables.eos_code
    assert np.flatnonzero(keys == code_of[names["end"]]).tolist() == [n - key]

    seen = []
    monkeypatch.setattr(sc, "_route", seen.append)
    before = (trace.total("census.prefix_in"),
              trace.total("census.prefix_ok"))
    got = list(sc.scan(codes))
    assert seen == ["census kernel (%d patterns, prefix-keyed at %d; plain "
                    "PyTorch, CPU)" % (tables.P, key)]
    want = jax_grouped(tables, codes)
    assert got == want
    assert list(sc._scan_pblocked(codes)) == want

    # hand counts: every key occurrence of a longer pattern, and its hits
    longer = np.flatnonzero(tables.lengths > key)
    ordered = np.sort(keys)
    found = (np.searchsorted(ordered, code_of[longer], "right")
             - np.searchsorted(ordered, code_of[longer], "left"))
    hand_ok = sum(1 for _e, p, _m in want if tables.lengths[p] > key)
    assert trace.total("census.prefix_in") - before[0] == int(found.sum())
    assert trace.total("census.prefix_ok") - before[1] == hand_ok
    assert int(found.sum()) - hand_ok >= 3

    starts = {}
    for end, p, _m in got:
        starts.setdefault(p, []).append(end - int(tables.lengths[p]))
    assert len(starts[names["base"]]) >= 2
    assert set(starts[names["ext"]]) < set(starts[names["base"]])
    d0, d1 = names["dup"]
    assert starts[d0] == starts[d1] and starts[d0]
    assert names["eos"] not in starts and names["end"] not in starts

    # the gated routes: the slot gate never sees a prefix-keyed set
    gate = open_gate(tables)
    assert not sc.gated_available(n)
    with pytest.raises(ValueError, match="needs literal seeds"):
        sc.scan_gated(codes, gate, True, 1)
    ends, pids = sc.scan_seed_arrays(codes, ext_gate=ExtendGate(gate, True))
    assert list(zip(ends.tolist(), pids.tolist())) == [(e, p)
                                                       for e, p, _m in got]
    few = PatternTables(match=tables.match[: sc._PBLOCK],
                        lengths=tables.lengths[: sc._PBLOCK],
                        pat_codes=tables.pat_codes[: sc._PBLOCK],
                        Lmax=tables.Lmax, alpha=tables.alpha,
                        eos_code=tables.eos_code)
    small = prefix_scanner(few)
    gseen = []
    monkeypatch.setattr(small, "_route", gseen.append)
    head = codes[:4_096]
    anchors, sids = small.scan_gated(head, open_gate(few), True, 1)
    assert gseen == ["gated seed scan + extension gate (plain PyTorch, "
                     "CPU)"]
    exact = {(e, p) for e, p, _m in small.scan(head)}
    assert set(zip(anchors.tolist(), sids.tolist())) <= exact


def bounded_case(tmp, kind):
    """(codes, tables, planted (start, pid)) of a DNA set past a prefix
    bound: ``shared``, 2,100 probes of 40 to 60 bases behind one 30-base
    adapter (one key shared past ``_PREFIX_CHAIN``); ``long``, 2,099
    probes of 20 to 60 bases and one a base past ``_PREFIX_LMAX``.  Three
    probes longer than the key are planted, the longest among them."""
    rng = np.random.default_rng(53)

    def rand(m):
        return "".join(rng.choice(list("ACGT"), m))

    if kind == "shared":
        adapter = rand(30)
        pats = [adapter + rand(int(rng.integers(10, 31)))
                for _ in range(2_100)]
    else:
        pats = [rand(int(rng.integers(20, 61))) for _ in range(2_099)]
        pats.append(rand(ConvScanner._PREFIX_LMAX + 1))
    key = 26  # the census key over DNA
    picks = [p for p, s in enumerate(pats) if len(s) > key][:2]
    picks.append(len(pats) - 1)
    planted = [(5_000 + 9_000 * i, pats[p]) for i, p in enumerate(picks)]
    path = str(tmp / f"bounded_{kind}.fasta")
    make_synthetic_fasta(path, n_entries=1, total=TOTAL, seed=59,
                         planted=planted)
    db = SeqDB.from_fasta(path)
    # the codes open with an end of sequence: a plant at ``at`` starts at
    # ``at + 1``
    return (db.codes[:-1], literal_tables(db, pats),
            [(at + 1, p) for (at, _s), p in zip(planted, picks)])


@pytest.fixture(scope="module")
def bounded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prefix_bounds")
    return {kind: bounded_case(tmp, kind) for kind in ("shared", "long")}


def exact_hits(codes, tables):
    """Every exact hit as (end, pid, 0) in (start, pid) order, by a
    substring search per pattern over the codes' bytes."""
    text = np.asarray(codes, np.uint8).tobytes()
    out = []
    for p in range(tables.P):
        pat = np.asarray(tables.pat_codes[p, : tables.lengths[p]],
                         np.uint8).tobytes()
        at = text.find(pat)
        while at >= 0:
            out.append((at, p))
            at = text.find(pat, at + 1)
    return [(s + int(tables.lengths[p]), p, 0) for s, p in sorted(out)]


@pytest.mark.parametrize("kind", ["shared", "long"])
def test_prefix_bounds_keep_pblocked(bounded, kind, monkeypatch):
    """A set past a prefix bound keeps the pattern-blocked rung (over the
    shared adapter it runs, and its hits equal a substring search; past
    the length bound only its route line is read, the plain fused pass
    over 257-base columns being slow on the CPU), and the prefix census,
    with the bounds lifted and the verify cut into small chunks, finds
    the substring search's hits."""
    codes, tables, planted = bounded[kind]
    want = exact_hits(codes, tables)
    assert set(planted) <= {(e - int(tables.lengths[p]), p)
                            for e, p, _m in want}
    sc = prefix_scanner(tables)
    assert sc._census_key() == 26 < tables.Lmax
    assert tables.P > sc._PBLOCK and sc._literal()
    assert not sc._prefix_keyable() and not sc.census_serves(codes)
    seen = []
    monkeypatch.setattr(sc, "_route", seen.append)
    if kind == "long":
        monkeypatch.setattr(sc, "_scan_pblocked", lambda codes: iter(()))
    got = list(sc.scan(codes))
    assert seen == ["pattern-blocked scan pipeline (%d patterns, 2 blocks)"
                    % tables.P]
    if kind == "shared":
        assert got == want

    forced = prefix_scanner(tables)
    monkeypatch.setattr(forced, "_PREFIX_LMAX", 1 << 20)
    monkeypatch.setattr(forced, "_PREFIX_CHAIN", 1 << 20)
    monkeypatch.setattr(forced, "_VERIFY_ELEMS", 1 << 12)
    assert forced.census_serves(codes)
    before = trace.total("census.prefix_in")
    assert list(forced.scan(codes)) == want
    shared = trace.total("census.prefix_in") - before
    assert shared >= (3 * tables.P if kind == "shared" else len(planted))
