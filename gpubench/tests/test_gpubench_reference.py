"""The plain reference against brute force at tiny sizes (end of
sequence codes, both strands, indels, I/L), and against the program on
the CPU."""

import numpy as np
import pytest

from gpubench.databases import Database
from gpubench.reference import Reference, compare
from gpubench.reference.halves import anchored_edits, extend_align
from gpubench.reference.scan import reverse_complement

DNA = b"ACGT\n"


def text_of(codes, table):
    return bytes(np.frombuffer(table, np.uint8)[codes]).decode()


def edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def sellers(text: str, pat: str) -> np.ndarray:
    """Least edit distance of ``pat`` against any text window ending at
    each position (index = end), windows never holding an end of
    sequence; Sellers' columns, one pattern row at a time."""
    out = np.full(len(text) + 1, 10**9, np.int64)
    at = 0
    for piece in text.split("\n"):
        t = np.frombuffer(piece.encode(), np.uint8)
        row = np.zeros(len(t) + 1, np.int64)
        idx = np.arange(len(t) + 1)
        for i, ch in enumerate(pat.encode(), start=1):
            diag = row[:-1] + (t != ch)
            new = np.concatenate([[i], np.minimum(diag, row[1:] + 1)])
            row = np.minimum.accumulate(new - idx) + idx
        out[at:at + len(t) + 1] = row
        at += len(t) + 1
    return out


def best_ending_at(text: str, pat: str, end: int, k: int) -> int:
    """Least edit distance of ``pat`` against a text window ending at
    ``end`` that holds no end of sequence, within k of the length."""
    best = 10**9
    for ln in range(max(len(pat) - k, 1), len(pat) + k + 1):
        s = end - ln
        if s >= 0 and "\n" not in text[s:end]:
            best = min(best, edit_distance(pat, text[s:end]))
    return best


def low_entropy_db(seed, n=1 << 14, entry=257):
    rng = np.random.default_rng(seed)
    codes = rng.choice(4, n, p=[0.4, 0.4, 0.1, 0.1]).astype(np.uint8)
    eos = np.arange(0, n, entry + 1)
    codes[eos] = 4
    starts = eos + 1
    return Database(codes, DNA, starts, np.minimum(entry, n - starts))


def draw_patterns(db, rng, count):
    text = text_of(db.codes, db.table)
    pats = []
    while len(pats) < count:
        ln = int(rng.integers(12, 24))
        s = int(rng.integers(0, len(text) - ln))
        p = text[s:s + ln]
        if "\n" in p:
            continue
        if rng.random() < 0.5:      # an edited copy of a database piece
            i = int(rng.integers(1, ln - 1))
            p = p[:i] + "ACGT"[int(rng.integers(4))] + p[i + 1:]
        pats.append(p)
    return pats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_hits_match_a_plain_string_search(seed):
    db = low_entropy_db(seed)
    rng = np.random.default_rng(seed + 10)
    pats = draw_patterns(db, rng, 12) + ["ACGTACGTAC"]
    text = text_of(db.codes, db.table)
    ref = Reference(db.codes, db.table, "cpu")
    got = ref.answer({"engine": "exact", "k": 0, "rev_comp": True}, pats)
    full = pats + [reverse_complement(p) for p in pats]
    want = []
    for pid, p in enumerate(full, start=1):
        at = text.find(p)
        while at >= 0:
            want.append((at + len(p), pid, 0))
            at = text.find(p, at + 1)
    assert sorted(map(tuple, got.tolist())) == sorted(want)


def test_exact_hits_fold_i_and_l():
    table = b"ACDEFGHIKLMNPQRSTVWY\n"
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 20, 4000).astype(np.uint8)
    codes[::400] = 20
    db_text = text_of(codes, table)
    pats = []
    for s in range(7, 3900, 311):
        p = db_text[s:s + 9]
        if "\n" not in p:
            pats.append(p.replace("I", "#").replace("L", "I").replace(
                "#", "L"))
    ref = Reference(codes, table, "cpu")
    got = ref.answer({"engine": "exact", "k": 0, "charmap": 2}, pats)
    folded = db_text.replace("I", "L")
    want = []
    for pid, p in enumerate(pats, start=1):
        q = p.replace("I", "L")
        at = folded.find(q)
        while at >= 0:
            want.append((at + len(q), pid, 0))
            at = folded.find(q, at + 1)
    assert sorted(map(tuple, got.tolist())) == sorted(want)
    assert len(want) >= len(pats)
    # without the map, a swapped I/L is not found
    plain = ref.answer({"engine": "exact", "k": 0, "charmap": 0}, pats)
    assert len(plain) < len(want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_halves_hits_sound_and_complete_by_brute_force(seed):
    db = low_entropy_db(seed)
    rng = np.random.default_rng(seed + 20)
    pats = draw_patterns(db, rng, 8)
    text = text_of(db.codes, db.table)
    k = 1
    got = Reference(db.codes, db.table, "cpu").answer(
        {"engine": "halves", "k": k, "indels": True, "rev_comp": True}, pats)
    full = pats + [reverse_complement(p) for p in pats]
    # sound: each hit's edits are the least edit distance ending there
    for end, pid, ed in got.tolist():
        assert ed <= k
        assert best_ending_at(text, full[pid - 1], end, k) == ed
    # complete: every end of an occurrence within k edits lies within 4k
    # of a hit of its pattern (one hit stands for a cluster of ends)
    ends = {}
    for end, pid, _ in got.tolist():
        ends.setdefault(pid, []).append(end)
    for pid, p in enumerate(full, start=1):
        for e in np.flatnonzero(sellers(text, p) <= k).tolist():
            assert any(abs(e - h) <= 4 * k for h in ends.get(pid, []))


def scalar_extend(text, pat, k, eos):
    """One candidate of :func:`extend_align`, cell by cell."""
    ok, used, val = extend_align(np.array([text]), np.array([pat]), k, True,
                                 eos)
    return bool(ok[0]), int(used[0]), int(val[0])


def test_extension_prefers_a_later_diagonal_end():
    # pattern ACGT against ACGA + C: a substitution at t = 4 (diagonal)
    # ties a deletion at t = 3; the diagonal end is taken
    c = {ch: i for i, ch in enumerate("ACGT\n")}
    text = [c[x] for x in "ACGAC"]
    pat = [c[x] for x in "ACGT"]
    assert scalar_extend(text, pat, 1, 4) == (True, 4, 1)
    # an end of sequence in the way takes no substitution
    text = [c[x] for x in "AC\nTT"]
    assert scalar_extend(text, pat, 1, 4)[0] is False


def test_anchored_edits_against_brute_force():
    rng = np.random.default_rng(7)
    for _ in range(200):
        m = int(rng.integers(6, 12))
        pat = rng.integers(0, 4, m)
        text = rng.integers(0, 4, m + 1)
        text[-m:] = np.where(rng.random(m) < 0.15, rng.integers(0, 4, m),
                             pat)
        got = int(anchored_edits(text[None], pat[None], 1, True, 4)[0])
        ts = "".join("ACGT"[x] for x in text)
        ps = "".join("ACGT"[x] for x in pat)
        want = best_ending_at(ts, ps, len(ts), 1)
        assert (got if got <= 1 else None) == (want if want <= 1 else None)


@pytest.mark.parametrize("seed", [5, 6])
def test_reference_equals_the_program_on_the_cpu(seed):
    from gpubench.entries.primer_match_model import Program

    db = low_entropy_db(seed, n=1 << 15)
    rng = np.random.default_rng(seed + 30)
    pats = draw_patterns(db, rng, 20)
    search = {"engine": "halves", "k": 1, "indels": True, "rev_comp": True}
    program = Program(db, search, ["cpu"])
    got = program.rows(program.query(pats))
    want = Reference(db.codes, db.table, "cpu").answer(search, pats)
    assert len(want) > 0
    assert compare(got, want) == (0, 0)


def test_compare_counts_multisets():
    a = np.array([[5, 1, 0], [5, 1, 0], [9, 2, 1]])
    b = np.array([[5, 1, 0], [9, 2, 0]])
    assert compare(a, b) == (1, 2)
    assert compare(b, b) == (0, 0)


def plant(codes, table, pat: str, start: int) -> None:
    codes[start:start + len(pat)] = [table.index(c.encode()) for c in pat]


def planted_db(codes, table, pats, block, eos_every, edit=False):
    """``codes`` with EOS every ``eos_every`` positions and copies of the
    patterns planted: each block boundary straddled by one (pattern i at
    the boundaries i, i + len(pats), ...; its first half straddles it
    too), one of each ending at an entry's end and one at the end of the
    text; the database and the (end, pattern index) of each copy that no
    later one overwrote.  With ``edit``, each copy has its second half's
    middle letter substituted, so that only its first half seeds it."""
    if edit:
        alpha = table[:-1].decode()
        pats = [p[:len(p) * 3 // 4]
                + alpha[(alpha.index(p[len(p) * 3 // 4]) + 1) % len(alpha)]
                + p[len(p) * 3 // 4 + 1:] for p in pats]
    codes = codes.copy()
    n = len(codes)
    eos = len(table) - 1
    eos_at = np.arange(0, n, eos_every)
    codes[eos_at] = eos
    at = [(b - len(pats[j % len(pats)]) // 4 - 1, j % len(pats))
          for j, b in enumerate(range(block, n, block))]
    at += [(eos_at[3 + 4 * i] - len(p), i) for i, p in enumerate(pats)]
    at += [(n - len(pats[-1]), len(pats) - 1)]
    for s, i in at:
        if not (codes[s:s + len(pats[i])] == eos).any():
            plant(codes, table, pats[i], s)
    want = [(s + len(pats[i]), i) for s, i in at
            if [table[c] for c in codes[s:s + len(pats[i])]]
            == list(pats[i].encode())]
    starts = eos_at + 1
    return Database(codes, table, starts, np.minimum(eos_every - 1,
                                                     n - starts)), want


def blocked_and_whole(monkeypatch, db, search, pats):
    from gpubench.reference import scan

    whole = Reference(db.codes, db.table, "cpu").answer(search, pats)
    monkeypatch.setattr(scan, "BLOCK", 3001)
    blocked = Reference(db.codes, db.table, "cpu").answer(search, pats)
    return blocked, whole


@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_halves_equal_one_block(monkeypatch, seed):
    rng = np.random.default_rng(seed + 40)
    base = rng.choice(4, 40_000, p=[0.4, 0.4, 0.1, 0.1]).astype(np.uint8)
    pats = ["".join("ACGT"[c] for c in rng.integers(0, 4, m))
            for m in (13, 18, 22)]
    db, want = planted_db(base, DNA, pats, 3001, 997, edit=True)
    search = {"engine": "halves", "k": 1, "indels": True, "rev_comp": True}
    blocked, whole = blocked_and_whole(monkeypatch, db, search, pats)
    assert np.array_equal(blocked, whole)
    got = {(e, p) for e, p, _ed in whole.tolist()}
    assert len(want) >= 12
    assert any(e == len(db) for e, _i in want)
    assert all((e, i + 1) in got for e, i in want)


@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_exact_with_i_and_l_equal_one_block(monkeypatch, seed):
    table = b"ACDEFGHIKLMNPQRSTVWY\n"
    rng = np.random.default_rng(seed + 50)
    base = rng.integers(0, 20, 40_000).astype(np.uint8)
    # 9 codes fit one key; 15 and 19 have their rest compared on the host
    pats = ["".join(table.decode()[c] for c in rng.integers(0, 20, m))
            for m in (9, 15, 19)]
    pats = [p[:3] + "IL" + p[5:] for p in pats]
    db, want = planted_db(base, table, pats, 3001, 997)
    swapped = [p.replace("I", "#").replace("L", "I").replace("#", "L")
               for p in pats]
    search = {"engine": "exact", "k": 0, "charmap": 2}
    blocked, whole = blocked_and_whole(monkeypatch, db, search, swapped)
    assert np.array_equal(blocked, whole)
    got = {(e, p) for e, p, _ed in whole.tolist()}
    assert len(want) >= 12
    assert any(e == len(db) for e, _i in want)
    assert all((e, i + 1) in got for e, i in want)
