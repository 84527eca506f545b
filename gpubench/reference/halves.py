"""Reference of ``primer_match -k k`` through the pigeonhole engine that
splits each pattern into two halves (the EdwardsLab suite's
``exact_halves``, ``-k 1`` on DNA).

One half occurs exactly; the other is aligned to the text beside it with
at most k edits by the suite's banded dynamic programme, whose
tie-breaking fixes the reported end; the extensions are taken in the
order the scan meets their seeds (seed end, then half id descending),
and one is kept only where its end lies past its pattern's last kept end
+ 2k; each kept end is aligned once more, right-anchored, and reported
with that edit distance when it is at most k.  The dynamic programmes
run on the host over arrays of candidates.
"""

from __future__ import annotations

import numpy as np

from .scan import gather, occurrences, pattern_codes, reverse_complement, rows

INF = 1 << 30


def answer(ref, search: dict, patterns: list[str]) -> np.ndarray:
    return halves_hits(ref.codes_t, ref.codes, ref.table, patterns,
                       int(search["k"]), bool(search["indels"]),
                       bool(search.get("rev_comp")), ref.eos)


def extend_align(text: np.ndarray, pat: np.ndarray, k: int, indels: bool,
                 eos: int):
    """The suite's anchored extension (``global_align``, yes/no form) of
    ``pat`` against ``text``, both read left to right from the anchor,
    for C candidates at once: ``text`` [C, T], ``pat`` [C, m] codes.
    Returns (ok, text consumed, edits) arrays.

    Banded (band k with indels, else 0) edit distance with the text and
    the pattern both starting at the anchor; a cell reading ``eos`` in the
    text takes no substitution or insertion; a row whose band holds
    nothing within k fails; the end is the first text length of least
    cost in the last row's band, moved on to a later one of no greater
    cost that ends in a diagonal step."""
    C, T = text.shape
    m = pat.shape[1]
    band = k if indels else 0
    cvp = 5 * k + 1
    dp = np.full((m + 1, T + 1, C), INF, np.int64)
    dp[0, 0] = 0
    for p in range(1, min(band, m) + 1):
        dp[p, 0] = dp[p - 1, 0] + 1 if indels else cvp
    for t in range(1, min(band, T) + 1):
        tc = text[:, t - 1]
        dp[0, t] = np.where(tc == eos, cvp, dp[0, t - 1] + 1) \
            if indels else cvp
    alive = np.ones(C, bool)
    diag_last = np.zeros((T + 1, C), bool)
    for p in range(1, m + 1):
        lb, ub = max(1, p - band), min(p + band, T)
        bestrow = np.full(C, cvp, np.int64)
        pc = pat[:, p - 1]
        for t in range(lb, ub + 1):
            tc = text[:, t - 1]
            eq = tc == pc
            diag_ok = eq | (tc != eos)
            diag = np.where(eq, dp[p - 1, t - 1],
                            np.where(diag_ok, dp[p - 1, t - 1] + 1, cvp))
            if indels and t > lb:
                ins = np.where(tc == eos, cvp, dp[p, t - 1] + 1)
            else:
                ins = np.full(C, cvp, np.int64)
            dele = dp[p - 1, t] + 1 if indels and t < ub \
                else np.full(C, cvp, np.int64)
            v = np.minimum(np.minimum(diag, ins), dele)
            dp[p, t] = v
            if p == m:
                diag_last[t] = diag_ok & (diag == v)
            bestrow = np.minimum(bestrow, v)
        alive &= bestrow <= k
    start = max(0, min(m - band, T))
    bestpos = np.full(C, start, np.int64)
    bestval = dp[m, start].copy()
    for t in range(start + 1, min(m + band, T) + 1):
        val = dp[m, t]
        take = (val < bestval) | ((val <= bestval) & diag_last[t])
        bestval = np.where(take, val, bestval)
        bestpos = np.where(take, t, bestpos)
    ok = alive & (bestpos >= m - band) & (bestpos <= m + band)
    return ok, bestpos, bestval


def anchored_edits(text: np.ndarray, pat: np.ndarray, k: int,
                   indels: bool, eos: int) -> np.ndarray:
    """The suite's final alignment (``editdist_alignment`` with the end
    fixed) for C candidates: ``text`` [C, T] the codes up to the hit's
    end, ``pat`` [C, m]; the least edit distance of the pattern against
    a text ending exactly there, within the band, or a value above k
    where there is none.  Both are read from the right end."""
    C, T = text.shape
    m = pat.shape[1]
    band = k if indels else 0
    cvp = 5 * k + 1
    trev = text[:, ::-1]
    prev = pat[:, ::-1]
    dp = np.full((m + 1, T + 1, C), INF, np.int64)
    dp[0, 0] = 0
    for p in range(1, min(band, m) + 1):
        dp[p, 0] = dp[p - 1, 0] + 1 if indels else cvp
    for t in range(1, min(band, T) + 1):
        dp[0, t] = dp[0, t - 1] + 1 if indels else cvp
    alive = np.ones(C, bool)
    for p in range(1, m + 1):
        lb, ub = max(1, p - band), min(p + band, T)
        bestrow = np.full(C, cvp, np.int64)
        pc = prev[:, p - 1]
        for t in range(lb, ub + 1):
            tc = trev[:, t - 1]
            eq = tc == pc
            v = np.where(eq, dp[p - 1, t - 1],
                         np.where(tc == eos, cvp, dp[p - 1, t - 1] + 1))
            if indels and t > lb:
                v = np.minimum(v, np.where(tc == eos, cvp, dp[p, t - 1] + 1))
            else:
                v = np.minimum(v, cvp)
            if indels and t < ub:
                v = np.minimum(v, dp[p - 1, t] + 1)
            else:
                v = np.minimum(v, cvp)
            dp[p, t] = v
            bestrow = np.minimum(bestrow, v)
        alive &= bestrow <= k
    lo = max(0, min(m - band, T))
    if lo < m - band:
        return np.full(C, cvp, np.int64)
    best = dp[m, lo:min(m + band, T) + 1].min(axis=0)
    return np.where(alive, best, cvp)


def halves_hits(codes_t, codes_np, table: bytes, pats, k: int,
                indels: bool, rev_comp: bool, eos: int) -> np.ndarray:
    """``primer_match -k k [-r]`` through the halves engine: see the
    module's docstring."""
    full = list(pats) + ([reverse_complement(p) for p in pats]
                         if rev_comp else [])
    halves, owner = [], []
    for pid, p in enumerate(full, start=1):
        halves += [p[:len(p) // 2], p[len(p) // 2:]]
        owner += [pid, pid]
    hc = pattern_codes(halves, table)
    fc = pattern_codes(full, table)
    anchors, h0 = occurrences(codes_t, codes_np, hc, len(table), eos)
    hid = h0 + 1                      # odd: left half, even: right half
    pid = np.asarray(owner, np.int64)[h0]
    left = hid % 2 == 1
    ok = np.zeros(len(anchors), bool)
    end = np.zeros(len(anchors), np.int64)
    # left half found: extend right over the right half from its end
    # right half found: extend left over the left half, read leftwards
    for is_left in (True, False):
        sel = np.flatnonzero(left == is_left)
        if not len(sel):
            continue
        other = np.where(is_left, hid[sel] + 1, hid[sel] - 1)
        m_of = np.array([len(halves[h - 1]) for h in other])
        if is_left:
            width = m_of + k
            starts = anchors[sel]
        else:
            total = np.array([len(full[q - 1]) for q in pid[sel]]) + k
            right = np.array([len(halves[h - 1]) for h in hid[sel]])
            starts = np.where(anchors[sel] > total, anchors[sel] - total, 0)
            width = anchors[sel] - right - starts
        for m in np.unique(m_of):
            for w in np.unique(width[m_of == m]):
                g = np.flatnonzero((m_of == m) & (width == w))
                txt = gather(codes_np, starts[g], int(w), eos)
                pat = np.stack([hc[h - 1] for h in other[g]])
                if not is_left:
                    txt, pat = txt[:, ::-1], pat[:, ::-1]
                o, used, _v = extend_align(txt, pat, k, indels, eos)
                ok[sel[g]] = o
                end[sel[g]] = (anchors[sel[g]] + used) if is_left \
                    else anchors[sel[g]]
    keep = np.flatnonzero(ok)
    keep = keep[np.lexsort((-hid[keep], anchors[keep]))]
    gap = 2 * k if indels else 0
    last = {}
    kept = []
    for i in keep:
        q, e = int(pid[i]), int(end[i])
        if e > last.get(q, 0) + gap:
            last[q] = e
            kept.append(i)
    kept = np.asarray(kept, np.int64)
    ends, pids = end[kept], pid[kept]
    edits = np.zeros(len(kept), np.int64)
    lens = np.array([len(full[q - 1]) for q in pids], np.int64)
    for m in np.unique(lens):
        g = np.flatnonzero(lens == m)
        starts = np.maximum(ends[g] - m - k, 0)
        for w in np.unique(ends[g] - starts):
            gg = g[(ends[g] - starts) == w]
            txt = gather(codes_np, ends[gg] - w, int(w), eos)
            pat = np.stack([fc[q - 1] for q in pids[gg]])
            edits[gg] = anchored_edits(txt, pat, k, indels, eos)
    good = edits <= k
    return rows(ends[good], pids[good], edits[good])
