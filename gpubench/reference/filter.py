"""Reference of ``primer_match -k k`` through the filter engine (the
EdwardsLab suite's ``filter_bitvec``: ``-k`` with indels where neither
pigeonhole engine takes the patterns, e.g. k = 2 on primers).

1. Candidates: every (end, pattern) such that some text window ending
   there, holding no end of sequence, lies within k edits of the pattern
   (Levenshtein).  A window within k edits of a pattern of m >= W + k
   letters is at least W long, and its first W letters are those of an
   edited copy of the pattern's first W + k letters; every such W-letter
   prefix is listed by applying up to k single edits to them
   (:func:`prefix_keys`).  The text's W-letter windows are looked up
   among those keys on the device, block by block as ``scan.py`` scans,
   and each window found is aligned from its start on the host
   (:func:`ends_from`): a banded edit distance of the pattern against the
   text from there, every end within k edits kept.
2. Clusters: per pattern, its candidate ends in order, cut where two
   successive ends lie more than 2k + 1 apart.
3. Verify: the suite's yes/no alignment of each cluster
   (:func:`verify_clusters`): the pattern against the text that ends at
   the cluster's last end, read from the right, any end from the first to
   the last free; its end is the one the suite's traceback reaches.
4. Final alignment: the least edit distance of the pattern against a
   text ending exactly there (``halves.anchored_edits``), reported where
   it is at most k.

Departures from the suite: it forms batches as its scan streams and
defers the clusters that may still grow; that changes only the order in
which clusters are verified, not the clusters, so the reference forms
them over the whole candidate set at once.  It handles the suite's
default pattern options alone: no exact-base constraints (``-s``, ``-e``,
``-5``, ``-3``), no wildcards, no DNA-mutation costs.
"""

from __future__ import annotations

import numpy as np
import torch

from .halves import anchored_edits
from .scan import (
    _blocks,
    _matches,
    _window_keys,
    gather,
    pattern_codes,
    reverse_complement,
    rows,
)

MAXINT = 0xFFFFFFFF
# the suite's alignment op bits
M_EQUAL, M_SUB, M_INS, M_DEL, M_CV, M_END = 2, 8, 16, 32, 64, 128
DIAG = M_EQUAL | M_SUB
A_NONE, A_EQUAL, A_SUB, A_INS, A_DEL = 0, 1, 3, 4, 5


def answer(ref, search: dict, patterns: list[str]) -> np.ndarray:
    return filter_hits(ref.codes_t, ref.codes, ref.table, patterns,
                       int(search["k"]), bool(search.get("indels", True)),
                       bool(search.get("rev_comp")), ref.eos)


def _edit_once(rows_, lens, owner, alpha: int, pad: int, indels: bool):
    """Every string one edit (a substitution, identity included, or with
    ``indels`` an insertion or a deletion) from each row: (rows, lengths,
    owners).  Rows are [N, D] codes, ``pad`` past each length; an
    insertion needs the row's last slot free."""
    n, d = rows_.shape
    wide = np.concatenate([rows_, np.full((n, 1), pad, rows_.dtype)], 1)
    j = np.arange(d)
    out, out_len, out_own = [], [], []
    # substitutions
    at = np.repeat(np.arange(d), alpha)
    to = np.tile(np.arange(alpha), d)
    sub = np.repeat(rows_[:, None, :], len(at), 1)
    sub[:, np.arange(len(at)), at] = to
    ok = at[None, :] < lens[:, None]
    out.append(sub[ok])
    out_len.append(np.broadcast_to(lens[:, None], ok.shape)[ok])
    out_own.append(np.broadcast_to(owner[:, None], ok.shape)[ok])
    if not indels:
        return out[0], out_len[0], out_own[0]
    # deletions
    i = np.arange(d)[:, None]
    dele = wide[:, np.where(j[None, :] < i, j[None, :], j[None, :] + 1)]
    ok = (np.arange(d)[None, :] < lens[:, None]) & (lens[:, None] > 1)
    out.append(dele[ok])
    out_len.append(np.broadcast_to(lens[:, None] - 1, ok.shape)[ok])
    out_own.append(np.broadcast_to(owner[:, None], ok.shape)[ok])
    # insertions
    src = np.where(j[None, :] < i, j[None, :], np.maximum(j[None, :] - 1, 0))
    ins = np.repeat(wide[:, src][:, :, None, :], alpha, 2)  # [N, R, A, D]
    ins[:, np.arange(d), :, np.arange(d)] = np.arange(alpha)
    ok = (np.arange(d)[None, :] <= lens[:, None]) \
        & (lens[:, None] < d)
    ok = np.repeat(ok[:, :, None], alpha, 2)
    out.append(ins[ok])
    out_len.append(np.broadcast_to(lens[:, None, None] + 1, ok.shape)[ok])
    out_own.append(np.broadcast_to(owner[:, None, None], ok.shape)[ok])
    return (np.concatenate(out), np.concatenate(out_len),
            np.concatenate(out_own))


def _unique_rows(rows_, lens, owner):
    """One row per (string, length, pattern)."""
    whole = np.ascontiguousarray(np.concatenate(
        [rows_, lens[:, None].astype(np.uint8),
         owner.astype("<u4").view(np.uint8).reshape(-1, 4)], 1))
    _, first = np.unique(whole.view(np.dtype((np.void, whole.shape[1]))),
                         return_index=True)
    return rows_[first], lens[first], owner[first]


def prefix_keys(pats: list[np.ndarray], width: int, k: int, alpha: int,
                bits: int, indels: bool = True):
    """(keys, owners): the int64 key (``bits`` a code, the first code
    highest) of every ``width``-letter prefix of a string within k edits
    (substitutions alone without ``indels``) of each pattern's first
    ``width + k`` letters, with the pattern's index; unique pairs."""
    d = width + 2 * k
    pad = alpha
    rows_ = np.full((len(pats), d), pad, np.uint8)
    for i, p in enumerate(pats):
        rows_[i, :width + k] = p[:width + k]
    lens = np.full(len(pats), width + k, np.int64)
    owner = np.arange(len(pats), dtype=np.int64)
    for j in range(1, k + 1):
        rows_, lens, owner = _edit_once(rows_, lens, owner, alpha, pad,
                                        indels)
        if j < k:
            rows_, lens, owner = _unique_rows(rows_, lens, owner)
    keys = np.zeros(len(rows_), np.int64)
    for c in range(width):
        keys = (keys << bits) | rows_[:, c]
    order = np.lexsort((keys, owner))
    keys, owner = keys[order], owner[order]
    new = np.ones(len(keys), bool)
    new[1:] = (keys[1:] != keys[:-1]) | (owner[1:] != owner[:-1])
    return keys[new], owner[new]


def ends_from(codes_t, starts, pats, pidx, k: int, eos: int,
              indels: bool = True):
    """(ends, pattern index) of every window starting at a start, holding
    no end of sequence, within k edits of its pattern (the whole window
    against the whole pattern, each text letter before the pattern's
    first an insertion); without ``indels``, the windows of the
    pattern's length within k substitutions.  Vectorised over the starts
    of each pattern length on the codes' device."""
    dev = codes_t.device
    n = codes_t.shape[0]
    lens = np.array([len(p) for p in pats], np.int64)[pidx]
    out_e, out_p = [], []
    for m in np.unique(lens):
        m = int(m)
        g = np.flatnonzero(lens == m)
        width = m + k
        at = torch.as_tensor(starts[g], device=dev)[:, None] \
            + torch.arange(width, device=dev)
        inside = (at >= 0) & (at < n)
        text = torch.where(inside, codes_t[at.clamp(0, n - 1)].long(), eos)
        pat = torch.as_tensor(np.stack([pats[i] for i in pidx[g]]),
                              device=dev)
        # the windows [0, j) that hold no end of sequence
        clean = torch.cumsum(text == eos, 1) == 0
        if not indels:
            ok = ((text[:, :m] != pat).sum(1) <= k) & clean[:, m - 1]
            out_e.append(starts[g][ok.cpu().numpy()] + m)
            out_p.append(pidx[g][ok.cpu().numpy()])
            continue
        idx = torch.arange(width + 1, device=dev)
        row = idx.expand(len(g), width + 1)
        for i in range(1, m + 1):
            diag = row[:, :-1] + (text != pat[:, i - 1:i]).long()
            new = torch.cat([torch.full((len(g), 1), i, device=dev),
                             torch.minimum(diag, row[:, 1:] + 1)], 1)
            row = torch.cummin(new - idx, 1).values + idx
        for j in range(max(m - k, 1), m + k + 1):
            ok = ((row[:, j] <= k) & clean[:, j - 1]).cpu().numpy()
            out_e.append(starts[g][ok] + j)
            out_p.append(pidx[g][ok])
    if not out_e:
        z = np.zeros(0, np.int64)
        return z, z
    return np.concatenate(out_e), np.concatenate(out_p)


def candidates(codes_t, codes_np, pats: list[np.ndarray], k: int,
               indels: bool, alpha: int, eos: int):
    """Unique (ends, pattern index) of the k-edit candidate set (k
    substitutions without ``indels``), ordered by pattern, then end (see
    the module's notes, step 1)."""
    bits = max(1, int(alpha - 1).bit_length())
    width = min(min(len(p) for p in pats) - k, 63 // bits)
    keys, owner = prefix_keys(pats, width, k, alpha - 1, bits, indels)
    uniq, inv = np.unique(keys, return_inverse=True)
    starts, pidx = [], []
    for b0, m, block in _blocks(codes_t, width, eos):
        key = _window_keys(block, m, width, bits)
        s, p = _matches(key, width, width, bits, uniq, inv, owner)
        starts.append(s + b0)
        pidx.append(p)
        del key
    ends, pp = ends_from(codes_t, np.concatenate(starts),
                         pats, np.concatenate(pidx).astype(np.int64), k,
                         eos, indels)
    pair = np.unique(np.stack([pp, ends], 1), axis=0)
    return pair[:, 1], pair[:, 0]


def verify_clusters(codes_np, pats, pidx, poslb, posub, k: int,
                    indels: bool, eos: int):
    """The suite's yes/no ``editdist_alignment`` of each cluster, for C
    clusters at once: (found, end) arrays.

    The window is the text from ``poslb - m - k`` (0 where that is not
    positive) to ``posub``, read from the right against the reversed
    pattern; row 0 is free for the ``posub - poslb`` last columns (the
    candidate ends); the band is k (0 without indels); a cell of an end of
    sequence takes no substitution or insertion, at the penalty 5k + 1; a
    row whose band holds nothing within k fails.  The best cell of the
    last row is the first of least cost, moved on to a later one of no
    greater cost reached by a diagonal step; the traceback from it prefers
    the diagonal but keeps a gap run going, and the column where it
    reaches row 0 gives the end."""
    C = len(pidx)
    if not C:
        z = np.zeros(0, np.int64)
        return z.astype(bool), z
    band = k if indels else 0
    cvp = 5 * k + 1
    m = np.array([len(pats[i]) for i in pidx], np.int64)
    tstart = np.where(poslb > m + k, poslb - m - k, 0)
    buflen = posub - tstart
    free = posub - poslb
    M, T = int(m.max()), int(buflen.max())
    # reversed text and pattern, padded with an end of sequence (a pad
    # cell is never inside a candidate's band)
    buf = gather(codes_np, tstart, T, eos)
    brev = np.full((C, T), eos, np.int64)
    prev = np.full((C, M), eos + 1, np.int64)
    for c in range(C):
        brev[c, :buflen[c]] = buf[c, :buflen[c]][::-1]
        prev[c, :m[c]] = pats[pidx[c]][::-1]
    dp = np.full((M + 1, T + 1, C), MAXINT, np.int64)
    best = np.zeros((M + 1, T + 1, C), np.int64)
    ar = np.arange(C)
    dp[0, 0] = 0
    best[0, 0] = M_END
    for p in range(1, min(band, M) + 1):
        on = p <= m
        dp[p, 0] = np.where(on, dp[p - 1, 0] + 1, MAXINT)
        best[p, 0] = np.where(on, M_DEL, 0)
    for t in range(1, T + 1):
        on = t <= np.minimum(free + band, buflen)
        rest = np.where(indels, dp[0, t - 1] + 1, cvp)
        dp[0, t] = np.where(on, np.where(t <= free, 0, rest), MAXINT)
        best[0, t] = np.where(on, np.where(
            t <= free, M_END, M_INS if indels else M_CV), 0)
    alive = np.ones(C, bool)
    for p in range(1, M + 1):
        row_on = p <= m
        lb = max(1, p - band)
        ub = np.minimum(p + free + band, buflen)
        bestrow = np.full(C, cvp, np.int64)
        pc = prev[:, p - 1]
        for t in range(lb, int(ub.max()) + 1 if len(ub) else lb):
            on = row_on & (t <= ub)
            if not on.any():
                continue
            tc = brev[:, t - 1]
            eq = tc == pc
            up_left = dp[p - 1, t - 1]
            v = np.where(eq, up_left, np.where(tc == eos, cvp, up_left + 1))
            ac = np.where(eq, M_EQUAL, np.where(tc == eos, M_CV, M_SUB))
            # insertion: the text letter unmatched
            no_ins = (tc == eos) | (not indels) | (t <= lb)
            v1 = dp[p, t - 1] + 1
            ac = np.where(no_ins, np.where(cvp < v, M_CV, ac),
                          np.where(v1 < v, M_INS,
                                   np.where(v1 == v, ac | M_INS, ac)))
            v = np.where(no_ins, np.minimum(v, cvp), np.minimum(v, v1))
            # deletion: the pattern letter unmatched
            no_del = (not indels) | (t >= ub)
            v1 = dp[p - 1, t] + 1
            ac = np.where(no_del, np.where(cvp < v, M_CV, ac),
                          np.where(v1 < v, M_DEL,
                                   np.where(v1 == v, ac | M_DEL, ac)))
            v = np.where(no_del, np.minimum(v, cvp), np.minimum(v, v1))
            dp[p, t] = np.where(on, v, dp[p, t])
            best[p, t] = np.where(on, ac, best[p, t])
            bestrow = np.where(on, np.minimum(bestrow, v), bestrow)
        alive &= ~row_on | (bestrow <= k)
    # the best cell of the last row
    bs = np.clip(m - band, 0, buflen)
    bval = dp[m, bs, ar]
    top = np.minimum(m + free + band, buflen)
    for t in range(1, T + 1):
        on = (t > bs) & (t <= top)
        v = dp[np.minimum(m, M), t, ar]
        diag = (best[m, t, ar] & DIAG) != 0
        take = on & ((v < bval) | ((v <= bval) & diag))
        bval = np.where(take, v, bval)
        bs = np.where(take, t, bs)
    found = alive & (bs >= m - band) & (bs <= m + band + free) \
        & (bval <= k)
    # traceback to row 0
    p, t = m.copy(), bs.copy()
    last = np.full(C, A_NONE, np.int64)
    go = found.copy()
    while go.any():
        ac = best[p, t, ar]
        go &= (ac & M_END) == 0
        match = (ac & DIAG) != 0
        ins = (ac & M_INS) != 0
        dele = (ac & M_DEL) != 0
        diag = match & ~((last == A_INS) & ins) & ~((last == A_DEL) & dele)
        step_d = go & diag
        step_del = go & ~diag & dele
        step_ins = go & ~diag & ~dele & ins
        # a constraint cell ends the alignment at the window's right end
        step_cv = go & ~diag & ~dele & ~ins & ((ac & M_CV) != 0)
        last = np.where(step_d, np.where((ac & M_EQUAL) != 0, A_EQUAL,
                                         A_SUB), last)
        last = np.where(step_del, A_DEL, np.where(step_ins, A_INS, last))
        p = np.where(step_cv, 0, p - (step_d | step_del))
        t = np.where(step_cv, 0, t - (step_d | step_ins))
        go &= step_d | step_del | step_ins
    return found, posub - t


def clusters(ends, pidx, k: int):
    """(pattern index, first end, last end) of each cluster: per pattern,
    its ends (given ordered by pattern, then end) cut where two successive
    ones lie more than 2k + 1 apart."""
    if not len(ends):
        z = np.zeros(0, np.int64)
        return z, z, z
    new = np.ones(len(ends), bool)
    new[1:] = (pidx[1:] != pidx[:-1]) | (ends[1:] - ends[:-1] > 2 * k + 1)
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(ends)) - 1
    return pidx[first], ends[first], ends[last]


def filter_hits(codes_t, codes_np, table: bytes, patterns, k: int,
                indels: bool, rev_comp: bool, eos: int) -> np.ndarray:
    """``primer_match -k k [-r]`` through the filter engine (``-K k``
    without ``indels``): see the module's notes."""
    full = list(patterns) + ([reverse_complement(p) for p in patterns]
                             if rev_comp else [])
    pats = pattern_codes(full, table)
    ends, pidx = candidates(codes_t, codes_np, pats, k, indels, len(table),
                            eos)
    cp, lo, hi = clusters(ends, pidx, k)
    found = np.zeros(len(cp), bool)
    aend = np.zeros(len(cp), np.int64)
    # clusters of like width together: the verify's columns follow the
    # widest cluster of a call
    width = (hi - lo).astype(np.int64)
    bucket = np.array([int(w).bit_length() for w in width], np.int64)
    for b in np.unique(bucket):
        g = np.flatnonzero(bucket == b)
        found[g], aend[g] = verify_clusters(codes_np, pats, cp[g], lo[g],
                                            hi[g], k, indels, eos)
    cp, aend = cp[found], aend[found]
    edits = np.full(len(cp), 5 * k + 1, np.int64)
    lens = np.array([len(pats[i]) for i in cp], np.int64)
    for m in np.unique(lens):
        g = np.flatnonzero(lens == m)
        starts = np.maximum(aend[g] - m - k, 0)
        for w in np.unique(aend[g] - starts):
            gg = g[(aend[g] - starts) == w]
            txt = gather(codes_np, aend[gg] - w, int(w), eos)
            pat = np.stack([pats[i] for i in cp[gg]])
            edits[gg] = anchored_edits(txt, pat, k, indels, eos)
    good = edits <= k
    return rows(aend[good], cp[good] + 1, edits[good])
