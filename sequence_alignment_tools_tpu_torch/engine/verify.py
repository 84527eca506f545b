"""Per-hit alignment verification (host side).

Faithful reimplementation of the reference's ``pattern_alignment`` family —
``exact_alignment`` (pattern_alignment.cc:29-43), ``exact_wc_alignment``
(:70-93) and the banded anchored ``editdist_alignment`` (:117-705) — since
final hit reporting must reproduce its scoring, end-position selection,
tie-breaking and traceback *exactly*:

- right-anchored reversed DP over window ``[poslb - patlen - k, posub)``;
  row band ±k (±1 in dna_mut mode);
- row 0 free for the trailing ``posub - poslb`` text columns (the candidate
  end range);
- constraint-violation penalty ``5k+1``; early exit when a row's min > k;
- best end: scan t upward from ``patlen-k``; replace on strictly-better
  score OR equal score with a diagonal op in the cell mask (prefers the
  *earliest* end position reachable by a diagonal op);
- traceback prefers diagonal ops but keeps gap runs together via the
  ``lastac`` continuation rules (pattern_alignment.cc:543-585).

Only *candidates* are verified (thousands, not millions), so a tight numpy/
Python implementation on host is the right tool; the bulk filtering runs on
the TPU (see ops/).

The port's copy of ``sequence_alignment_tools_tpu/engine/verify.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.iupac import compat_matrix
from ..utils.aa import aasubdist_matrix

MAXINT = 0xFFFFFFFF

# alignment codes (alignment_code.h:6-20)
A_NONE = 0
A_EQUAL = 1
A_WC_EQUAL = 2
A_SUB = 3
A_INS = 4
A_DEL = 5
A_CONST_VIOL = 6
A_END = 7
A_SUB1 = 8
A_SUB2 = 9
A_SUB3 = 10
A_INS3 = 11
A_DEL3 = 12
N_CODES = 13

# op-mask bits (alignment_code.h:22-36)
M_NONE = 1
M_EQUAL = 2
M_WC = 4
M_SUB = 8
M_INS = 16
M_DEL = 32
M_CV = 64
M_END = 128
M_SUB1 = 256
M_SUB2 = 512
M_SUB3 = 1024
M_INS3 = 2048
M_DEL3 = 4096

_DIAG = M_EQUAL | M_WC | M_SUB | M_SUB1 | M_SUB2 | M_SUB3
_SUBS = M_SUB | M_SUB1 | M_SUB2 | M_SUB3
_INSM = M_INS | M_INS3
_DELM = M_DEL | M_DEL3

_ALIGN_CHAR = {
    A_EQUAL: "|", A_WC_EQUAL: "+", A_SUB: "*", A_SUB1: ".", A_SUB2: ":",
    A_SUB3: "x", A_INS: "^", A_INS3: "^", A_DEL: "v", A_DEL3: "v",
    A_CONST_VIOL: "!",
}


@dataclass
class Alignment:
    """Result mirroring pattern_alignment's queryable state."""

    end: int  # flat position one past the last matched char
    found: bool = False
    value: int = 0  # DP score (pa.value())
    start: int = 0
    matching_text: str = ""
    codes: list[int] = field(default_factory=list)
    stats: np.ndarray = field(default_factory=lambda: np.zeros(N_CODES, np.int64))

    @property
    def length(self) -> int:
        """end - start + 1 — note: one more than len(matching_text)
        (pattern_alignment.h:96-98)."""
        return self.end - self.start + 1

    def editdist(self) -> int:
        """Edit distance from alignment stats (pattern_alignment.h:108-123)."""
        if self.stats[A_CONST_VIOL] > 0:
            return MAXINT
        return int(
            self.stats[A_SUB] + self.stats[A_SUB1] + 2 * self.stats[A_SUB2]
            + 3 * self.stats[A_SUB3] + self.stats[A_INS]
            + 3 * self.stats[A_INS3] + self.stats[A_DEL]
            + 3 * self.stats[A_DEL3]
        )

    def alignment_string(self) -> str:
        return "".join(_ALIGN_CHAR.get(c, " ") for c in self.codes)

    def alignment_text(self) -> str:
        out, p = [], 0
        for c in self.codes:
            if c in (A_DEL, A_DEL3):
                out.append("-")
            else:
                out.append(self.matching_text[p])
                p += 1
        return "".join(out)

    def alignment_pattern(self, pat: str) -> str:
        out, p = [], 0
        for c in self.codes:
            if c in (A_INS, A_INS3):
                out.append("-")
            else:
                out.append(pat[p])
                p += 1
        return "".join(out)


def exact_align(end: int, pat: str) -> Alignment:
    """exact_alignment::align (pattern_alignment.cc:29-43)."""
    a = Alignment(end=end, found=True, value=0)
    a.matching_text = pat
    a.start = end - len(pat)
    a.codes = [A_EQUAL] * len(pat)
    a.stats[A_EQUAL] = len(pat)
    return a


def exact_wc_align(end: int, pat: str, text: str, textn: bool) -> Alignment:
    """exact_wc_alignment::align (pattern_alignment.cc:70-93): re-reads the
    text window and marks equal vs wildcard-equal per position."""
    a = Alignment(end=end, found=True, value=0)
    a.matching_text = text
    a.start = end - len(pat)
    compat = compat_matrix()
    for pc, tc in zip(pat, text):
        if pc == tc:
            a.codes.append(A_EQUAL)
            a.stats[A_EQUAL] += 1
        elif compat[ord(pc), ord(tc)] and (tc != "N" or textn):
            a.codes.append(A_WC_EQUAL)
            a.stats[A_WC_EQUAL] += 1
        else:  # shouldn't happen for true hits
            a.codes.append(A_SUB)
            a.stats[A_SUB] += 1
    return a


class EditDistAligner:
    """Reusable editdist_alignment (one instance per engine run).

    ``text_at(start, length)`` must return raw characters for flat positions
    [start, start+length) — the TPU pipeline serves it from the in-memory
    SeqDB (the reference seeks the CharacterProducer,
    pattern_alignment.cc:179-198).
    """

    def __init__(
        self,
        k: int,
        eos: str,
        wc: bool = False,
        textn: bool = False,
        indels: bool = True,
        dna_mut: bool = False,
        yesno: bool = False,
        trans: bool = False,
    ):
        self.k = k
        self.eos = eos
        self.wc = wc
        self.textn = textn
        self.indels = indels
        self.dna_mut = dna_mut
        self.yesno = yesno
        # trans: codon-aware substitution costs (aacodonsubdist) — the text
        # stream supplies a codon id per AA position (pattern_alignment.cc:329)
        self.trans = trans
        self._compat = compat_matrix()
        self._aasub = aasubdist_matrix() if dna_mut else None
        if dna_mut and trans:
            from ..utils.aa import aacodonsubdist_matrix

            self._aacodonsub = aacodonsubdist_matrix()
        self._native = None
        self._native_bufs = None
        from ..native import load_verify_lib

        lib = load_verify_lib()
        if lib is not None:
            self._native = lib
            import ctypes

            cap = 1 << 12
            self._native_bufs = (
                (ctypes.c_int32 * 1)(), (ctypes.c_int32 * 1)(),
                (ctypes.c_int32 * 1)(), (ctypes.c_int32 * 1)(),
                (ctypes.c_int32 * cap)(), (ctypes.c_int32 * 1)(),
                (ctypes.c_int64 * N_CODES)(), cap,
            )

    # NOTE: band() is the reference's (indels_?(dna_mut_?1:k_):0) expression
    def _band(self) -> int:
        if not self.indels:
            return 0
        return 1 if self.dna_mut else self.k

    def align(
        self,
        text_at,
        pat: str,
        poslb: int,
        posub: int,
        esb: int = 0,
        eeb: int = 0,
        codon_at=None,
    ) -> Alignment:
        """editdist_alignment::align (pattern_alignment.cc:117-705).

        poslb/posub = end()/end2_ — the candidate end-position range
        (inclusive); esb/eeb = exact start/end base constraints (lconst_/
        rconst_).
        """
        k = self.k
        band = self._band()
        patlen = len(pat)
        end = poslb
        textstart = end - patlen - k if end > patlen + k else 0
        buflen = posub - textstart
        buffer = text_at(textstart, buflen)
        assert len(buffer) == buflen
        cids = None
        cid_rev = None
        if self.dna_mut and self.trans:
            cids = codon_at(textstart, buflen)
            cid_rev = cids[::-1]  # cid_rev[t-1] == cids[buflen-t]

        if self._native is not None:
            return self._align_native(pat, buffer, cids, end, posub, esb, eeb)

        cvp = 5 * k + 1  # const_viol_penalty
        # exact-base constraint rows in reversed-p space
        lbexact = 0
        rbexact = patlen + 1
        if esb > 0:
            rbexact = patlen + 1 - esb
        if eeb > 0:
            lbexact = eeb

        P, T = patlen + 1, buflen + 1
        dp = np.full((P, T), MAXINT, dtype=np.int64)
        best = np.zeros((P, T), dtype=np.int32)
        dp[0, 0] = 0
        best[0, 0] = M_END

        gapc = 3 if self.dna_mut else 1

        ub = min(band, patlen)
        for p in range(1, ub + 1):
            if (not self.indels or p < lbexact or p >= rbexact
                    or pat[patlen - p] == self.eos):
                dp[p, 0] = cvp
                best[p, 0] = M_CV
            else:
                dp[p, 0] = dp[p - 1, 0] + gapc
                best[p, 0] = M_DEL3 if self.dna_mut else M_DEL
        free = posub - end
        ub = min(free + band, buflen)
        for t in range(1, ub + 1):
            if t <= free:
                dp[0, t] = 0
                best[0, t] = M_END
            elif not self.indels or lbexact > 0:
                dp[0, t] = cvp
                best[0, t] = M_CV
            else:
                dp[0, t] = dp[0, t - 1] + gapc
                best[0, t] = M_INS3 if self.dna_mut else M_INS

        pat_rev = pat[::-1]  # pat_rev[p-1] == pat[patlen-p]
        buf_rev = buffer[::-1]  # buf_rev[t-1] == buffer[buflen-t]
        compat = self._compat
        for p in range(1, patlen + 1):
            pc = pat_rev[p - 1]
            lb = max(1, p - band)
            ub = min(p + free + band, buflen)
            bestrow = cvp
            for t in range(lb, ub + 1):
                tc = buf_rev[t - 1]
                # diagonal
                if tc == pc:
                    v = dp[p - 1, t - 1]
                    ac = M_EQUAL
                elif (self.wc and compat[ord(pc), ord(tc)]
                      and (tc != "N" or self.textn)):
                    v = dp[p - 1, t - 1]
                    ac = M_WC
                elif (tc == self.eos or pc == self.eos
                      or p <= lbexact or p >= rbexact):
                    v = cvp
                    ac = M_CV
                else:
                    if not self.dna_mut:
                        v = dp[p - 1, t - 1] + 1
                        ac = M_SUB
                    else:
                        # aasubdist(text_char, pattern_char) — note arg order
                        # (pattern_alignment.cc:329-345); trans mode anchors
                        # the text char to its actual codon
                        if self.trans:
                            cid = int(cid_rev[t - 1])
                            mut = (
                                int(self._aacodonsub[ord(tc), cid, ord(pc)])
                                if 0 <= cid < 6 else -1
                            )
                        else:
                            mut = int(self._aasub[ord(tc), ord(pc)])
                        if mut >= 0:
                            v = dp[p - 1, t - 1] + mut
                            ac = (M_SUB1, M_SUB2, M_SUB3)[mut - 1]
                        else:
                            v = cvp
                            ac = M_CV
                # insertion (extra text char)
                if (tc == self.eos or pc == self.eos or not self.indels
                        or t <= lb or p < lbexact or p >= rbexact):
                    if cvp < v:
                        v = cvp
                        ac = M_CV
                else:
                    v1 = dp[p, t - 1] + gapc
                    im = M_INS3 if self.dna_mut else M_INS
                    if v1 < v:
                        v = v1
                        ac = im
                    elif v1 == v:
                        ac |= im
                # deletion (pattern char unmatched)
                if (not self.indels or pc == self.eos or t >= ub
                        or p <= lbexact or p >= rbexact):
                    if cvp < v:
                        v = cvp
                        ac = M_CV
                else:
                    v1 = dp[p - 1, t] + gapc
                    dm = M_DEL3 if self.dna_mut else M_DEL
                    if v1 < v:
                        v = v1
                        ac = dm
                    elif v1 == v:
                        ac |= dm
                dp[p, t] = v
                best[p, t] = ac
                if v < bestrow:
                    bestrow = v
            if bestrow > k:
                a = Alignment(end=end, found=False)
                if not self.yesno:
                    a.codes.append(A_CONST_VIOL)
                    a.stats[A_CONST_VIOL] += 1
                return a

        # best end selection (pattern_alignment.cc:443-475)
        beststart = patlen - band
        beststart = min(beststart, buflen)
        beststart = max(beststart, 0)
        bestval = int(dp[patlen, beststart])
        ub = min(patlen + free + band, buflen)
        for t in range(beststart + 1, ub + 1):
            v = int(dp[patlen, t])
            if v < bestval or (v <= bestval and (best[patlen, t] & _DIAG)):
                bestval = v
                beststart = t

        p, t = patlen, beststart
        if t < p - band or t > p + band + free:
            a = Alignment(end=end, found=False)
            if not self.yesno:
                a.codes.append(A_CONST_VIOL)
                a.stats[A_CONST_VIOL] += 1
            return a

        # traceback (pattern_alignment.cc:494-597)
        codes: list[int] = []
        stats = np.zeros(N_CODES, dtype=np.int64)
        lastac = A_NONE
        while not (best[p, t] & M_END):
            ac = int(best[p, t])
            match = bool(ac & _DIAG)
            wc = bool(ac & M_WC)
            sub = bool(ac & _SUBS)
            ins = bool(ac & _INSM)
            dele = bool(ac & _DELM)
            if match and not (
                (lastac in (A_INS, A_INS3) and ins)
                or (lastac in (A_DEL, A_DEL3) and dele)
                or (lastac == A_WC_EQUAL and not wc and (ins or dele))
            ):
                p -= 1
                t -= 1
                if (ac & M_EQUAL) and not (
                    (lastac == A_WC_EQUAL and wc)
                    or (lastac == A_SUB and sub)
                ):
                    lastac = A_EQUAL
                elif wc:
                    lastac = A_WC_EQUAL
                elif sub:
                    if ac & M_SUB:
                        lastac = A_SUB
                    elif ac & M_SUB1:
                        lastac = A_SUB1
                    elif ac & M_SUB2:
                        lastac = A_SUB2
                    else:
                        lastac = A_SUB3
            elif dele:
                p -= 1
                lastac = A_DEL if (ac & M_DEL) else A_DEL3
            elif ins:
                t -= 1
                lastac = A_INS if (ac & M_INS) else A_INS3
            elif ac & M_CV:
                p = 0
                t = 0
                lastac = A_CONST_VIOL
            else:  # pragma: no cover
                raise AssertionError("bad traceback cell")
            if not self.yesno:
                stats[lastac] += 1
                codes.append(lastac)

        endt = t
        mt = buffer[buflen - beststart : buflen - endt]
        a = Alignment(end=0, found=bestval <= k)
        a.codes = codes
        a.stats = stats
        a.matching_text = mt
        a.start = posub - beststart
        a.end = a.start + len(mt)
        a.value = bestval
        return a


def _native_tables():
    """ctypes views of the shared cost tables (built once)."""
    global _NATIVE_TABLES
    try:
        return _NATIVE_TABLES
    except NameError:
        pass
    import ctypes

    from ..utils.aa import aacodonsubdist_matrix, aasubdist_matrix

    compat = np.ascontiguousarray(compat_matrix().astype(np.uint8))
    aasub = np.ascontiguousarray(aasubdist_matrix())
    aacodon = np.ascontiguousarray(aacodonsubdist_matrix())
    _NATIVE_TABLES = (
        compat, aasub, aacodon,
        compat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        aasub.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        aacodon.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return _NATIVE_TABLES


def _align_native(self, pat, buffer, cids, end, posub, esb, eeb):
    """Dispatch to the C++ DP (native/verify_dp.cpp); identical semantics."""
    import ctypes

    tables = _native_tables()
    found, bestval, bs, endt, codes_buf, ncodes, stats_buf, cap = \
        self._native_bufs
    buflen = len(buffer)
    if cids is not None:
        cid_arr = (ctypes.c_int8 * buflen)(*[int(c) for c in cids])
    else:
        cid_arr = None
    ok = self._native.sat_verify_align(
        pat.encode("latin-1"), len(pat),
        buffer.encode("latin-1"), buflen,
        cid_arr,
        self.k, ord(self.eos), int(self.wc), int(self.textn),
        int(self.indels), int(self.dna_mut), int(self.trans),
        int(self.yesno), esb, eeb, posub - end,
        tables[3], tables[4], tables[5],
        found, bestval, bs, endt, codes_buf, cap, ncodes, stats_buf,
    )
    assert ok == 1
    n = int(ncodes[0])
    if n > cap:  # traceback longer than the scratch buffer: redo in Python
        saved, self._native = self._native, None
        try:
            textstart = end - len(pat) - self.k if end > len(pat) + self.k \
                else 0
            return self.align(
                lambda s, l: buffer[s - textstart : s - textstart + l],
                pat, end, posub, esb, eeb,
                codon_at=(
                    (lambda s, l: cids[s - textstart : s - textstart + l])
                    if cids is not None else None
                ),
            )
        finally:
            self._native = saved
    if int(bs[0]) < 0:  # early exit / band failure
        a = Alignment(end=end, found=False)
        if not self.yesno:
            a.codes = [int(codes_buf[i]) for i in range(n)]
            a.stats = np.ctypeslib.as_array(stats_buf).copy()
        return a
    beststart = int(bs[0])
    endt_v = int(endt[0])
    mt = buffer[buflen - beststart : buflen - endt_v]
    a = Alignment(end=0, found=bool(found[0]))
    if not self.yesno:
        a.codes = [int(codes_buf[i]) for i in range(n)]
        a.stats = np.ctypeslib.as_array(stats_buf).copy()
    a.matching_text = mt
    a.start = posub - beststart
    a.end = a.start + len(mt)
    a.value = int(bestval[0])
    return a


EditDistAligner._align_native = _align_native


class BatchVerifier:
    """Batched yes/no editdist verify over candidate ARRAYS — one native
    call per array instead of one ctypes round-trip (plus Python window
    decode) per candidate (the hash_table.cc:144-226 / filter_bitvec.cc
    cluster-verify host hot loop).

    Patterns (with their esb/eeb constraints) register once as seed ids;
    candidates are (sid, poslb, posub) arrays.  Returns (found, end, value)
    arrays identical to per-candidate :meth:`EditDistAligner.align` with
    ``yesno=True`` (the native batch loops the same DP; the Python fallback
    literally calls it)."""

    def __init__(self, aligner: EditDistAligner, db, pats, esb, eeb):
        self.aligner = aligner
        self.db = db
        self.pats = list(pats)
        blob = "".join(self.pats).encode("latin-1")
        self._patblob = np.frombuffer(blob, dtype=np.uint8).copy()
        if len(self._patblob) == 0:
            self._patblob = np.zeros(1, dtype=np.uint8)
        lens = np.fromiter((len(p) for p in self.pats), np.int32,
                           len(self.pats))
        self.pat_len = lens
        self.pat_off = np.zeros(len(self.pats), np.int32)
        if len(self.pats):
            self.pat_off[1:] = np.cumsum(lens[:-1])
        self.esb = np.ascontiguousarray(esb, dtype=np.int32)
        self.eeb = np.ascontiguousarray(eeb, dtype=np.int32)
        if db.decode_chars is not None:
            self._codes = np.ascontiguousarray(db.decode_chars,
                                               dtype=np.uint8)
            self._ch_of = np.arange(256, dtype=np.uint8)
        else:
            self._codes = np.ascontiguousarray(db.codes, dtype=np.uint8)
            tbl = np.frombuffer(db.table, dtype=np.uint8)
            self._ch_of = np.zeros(256, np.uint8)
            self._ch_of[: len(tbl)] = tbl

    def __call__(self, sids, poslb, posub):
        import ctypes

        al = self.aligner
        C = len(sids)
        sids = np.ascontiguousarray(sids, dtype=np.int32)
        poslb = np.ascontiguousarray(poslb, dtype=np.int64)
        posub = np.ascontiguousarray(posub, dtype=np.int64)
        found = np.zeros(C, np.int32)
        start = np.zeros(C, np.int64)
        end = np.zeros(C, np.int64)
        val = np.zeros(C, np.int32)
        if al._native is not None and not (al.dna_mut and al.trans) and C:
            tables = _native_tables()
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)

            def p32(a):
                return a.ctypes.data_as(i32p)

            def p64(a):
                return a.ctypes.data_as(i64p)

            r = al._native.sat_verify_align_batch(
                self._codes.ctypes.data_as(u8p), len(self._codes),
                self._ch_of.ctypes.data_as(u8p),
                self._patblob.ctypes.data_as(u8p),
                p32(self.pat_off), p32(self.pat_len),
                p32(self.esb), p32(self.eeb),
                p64(poslb), p64(posub), p32(sids), C,
                al.k, ord(al.eos), int(al.wc), int(al.textn),
                int(al.indels), int(al.dna_mut),
                tables[3], tables[4],
                p32(found), p64(start), p64(end), p32(val),
            )
            if r != 1:
                raise RuntimeError("sat_verify_align_batch failed")
            return found.astype(bool), end, val
        # fallback: per-candidate align through a window text_at
        n = len(self._codes)
        chars = self._ch_of
        codes = self._codes
        eos = al.eos

        def text_at(s, ln):
            s0 = max(0, s)
            e0 = min(s0 + ln, n)
            w = chars[codes[s0:e0]].tobytes().decode("latin-1")
            if len(w) < ln:
                w = w + eos * (ln - len(w))
            return w

        for i in range(C):
            s = int(sids[i])
            a = al.align(text_at, self.pats[s], int(poslb[i]),
                         int(posub[i]), esb=int(self.esb[s]),
                         eeb=int(self.eeb[s]))
            found[i] = a.found
            end[i] = a.end
            val[i] = a.value
        return found.astype(bool), end, val


def sort_pairs_stdsort(keys, vals):
    """std::sort permutation on (key, payload) with a key-only comparator —
    the reference's candidate-batch normalize order (an UNSTABLE introsort;
    equal keys land in libstdc++'s specific order, pinned by parity tests).
    Native when available; falls back to utils.introsort."""
    from ..native import load_verify_lib

    lib = load_verify_lib()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    if lib is not None:
        import ctypes

        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sat_sort_pairs(keys.ctypes.data_as(i64p),
                           vals.ctypes.data_as(i64p), len(keys))
        return keys, vals
    from ..utils.introsort import introsort

    items = [[int(k), int(v)] for k, v in zip(keys, vals)]
    introsort(items, lambda a, b: a[0] < b[0])
    return (np.fromiter((it[0] for it in items), np.int64, len(items)),
            np.fromiter((it[1] for it in items), np.int64, len(items)))
