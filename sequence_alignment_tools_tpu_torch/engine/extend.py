"""Seed-extension DP: faithful ``primer_alignment::global_align`` and the
lmatch/rmatch anchored extensions (primer_alignment.cc:10-463, 568-728).

Used by the exact_halves / exact_bases pigeonhole engines: an exact seed hit
(found on the MXU) is extended over the remaining pattern with a banded
global DP whose tie-breaking — scan ``t`` upward at the final row, replace on
strictly-better score or equal score with a diagonal op — must match the
reference exactly, because it determines the reported hit end positions.

Only the yes/no path is implemented (engines run with ``yesno=true``,
exact_halves.cc:132-135); full alignments come from the main loop's
re-verification (editdist_alignment in verify.py).

The port's copy of ``sequence_alignment_tools_tpu/engine/extend.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ..utils.iupac import compat_matrix
from ..utils.aa import aasubdist_matrix
from .verify import (
    M_CV,
    M_DEL,
    M_DEL3,
    M_EQUAL,
    M_INS,
    M_INS3,
    M_SUB,
    M_SUB1,
    M_SUB2,
    M_SUB3,
    M_WC,
    _DIAG,
)


class Extender:
    """Shared-parameter extension aligner (one per engine run)."""

    def __init__(self, k: int, eos: str, wc: bool = False, textn: bool = False,
                 indels: bool = True, dna_mut: bool = False):
        self.k = k
        self.eos = eos
        self.wc = wc
        self.textn = textn
        self.indels = indels
        self.dna_mut = dna_mut
        self._compat = compat_matrix()
        self._aasub = aasubdist_matrix() if dna_mut else None
        # native C-ABI DP (one call per pigeonhole seed hit — the k>0
        # host hot loop); pure-Python fallback below
        from ..native import load_verify_lib

        self._native = load_verify_lib()
        if self._native is not None:
            import ctypes

            import numpy as np

            self._c_ok = ctypes.c_int32()
            self._c_ml = ctypes.c_int32()
            self._c_val = ctypes.c_int32()
            cm = np.ascontiguousarray(self._compat, dtype=np.uint8)
            self._c_compat = cm
            self._c_compat_p = cm.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8))
            if self._aasub is not None:
                am = np.ascontiguousarray(self._aasub, dtype=np.int8)
                self._c_aasub = am
                self._c_aasub_p = am.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int8))
            else:
                self._c_aasub_p = None

    def _global_align_native(self, text: str, pattern: str, dirn: int,
                             lmatch: int, rmatch: int):
        import ctypes

        tb = text.encode("latin-1")
        pb = pattern.encode("latin-1")
        r = self._native.sat_extend_align(
            tb, len(tb), pb, len(pb), dirn, lmatch, rmatch,
            self.k, ord(self.eos), int(self.wc), int(self.textn),
            int(self.indels), int(self.dna_mut),
            self._c_compat_p, self._c_aasub_p,
            ctypes.byref(self._c_ok), ctypes.byref(self._c_ml),
            ctypes.byref(self._c_val),
        )
        if r != 1:
            raise RuntimeError("sat_extend_align failed")
        return bool(self._c_ok.value), self._c_ml.value, self._c_val.value

    def _band(self) -> int:
        if not self.indels:
            return 0
        return 1 if self.dna_mut else self.k

    def global_align(self, text: str, pattern: str, dirn: int,
                     lmatch: int, rmatch: int):
        """Returns (ok, matchlen, value) — the yesno path of
        primer_alignment.cc:10-299.  ``lmatch``/``rmatch`` may be <= 0
        (negative residual constraints behave like 0, matching the
        reference's unsigned-wrap-then-int-assign behavior)."""
        k = self.k
        band = self._band()
        textlen = len(text)
        patlen = len(pattern)
        cvp = 5 * k + 1
        lbexact = 0
        rbexact = patlen + 1
        if dirn < 0:
            if lmatch > 0:
                rbexact = patlen + 1 - lmatch
            if rmatch > 0:
                lbexact = rmatch
        else:
            if lmatch > 0:
                lbexact = lmatch
            if rmatch > 0:
                rbexact = patlen + 1 - rmatch
        INF = 1 << 30
        dp = [[INF] * (textlen + 1) for _ in range(patlen + 1)]
        best = [[0] * (textlen + 1) for _ in range(patlen + 1)]
        dp[0][0] = 0
        gapc = 3 if self.dna_mut else 1
        ub = min(band, patlen)
        for p in range(1, ub + 1):
            if not self.indels or p < lbexact or p >= rbexact:
                dp[p][0] = cvp
                best[p][0] = M_CV
            else:
                dp[p][0] = dp[p - 1][0] + gapc
                best[p][0] = M_DEL3 if self.dna_mut else M_DEL
        ub = min(band, textlen)
        for t in range(1, ub + 1):
            textch = text[t - 1] if dirn > 0 else text[textlen - t]
            # NB: reference also tests an uninitialized `patch` here
            # (primer_alignment.cc:95) — garbage is never eos in practice.
            if not self.indels or 0 < lbexact or 0 >= rbexact or textch == self.eos:
                dp[0][t] = cvp
                best[0][t] = M_CV
            else:
                dp[0][t] = dp[0][t - 1] + gapc
                best[0][t] = M_INS3 if self.dna_mut else M_INS
        compat = self._compat
        for p in range(1, patlen + 1):
            lb = max(1, p - band)
            ub = min(p + band, textlen)
            bestrow = cvp
            for t in range(lb, ub + 1):
                if dirn > 0:
                    textch = text[t - 1]
                    patch = pattern[p - 1]
                else:
                    textch = text[textlen - t]
                    patch = pattern[patlen - p]
                if textch == patch:
                    v = dp[p - 1][t - 1]
                    ac = M_EQUAL
                elif (self.wc and compat[ord(textch), ord(patch)]
                      and (self.textn or textch != "N")):
                    v = dp[p - 1][t - 1]
                    ac = M_WC
                elif (textch == self.eos or patch == self.eos
                      or p <= lbexact or p >= rbexact):
                    v = cvp
                    ac = M_CV
                else:
                    if not self.dna_mut:
                        v = dp[p - 1][t - 1] + 1
                        ac = M_SUB
                    else:
                        mut = int(self._aasub[ord(textch), ord(patch)])
                        if mut >= 0:
                            v = dp[p - 1][t - 1] + mut
                            ac = (M_SUB1, M_SUB2, M_SUB3)[mut - 1]
                        else:
                            v = cvp
                            ac = M_CV
                if (textch == self.eos or patch == self.eos or not self.indels
                        or t <= lb or p < lbexact or p >= rbexact):
                    v1 = cvp
                    ac1 = M_CV
                else:
                    v1 = dp[p][t - 1] + gapc
                    ac1 = M_INS3 if self.dna_mut else M_INS
                if v1 < v:
                    v = v1
                    ac = ac1
                elif v1 == v:
                    ac |= ac1
                if not self.indels or t >= ub or p <= lbexact or p >= rbexact:
                    v1 = cvp
                    ac1 = M_CV
                else:
                    # deletions allowed even on eos text chars (:218-220)
                    v1 = dp[p - 1][t] + gapc
                    ac1 = M_DEL3 if self.dna_mut else M_DEL
                if v1 < v:
                    v = v1
                    ac = ac1
                elif v1 == v:
                    ac |= ac1
                dp[p][t] = v
                best[p][t] = ac
                if v < bestrow:
                    bestrow = v
            if bestrow > k:
                return False, 0, 0
        bestpos = max(0, min(patlen - band, textlen))
        bestval = dp[patlen][bestpos]
        ub = min(patlen + band, textlen)
        for t in range(bestpos + 1, ub + 1):
            val = dp[patlen][t]
            if val < bestval or (val <= bestval and (best[patlen][t] & _DIAG)):
                bestval = val
                bestpos = t
        if bestpos < patlen - band or bestpos > patlen + band:
            return False, 0, 0
        return True, bestpos, bestval

    # -- anchored extensions -----------------------------------------------

    def lmatch(self, text_at, end1: int, p1: str, p2: str,
               esb: int, eeb: int):
        """Left part p1 matched exactly ending at end1; extend right over p2
        (primer_alignment.cc:568-649, yesno path).
        Returns (ok, end, value)."""
        buflen = len(p2) + self.k
        text = text_at(end1, buflen)
        ok, matchlen, value = self.global_align(
            text, p2, 1, esb - len(p1), eeb
        )
        return ok, end1 + matchlen, value

    def rmatch(self, text_at, end2: int, p1: str, p2: str,
               esb: int, eeb: int):
        """Right part p2 matched exactly ending at end2; extend left over p1
        (primer_alignment.cc:651-728, yesno path).
        Returns (ok, end, value); end == end2."""
        patlen = len(p1) + len(p2) + self.k
        textstart = end2 - patlen if end2 > patlen else 0
        buflen = end2 - len(p2) - textstart
        text = text_at(textstart, buflen)
        ok, matchlen, value = self.global_align(
            text, p1, -1, esb, eeb - len(p2)
        )
        return ok, end2, value


class BatchSeedExtender:
    """Batched lmatch/rmatch over candidate ARRAYS — one native call per
    candidate array instead of one ctypes round-trip (plus a Python window
    decode) per seed hit, the k>0 host hot loop of the pigeonhole engines
    (exact_halves.cc:120-197 / exact_bases.cc:69-129 inner loops).

    Per seed id the geometry is fixed: ``dirn`` (+1 lmatch / -1 rmatch), the
    pattern part to extend, the residual constraint args, and for rmatch the
    window geometry (geomA = |p1|+|p2|+k, geomB = |p2|).  Candidates are
    (anchor end position, seed id) arrays; results are (ok, end, value)
    arrays in candidate order — identical to per-candidate
    :meth:`Extender.lmatch`/:meth:`Extender.rmatch` by construction (the
    native batch loops the same DP; the Python fallback literally calls
    them)."""

    def __init__(self, ext: Extender, db, dirs, ext_pats, la, ra,
                 geomA, geomB):
        import numpy as np

        self.ext = ext
        self.db = db
        self.dirs = np.ascontiguousarray(dirs, dtype=np.int32)
        self.ext_pats = [p for p in ext_pats]
        self.la = np.ascontiguousarray(la, dtype=np.int32)
        self.ra = np.ascontiguousarray(ra, dtype=np.int32)
        self.geomA = np.ascontiguousarray(geomA, dtype=np.int32)
        self.geomB = np.ascontiguousarray(geomB, dtype=np.int32)
        blob = "".join(ext_pats).encode("latin-1")
        self._expats = np.frombuffer(blob, dtype=np.uint8).copy()
        if len(self._expats) == 0:
            self._expats = np.zeros(1, dtype=np.uint8)
        lens = np.fromiter((len(p) for p in ext_pats), np.int32,
                           len(ext_pats))
        self.ext_len = lens
        self.ext_off = np.zeros(len(ext_pats), np.int32)
        if len(ext_pats):
            self.ext_off[1:] = np.cumsum(lens[:-1])
        # decode source: Mapped databases must extend against the ORIGINAL
        # characters (db.decode semantics) — feed the raw chars with an
        # identity table there
        if db.decode_chars is not None:
            self._codes = np.ascontiguousarray(db.decode_chars,
                                               dtype=np.uint8)
            self._ch_of = np.arange(256, dtype=np.uint8)
        else:
            self._codes = np.ascontiguousarray(db.codes, dtype=np.uint8)
            tbl = np.frombuffer(db.table, dtype=np.uint8)
            self._ch_of = np.zeros(256, np.uint8)
            self._ch_of[: len(tbl)] = tbl

    def __call__(self, anchors, sids):
        """(anchors [C] int64, sids [C] int32) -> (ok [C] bool,
        end [C] int64, value [C] int32)."""
        import ctypes

        import numpy as np

        C = len(anchors)
        anchors = np.ascontiguousarray(anchors, dtype=np.int64)
        sids = np.ascontiguousarray(sids, dtype=np.int32)
        ok = np.zeros(C, np.int32)
        end = np.zeros(C, np.int64)
        val = np.zeros(C, np.int32)
        ext = self.ext
        if ext._native is not None and C:
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)

            def p32(a):
                return a.ctypes.data_as(i32p)

            r = ext._native.sat_extend_align_batch(
                self._codes.ctypes.data_as(u8p), len(self._codes),
                self._ch_of.ctypes.data_as(u8p),
                self._expats.ctypes.data_as(u8p),
                p32(self.ext_off), p32(self.ext_len), p32(self.dirs),
                p32(self.la), p32(self.ra), p32(self.geomA),
                p32(self.geomB),
                anchors.ctypes.data_as(i64p), p32(sids), C,
                ext.k, ord(ext.eos), int(ext.wc), int(ext.textn),
                int(ext.indels), int(ext.dna_mut),
                ext._c_compat_p, ext._c_aasub_p,
                p32(ok), end.ctypes.data_as(i64p), p32(val),
            )
            if r != 1:
                raise RuntimeError("sat_extend_align_batch failed")
            return ok.astype(bool), end, val
        # pure-Python fallback: per-candidate global_align with the same
        # window construction
        n = len(self._codes)
        chars = self._ch_of
        codes = self._codes
        eos = ext.eos
        k = ext.k
        for i in range(C):
            s = int(sids[i])
            a = int(anchors[i])
            if self.dirs[s] > 0:
                start, buflen = a, int(self.ext_len[s]) + k
            else:
                start = a - int(self.geomA[s]) if a > self.geomA[s] else 0
                buflen = max(a - int(self.geomB[s]) - start, 0)
            s0 = max(0, start)
            e0 = min(s0 + buflen, n)
            w = chars[codes[s0:e0]].tobytes().decode("latin-1")
            if len(w) < buflen:
                w = w + eos * (buflen - len(w))
            o, ml, v = ext.global_align(
                w, self.ext_pats[s], int(self.dirs[s]),
                int(self.la[s]), int(self.ra[s]))
            ok[i] = o
            end[i] = a + ml if self.dirs[s] > 0 else a
            val[i] = v
        return ok.astype(bool), end, val
