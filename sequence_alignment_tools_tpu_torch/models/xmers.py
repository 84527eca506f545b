"""xmers — "xmer" (context-branching mer) census and extension counting.

Port of ``sequence_alignment_tools_tpu/models/xmers.py``: phase 0 is the
same numpy and Python; phases 1 and 2 scan each batch through the port's
``PrimerMatchModel.engine_hits()`` (one model per batch, closed once its
hits are consumed, so that no filter-engine tail process outlives its
batch; the database is uploaded once, ``conv_scan.device_form``).

Reimplements the reference's ``xmers.cc`` three-phase algorithm:

* **Phase 0** (``xmers.cc:817-833,1024-1093``): an exact/regex scan over
  every window of the database (default pattern = ``"."*mersize``; ``-r``
  supplies explicit same-length regexes; ``-R`` adds reverse complements,
  interleaved fwd/rc registration).  Each window's mer is tracked in a
  table keyed by its (oriented) normalized text, with the state machine
  of ``merelt`` (``xmers.cc:225-560``): a mer is *unique* (UNX) until a
  second occurrence arrives, *non-unique* (NUNX) while every occurrence
  shares the same left/right context, and becomes an **xmer** when a
  context differs or a sequence boundary (EOS neighbour) is seen.  On
  transition every recorded position is printed (LIFO order — the
  reference stores positions with ``push_front``), and in phase 0 every
  later occurrence of an xmer is printed as it is found.

* **Phase 1** (k>0): the surviving non-xmer mers are re-scanned
  inexactly (``-k`` edit / ``-K`` Hamming distance) in batches of ``-b``
  patterns through the same engine-selection stack primer_match uses
  (``pick_pattern_index``, ``xmers.cc:838-847``); an inexact occurrence
  whose context differs (or any inexact occurrence at all with indels)
  promotes the mer to an xmer and dumps its positions.

* **Phase 2** (k>0): each xmer × recorded-right-char extension becomes
  an (m+1)-pattern; batches are scanned inexactly and per-pattern hit
  counts are printed (``dump_xmer_cnt``, ``xmers.cc:638-663``).

Quirk parity notes:

* The right-char set of a multi-right-char xmer is a 24-bit field set
  with 32-bit shifts (``xmers.cc:418-436``): the stored bit is
  ``code % 32`` (and must be < 24), while ``rchar(j)`` tests bit
  ``j % 64`` (``xmers.cc:610-616``).  On raw FASTA (codes = ASCII) this
  manufactures phantom extension characters (e.g. right-char 'C' = 67
  stores bit 3, which codes 3, 131, 195 also match) — replicated, since
  the phase-2 enumeration order and output structure depend on it.
* The reference's phase 1/2 scans are bit-rotted: ``pick_pattern_index``
  is handed 2-element ``patconst``/``patlen`` vectors for arbitrarily
  many patterns and the engine ends up matching nothing, so every count
  prints 0 and no phase-1 promotion ever fires.  This implementation
  runs the intended scans through the working engine layer; phase-0
  output is byte-identical to the reference, phase-1/2 output follows
  the reference's structure with *real* hit counts.
* ``dump_xmer_cnt`` prints the ``-u`` tag unconditionally (default
  ``-1:``) while ``dump_xmer_loc`` only prints it when >= 0
  (``xmers.cc:638-716``).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil
from typing import Callable

import numpy as np

from ..io.database import SeqDB
from ..io.patterns import PatternSet
from ..utils.iupac import reverse_comp

_AA_CLASS = set("ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy")
_DNA_CLASS = set("ACGTacgt")


class MerEntry:
    """merelt (xmers.cc:225-560): a mer's occurrence-context state."""

    __slots__ = ("u", "x", "nrl", "nrr", "oep", "l", "r", "rbits",
                 "p0", "pl", "xindex")

    def __init__(self, l: int, r: int, neos: int, pos: int):
        self.u = True
        self.x = False
        self.nrl = 1 if l != neos else 0
        self.nrr = 1 if r != neos else 0
        self.oep = True
        self.l = l
        self.r = r
        self.rbits = 0
        self.p0 = pos
        self.pl: list[int] | None = None
        self.xindex = 0

    def rchar(self, j: int) -> bool:
        """xmers.cc:610-616 — value match for single-right xmers, wrapped
        bit test for multi-right ones."""
        if self.u:
            return j == self.r
        return bool((1 << (j % 64)) & self.rbits)

    def _inc_l(self):
        if self.nrl < 2:
            self.nrl += 1

    def _inc_r(self):
        if self.nrr < 2:
            self.nrr += 1

    def _adopt_l(self, lin: int, neos: int):
        if lin != neos:
            if self.l == neos:
                self.l = lin
                self._inc_l()
            elif lin != self.l:
                self._inc_l()

    def _adopt_r(self, rin: int, neos: int):
        if rin != neos:
            if self.r == neos:
                self.r = rin
                self._inc_r()
            elif rin != self.r:
                self._inc_r()


def _bit(code: int) -> int:
    """32-bit `(unsigned)1 << code` with the x86 shift-count wrap, masked
    to the 24-bit field (xmers.cc:418-436)."""
    return (1 << (code % 32)) & 0xFFFFFF


@dataclass
class XmersOptions:
    mersize: int
    patterns: str = ""
    rc: bool = False
    nmismatch: int = 0
    indels: bool = False
    blocksize: int = 50000
    delpat: bool = False
    uniq: bool = False
    exonly: bool = False
    noindex: bool = False
    u: int = -1
    node1: int = 0
    node2: int = 0
    verbose: bool = False
    # merstream.cc variant: u is unsigned (default 0) and the "u:" tag
    # prints unconditionally in dump_xmer_loc too
    always_u: bool = False


class XmersModel:
    def __init__(self, db: SeqDB, opt: XmersOptions,
                 write: Callable[[str], None]):
        self.db = db
        self.opt = opt
        self.write = write
        self.table: dict[bytes, MerEntry] = {}
        self.keys: list[bytes] = []
        self.xmerind = 0
        self.totmers = 0
        self.nxmers = 0
        # producer-code view: for raw FASTA the reference's codes are the
        # ASCII bytes themselves (ff->size()==256); for normalized DBs
        # they are the .tbl codes
        if db.producer_alphabet == 256:
            tbl = np.frombuffer(db.table, dtype=np.uint8)
            self.pcodes = tbl[db.codes]
            self.neos = db.eos_char
            self.psize = 256
            self.pch = lambda c: chr(c)
        else:
            self.pcodes = db.codes
            self.neos = db.eos_code
            self.psize = db.producer_alphabet
            tbl = np.frombuffer(db.table, dtype=np.uint8)
            self.pch = lambda c: chr(int(tbl[c])) if c < len(tbl) else ""
        # complement map over producer codes (iupac_revcomp of the char)
        comp = np.arange(self.psize, dtype=np.int64)
        for i in range(self.psize):
            ch = self.pch(i)
            rc = reverse_comp(ch) if ch else ch
            if rc and len(rc) == 1:
                j = self._pnch(rc)
                comp[i] = j if j >= 0 else i
        self.pcomp = comp

    def _pnch(self, ch: str) -> int:
        """Producer nch: ASCII identity for raw, .tbl code otherwise."""
        if self.psize == 256:
            return ord(ch)
        c = self.db.char_to_code[ord(ch)]
        return int(c) if c != 255 else -1

    # -- output ------------------------------------------------------------

    def _setx(self, ent: MerEntry):
        """merelt::setx (xmers.cc:262-277): keeps r as a VALUE (not a
        bitmask) in both the UX and NUX layouts."""
        ent.x = True
        ent.u = True
        self.xmerind += 1
        ent.xindex = self.xmerind
        self.nxmers += 1

    def _hdr(self, e: int) -> tuple[int, str]:
        ent = int(self.db.entry_of(e))
        if ent < 0:
            return 0, ""
        h = self.db.headers[ent]
        return ent + 1, h.split()[0] if h else ""

    def dump_loc(self, xind: int, key: bytes, e: int, r: int):
        """dump_xmer_loc (xmers.cc:666-716)."""
        o = self.opt
        m = o.mersize
        mer = "".join(self.pch(c) for c in key)
        show_u = o.always_u or o.u >= 0
        if o.noindex:
            pre = f"{o.u}:" if show_u else ""
            tail = f"{e + 1}" if e >= 0 else f"{e}"
            self.write(f"{pre}{xind} {self.pch(r)} {tail}\n")
            return
        pre = f"{o.u}:" if show_u else ""
        if e >= 0:
            idx, short = self._hdr(e)
            self.write(f"{pre}{xind} {_cint(r)} {e - m} {e + 1} {mer} "
                       f"{self.pch(r)} {idx} {short}\n")
        else:
            idx, short = self._hdr(-e)
            self.write(f"{pre}{xind} {_cint(r)} {-e} {-e - (m + 1)} {mer} "
                       f"{self.pch(r)} {idx} {short}\n")

    def dump_cnt(self, xind: int, key: bytes, j: int, cnt: int):
        """dump_xmer_cnt (xmers.cc:638-663) — -u tag unconditional."""
        o = self.opt
        if o.noindex:
            self.write(f"{o.u}:{xind} {self.pch(j)} - {cnt}\n")
            return
        mer = "".join(self.pch(c) for c in key)
        self.write(f"{o.u}:{xind} {_cint(j)} {mer} {self.pch(j)} {cnt}\n")

    # -- phase 0 -----------------------------------------------------------

    def _pattern_class(self, pat: str) -> np.ndarray:
        """Per-position allowed-code sets with shift_and's regex classes
        ('.'/':'/';', shift_and.cc:118-141); wc expansion is OFF
        (xmers.cc:820 constructs shift_and(false,false,true,eos))."""
        m = len(pat)
        allowed = np.zeros((m, self.psize), dtype=bool)
        for i, ch in enumerate(pat):
            if ch == ".":
                allowed[i, :] = True
                allowed[i, self.neos] = False
            elif ch == ":":
                for c in range(self.psize):
                    cc = self.pch(c)
                    if cc and cc not in _AA_CLASS and c != self.neos:
                        allowed[i, c] = True
            elif ch == ";":
                for c in range(self.psize):
                    cc = self.pch(c)
                    if cc and cc not in _DNA_CLASS and c != self.neos:
                        allowed[i, c] = True
            else:
                c = self._pnch(ch)
                if c >= 0:
                    allowed[i, c] = True
        return allowed

    def _phase0_hits(self, pats: list[str]):
        """(end, patidx) pairs in scan order: end ascending, registration
        order within an end."""
        codes = self.pcodes
        n = len(codes)
        m = self.opt.mersize
        if n < m:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        nwin = n - m + 1  # windows [s, s+m), end = s+m
        match = np.empty((len(pats), nwin), dtype=bool)
        for pi, pat in enumerate(pats):
            allowed = self._pattern_class(pat)
            ok = np.ones(nwin, dtype=bool)
            for i in range(m):
                ok &= allowed[i, codes[i:i + nwin]]
            match[pi] = ok
        widx, pidx = np.nonzero(match.T)
        ends = widx + m
        return ends, pidx

    def run_phase0(self, pats: list[str]):
        """Phase-0 census with immediate dumping (xmers.cc:940-1093)."""
        o = self.opt
        m = o.mersize
        codes = self.pcodes
        neos = self.neos
        n = len(codes)
        ends, pidx = self._phase0_hits(pats)
        rc_of = [False] * len(pats)
        if o.rc:
            rc_of = [i % 2 == 1 for i in range(len(pats))]
        comp = self.pcomp
        table, keys = self.table, self.keys
        for e, pi in zip(ends.tolist(), pidx.tolist()):
            is_rc = rc_of[pi]
            if not is_rc:
                win = codes[e - m:e]
                key = win.tobytes()
                left = int(codes[e - m - 1]) if e - m - 1 >= 0 else neos
                right = int(codes[e]) if e < n else neos
                hitpos = e
            else:
                win = comp[codes[e - m:e]][::-1].astype(codes.dtype)
                key = win.tobytes()
                right = int(comp[codes[e - m - 1]]) if e - m - 1 >= 0 \
                    else neos
                left = int(comp[codes[e]]) if e < n else neos
                hitpos = -e
            ent = table.get(key)
            if ent is None:
                ent = MerEntry(left, right, neos, hitpos)
                self.totmers += 1
                table[key] = ent
                keys.append(key)
                if left == neos or right == neos:
                    self._setx(ent)
                    self.dump_loc(ent.xindex, key, hitpos, right)
                continue
            self._update_phase0(ent, key, left, right, hitpos)

    def _update_phase0(self, ent: MerEntry, key: bytes, lin: int, rin: int,
                       pos: int):
        """merelt::update phase-0 branches + the caller's dump logic
        (xmers.cc:400-544, 1060-1085)."""
        neos = self.neos
        if ent.x:
            # record additional context; dump this occurrence
            if ent.u:
                ent._adopt_l(lin, neos)
                if rin != ent.r:  # ux -> nux
                    ent.u = False
                    ent.rbits = _bit(ent.r) | _bit(rin)
                    if rin != neos:
                        ent._inc_r()
            else:
                ent._adopt_l(lin, neos)
                if rin != neos and not (_bit(rin) & ent.rbits):
                    ent._inc_r()
                    ent.rbits |= _bit(rin)
            self.dump_loc(ent.xindex, key, pos, rin)
            return
        if ent.u:
            ent._adopt_l(lin, neos)
            ent._adopt_r(rin, neos)
            if lin != ent.l or rin != ent.r:
                # transition to xmer; dump stored position then current
                r0, l0 = ent.r, ent.l
                self._setx(ent)
                if rin != r0:
                    ent.u = False
                    ent.rbits = _bit(r0) | _bit(rin)
                    ent.l = l0
                self.dump_loc(ent.xindex, key, ent.p0, r0)
                self.dump_loc(ent.xindex, key, pos, rin)
            else:
                # not unique, not xmer
                ent.pl = [pos, ent.p0]
                ent.u = False
                ent.oep = False
        else:
            ent._adopt_l(lin, neos)
            ent._adopt_r(rin, neos)
            if lin != ent.l or rin != ent.r:
                r0, l0 = ent.r, ent.l
                stored = ent.pl or []
                self._setx(ent)
                if rin != r0:
                    ent.u = False
                    ent.rbits = _bit(r0) | _bit(rin)
                    ent.l = l0
                for p in stored:
                    self.dump_loc(ent.xindex, key, p, r0)
                ent.pl = None
                self.dump_loc(ent.xindex, key, pos, rin)
            else:
                ent.pl.insert(0, pos)
                ent.oep = False

    # -- phases 1 & 2 (k > 0) ----------------------------------------------

    def _engine_hits(self, patterns: list[tuple[str, int]], patlen_hint: int,
                     node: int):
        """Run one inexact batch through the engine stack and yield
        (refid, editdist) per hit, in the engine's emission order.

        ``patterns`` is [(pattern_string, reference_id)] in registration
        order (interleaved fwd/rc); reference ids may be non-contiguous
        (phase 2 skips slots, xmers.cc:888-905) so engine pids are
        remapped through the registration list."""
        from .primer_match import PrimerMatchModel

        ps = PatternSet()
        ps.patterns = [""] + [p for p, _ in patterns]
        ps.esb = [0] * (len(patterns) + 1)
        ps.eeb = [0] * (len(patterns) + 1)
        ps.n_forward = len(patterns)
        o = self.opt
        model = PrimerMatchModel(
            self.db, ps, k=o.nmismatch, indels=o.indels, wc=False,
            textn=False, dna_mut=False, node=node,
        )
        try:
            for end, pid, val in model.engine_hits():
                yield end, patterns[pid - 1][1], val
        finally:
            model.close()

    def run_inexact_phases(self, write_err=None):
        """Phases 1 and 2 (xmers.cc:799-1199), with working scans."""
        o = self.opt
        m = o.mersize
        codes = self.pcodes
        comp = self.pcomp
        neos = self.neos
        n = len(codes)
        table, keys = self.table, self.keys

        # ---- phase 1: promote non-xmers with inexact context evidence ----
        nblocks = ceil((self.totmers - self.nxmers) / o.blocksize)
        blockstart = 0
        for _block in range(nblocks):
            batch: list[tuple[str, int]] = []  # (pattern, refid)
            patcnt = 0
            patcntbl = 0
            mer_of: dict[int, bytes] = {}
            for key in keys:
                ent = table[key]
                if not ent.x:
                    if patcnt < blockstart:
                        patcnt += 1
                        continue
                    if patcntbl >= o.blocksize:
                        break
                    pat = "".join(self.pch(c) for c in key)
                    refid = patcntbl * (2 if o.rc else 1) + 1
                    batch.append((pat, refid))
                    if o.rc:
                        batch.append((reverse_comp(pat), refid + 1))
                    mer_of[patcntbl] = key
                    patcntbl += 1
                patcnt += 1
            blockstart = patcnt
            if patcntbl == 0:
                continue
            ignore = [0] * patcntbl
            for e, refid, _val in self._engine_hits(batch, m, o.node1):
                hitid = refid - 1
                hitrc = False
                hitpos = e
                if o.rc:
                    if hitid % 2 == 1:
                        hitrc = True
                        hitpos = -e
                    hitid //= 2
                if ignore[hitid] > 0:
                    continue
                key = mer_of[hitid]
                ent = table[key]
                if ent.x:
                    continue
                # text window at [e-m, e) in hit orientation; an indel hit
                # can end before position m — pad the unreadable prefix
                # with EOS instead of the reference's out-of-bounds read
                win = codes[max(e - m, 0):e]
                if len(win) < m:
                    win = np.concatenate(
                        [np.full(m - len(win), neos, codes.dtype), win])
                if not hitrc:
                    buf = win.tobytes()
                    left = int(codes[e - m - 1]) if e - m - 1 >= 0 else neos
                    right = int(codes[e]) if e < n else neos
                else:
                    buf = comp[win][::-1].astype(codes.dtype).tobytes()
                    right = int(comp[codes[e - m - 1]]) if e - m - 1 >= 0 \
                        else neos
                    left = int(comp[codes[e]]) if e < n else neos
                if buf == key:
                    continue  # exact occurrence: no promotion evidence
                # merelt::update phase-1 branches (xmers.cc:446-543)
                promote = (left != ent.l or right != ent.r
                           or (o.indels and o.nmismatch > 0))
                if not promote:
                    continue
                r0, l0 = ent.r, ent.l
                stored = [ent.p0] if ent.u else list(ent.pl or [])
                self._setx(ent)
                ent.pl = None
                for p in stored:
                    self.dump_loc(ent.xindex, key, p, r0)
                ignore[hitid] = 1

        # ---- phase 2: count xmer extensions ------------------------------
        blockstart = 0
        while True:
            blockstart0 = blockstart
            batch = []
            patcnt = 0
            patcntbl = 0
            counts: list[int] = []
            slots: list[tuple[bytes, int, int]] = []  # (key, xind, j)
            for key in keys:
                ent = table[key]
                if not ent.x:
                    continue
                stop = False
                for j in range(self.psize):
                    if ent.rchar(j) and j != neos:
                        if patcnt < blockstart:
                            patcnt += 1
                            continue
                        if patcntbl >= o.blocksize:
                            stop = True
                            break
                        extpat = "".join(self.pch(c) for c in key) \
                            + self.pch(j)
                        gate = (not (o.uniq or o.exonly)
                                or (ent.nrl <= 1 and ent.nrr <= 1
                                    and (o.exonly
                                         or (o.uniq and ent.oep))))
                        if gate:
                            refid = patcntbl * (2 if o.rc else 1) + 1
                            batch.append((extpat, refid))
                            if o.rc:
                                batch.append(
                                    (reverse_comp(extpat), refid + 1))
                            counts.append(0)
                        else:
                            counts.append(-1)
                        slots.append((key, ent.xindex, j))
                        patcntbl += 1
                        patcnt += 1
                    if patcntbl >= o.blocksize:
                        stop = True
                        break
                if stop:
                    break
            blockstart = patcnt
            if batch:
                for _e, refid, val in self._engine_hits(batch, m + 1,
                                                        o.node2):
                    hitid = refid - 1
                    if o.rc:
                        hitid //= 2
                    if not o.exonly or (val or 0) > 0:
                        counts[hitid] += 1
            # dump this block's counts (xmers.cc:1160-1196)
            for i, (key, xind, j) in enumerate(slots):
                cnt = counts[i]
                if cnt < 0:
                    cnt = 2 if o.uniq else (1 if o.exonly else cnt)
                self.dump_cnt(xind, key, j, cnt)
            if patcntbl < o.blocksize:
                break


def _cint(code: int) -> int:
    """The reference prints right-chars as (signed char) ints
    (dump_xmer_loc/cnt '(int)r'): bytes >= 128 print negative."""
    return code - 256 if code >= 128 else code
