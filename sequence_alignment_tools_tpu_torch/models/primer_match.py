"""The primer_match scan model on the port's scanner.

Port of ``sequence_alignment_tools_tpu/models/primer_match.py::PrimerMatchModel``
with the JAX model's hit semantics and emission order, for the exact
engines ``exact_kt``, ``exact_sa`` and ``suftree`` and the pigeonhole
(k > 0) engines ``halves`` (exact_halves) and ``bases`` (exact_bases).
The pigeonhole engines scan their exact seeds on the device with the
extension gate (``ConvScanner.scan_gated``) and extend the survivors
with the JAX package's native batched extension
(``engine/extend.BatchSeedExtender``, as it is).  The jax-free parts of
the JAX module (engine selection, the verbose reports, ``Hit``) are
imported from it as they are.  Not ported yet: ``hash`` and ``gs``
(ROADMAP queue 1 item 6) and ``filter`` (item 7).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from sequence_alignment_tools_tpu.engine.extend import (
    BatchSeedExtender,
    Extender,
)
from sequence_alignment_tools_tpu.engine.verify import (
    EditDistAligner,
    exact_align,
    exact_wc_align,
)
from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import PatternSet
from sequence_alignment_tools_tpu.models.primer_match import (  # noqa: F401
    Hit,
    SelectionError,
    db_pick_report,
    select_engine,
    select_report,
)
from sequence_alignment_tools_tpu.ops.tables import build_tables

from ..device import resolve_device
from ..ops.conv_scan import ConvScanner
from ..ops.gate import GateTables

_WAITING = {
    "hash": "ROADMAP queue 1 item 6",
    "gs": "ROADMAP queue 1 item 6",
    "filter": "ROADMAP queue 1 item 7",
}


class PrimerMatchModel:
    def __init__(
        self,
        db: SeqDB,
        ps: PatternSet,
        k: int = 0,
        indels: bool = True,
        wc: bool = False,
        textn: bool = False,
        dna_mut: bool = False,
        seedlen: int = 0,
        node: int = 0,
        report_interval: int = 1000,
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "sharded models are not ported yet (ROADMAP queue 1 item 11)")
        self.mesh = None
        self.db = db
        self.ps = ps
        self.k = k
        self.indels = indels
        self.wc = wc
        self.textn = textn
        self.dna_mut = dna_mut
        self.report_interval = report_interval
        self.seedlen = seedlen
        self.node = node
        self.engine = select_engine(db, ps, k, wc, seedlen, node)
        if self.engine in _WAITING:
            raise NotImplementedError(
                "primer_match engine %r with k=%d is not ported yet (%s)"
                % (self.engine, k, _WAITING[self.engine]))
        self.device = resolve_device(device)
        # verbose-mode progress reporter, attached to every scanner
        self.progress = None
        eos = chr(db.eos_char)
        self._final_aligner = EditDistAligner(
            k, eos, wc, textn, indels, dna_mut, yesno=False)
        if self.engine in ("halves", "bases"):
            self._extender = Extender(k, eos, wc, textn, indels, dna_mut)

    # None = per-size auto; False pins engine scanners to the device route
    use_host = None

    def _attach(self, scanner):
        scanner.progress = self.progress
        if self.use_host is not None:
            scanner.use_host = self.use_host
        return scanner

    def _text_at(self, start: int, length: int) -> str:
        db = self.db
        start = max(0, start)
        end = min(start + length, len(db))
        s = db.decode(start, end)
        if len(s) < length:
            s = s + chr(db.eos_char) * (length - len(s))
        return s

    # -- engine hit streams (end, pid, value) -------------------------------

    def engine_hits(self):
        return {
            "exact_kt": self._exact_engine,
            "exact_sa": self._exact_engine,
            "halves": self._halves_engine,
            "bases": self._bases_engine,
            "suftree": self._suftree_engine,
        }[self.engine]()

    _exact_ctx_c = None

    def _exact_ctx(self):
        """(tables, scanner) for the exact engines, built once per model
        (a resident database must not re-pay table builds or uploads)."""
        if self._exact_ctx_c is None:
            tables = build_tables(self.ps, self.db, self.wc, self.textn)
            scanner = self._attach(ConvScanner(
                tables, k=0, device=self.device))
            self._exact_ctx_c = (tables, scanner)
        return self._exact_ctx_c

    def _exact_engine(self):
        _tables, scanner = self._exact_ctx()
        yield from self._exact_emit(scanner.scan(self.db.codes))

    def _exact_emit(self, hits):
        tables, _scanner = self._exact_ctx()
        lengths = tables.lengths
        cands = []
        for end, p0, _ in hits:
            if self.engine == "exact_kt":
                # keyword tree emits along output/fail chains: longest match
                # first; duplicate patterns in reverse registration order
                cands.append((end, -int(lengths[p0]), -p0))
            else:
                # shift-and emits in word/bit = registration order
                cands.append((end, p0, p0))
        cands.sort()
        for end, _, key in cands:
            p0 = -key if self.engine == "exact_kt" else key
            yield end, p0 + 1, 0

    def _suftree_engine(self):
        _tables, scanner = self._exact_ctx()
        yield from self._suftree_emit(scanner.scan(self.db.codes))

    @staticmethod
    def _suftree_emit(hits):
        """Suffix-tree engine order: all exact occurrences by (end asc,
        pattern registration asc)."""
        for end, p0 in sorted((end, p0) for end, p0, _ in hits):
            yield end, p0 + 1, 0

    def engine_hits_stream(self, reps: int):
        """Serving posture: ``reps`` engine runs over the resident
        database, run i + 1's device scan queued ahead of run i's host
        tail (``ConvScanner.scan_stream``, or ``scan_gated_stream`` for
        the pigeonhole engines); per-run output identical to
        :meth:`engine_hits`."""
        codes = self.db.codes
        if self.engine in ("halves", "bases"):
            if self.engine == "halves":
                _o, scanner, _b, dirs, ext_pats, geomB = self._halves_ctx()
                emit = self._halves_emit
            else:
                _o, _s, scanner, _b, dirs, ext_pats, geomB = \
                    self._bases_ctx()
                emit = self._bases_emit
            if not scanner.gated_available(len(codes)):
                for _ in range(reps):
                    yield list(self.engine_hits())
                return
            gate = self._engine_gate(scanner, dirs, ext_pats, geomB,
                                     _hid_of)
            lut = self._hid_lut(scanner, _hid_of)
            for _i, anchors, sids0 in scanner.scan_gated_stream(
                    (codes for _ in range(reps)), gate, self.indels,
                    self.k):
                yield list(emit(anchors, lut[sids0]))
            return
        _tables, scanner = self._exact_ctx()
        emit = (self._suftree_emit if self.engine == "suftree"
                else self._exact_emit)
        for _i, hits in scanner.scan_stream(codes for _ in range(reps)):
            yield list(emit(hits))

    # -- pigeonhole engines: exact seeds, gate, native extension ------------

    def _halves_engine(self):
        """exact_halves (exact_halves.cc:121-224): exact half seeds, the
        batched native lmatch/rmatch extension, then the sequential
        lasthit+2k dedup over the successful extensions."""
        _owner, scanner, _batch, dirs, ext_pats, geomB = self._halves_ctx()
        ends, hids = self._seed_candidates(
            scanner, dirs, ext_pats, geomB, _hid_of)
        yield from self._halves_emit(ends, hids)

    def _halves_emit_arrays(self, ends, hids):
        """exact_halves host tail as (ends, pids, values) arrays: batched
        native extension, then the (pos asc, half-id desc) dedup order
        restored on the survivors only, since the extension is
        per-candidate independent."""
        ps, k = self.ps, self.k
        owner, _scanner, batch, _dirs, _ext, _geomB = self._halves_ctx()
        ok, hend, value = batch(ends, hids.astype(np.int32))
        okidx = np.flatnonzero(ok)
        sub = okidx[np.lexsort((-hids[okidx], ends[okidx]))]
        dedup = 2 * k if self.indels else 0
        pids = np.ascontiguousarray(owner[hids[sub]])
        hes = np.ascontiguousarray(hend[sub])
        vals = value[sub]
        lib = self._dedup_lib()
        if lib is not None and len(sub):
            import ctypes

            i64p = ctypes.POINTER(ctypes.c_int64)
            keep = np.empty(len(sub), np.uint8)
            lasthit = np.zeros(ps.n_total + 1, np.int64)
            lib.sat_lasthit_dedup(
                pids.ctypes.data_as(i64p), hes.ctypes.data_as(i64p),
                len(sub), dedup, lasthit.ctypes.data_as(i64p),
                keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            kidx = np.flatnonzero(keep)
            return hes[kidx], pids[kidx], vals[kidx]
        lasthit = [0] * (ps.n_total + 1)
        kl = []
        for i, (pid, he) in enumerate(zip(pids.tolist(), hes.tolist())):
            if he > lasthit[pid] + dedup:
                lasthit[pid] = he
                kl.append(i)
        kidx = np.asarray(kl, np.int64)
        return hes[kidx], pids[kidx], vals[kidx]

    def _halves_emit(self, ends, hids):
        hes, pids, vals = self._halves_emit_arrays(ends, hids)
        yield from zip(hes.tolist(), pids.tolist(), vals.tolist())

    def engine_hits_arrays(self):
        """(ends, pids, values) arrays of :meth:`engine_hits`, without
        the per-hit tuple stream for the halves engine."""
        if self.engine == "halves":
            _owner, scanner, _batch, dirs, ext_pats, geomB = \
                self._halves_ctx()
            ends, hids = self._seed_candidates(
                scanner, dirs, ext_pats, geomB, _hid_of)
            return self._halves_emit_arrays(ends, hids)
        hits = list(self.engine_hits())
        return (np.asarray([h[0] for h in hits], np.int64),
                np.asarray([h[1] for h in hits], np.int64),
                np.asarray([h[2] for h in hits], np.int32))

    @staticmethod
    def _dedup_lib():
        from sequence_alignment_tools_tpu.native import load_shift_and_lib

        lib = load_shift_and_lib()
        return lib if lib is not None \
            and hasattr(lib, "sat_lasthit_dedup") else None

    _halves_ctx_c = None

    def _halves_ctx(self):
        """(owner, scanner, batch extender, dirs, ext_pats, geomB) of the
        halves engine, built once per model (a resident database must not
        re-pay table builds, uploads or the scanner's converged caps)."""
        if self._halves_ctx_c is not None:
            return self._halves_ctx_c
        ps, k = self.ps, self.k
        halves: list[str] = [""]
        owner: list[int] = [0]
        for pid in range(1, ps.n_total + 1):
            pat = ps.pattern(pid)
            halves += [pat[: len(pat) // 2], pat[len(pat) // 2 :]]
            owner += [pid, pid]
        half_ps = PatternSet(patterns=halves, esb=[0] * len(halves),
                             eeb=[0] * len(halves), n_forward=len(halves) - 1)
        tables = build_tables(half_ps, self.db, wc=self.wc, textn=self.textn)
        scanner = self._attach(ConvScanner(tables, k=0, device=self.device))
        # per-seed extension geometry (sid == hid)
        S = len(halves)
        dirs = np.zeros(S, np.int32)
        la = np.zeros(S, np.int32)
        ra = np.zeros(S, np.int32)
        geomA = np.zeros(S, np.int32)
        geomB = np.zeros(S, np.int32)
        ext_pats = [""] * S
        for hid in range(1, S):
            pid = owner[hid]
            h1 = halves[hid if hid % 2 == 1 else hid - 1]
            h2 = halves[hid + 1 if hid % 2 == 1 else hid]
            esb, eeb = ps.esb[pid], ps.eeb[pid]
            if hid % 2 == 1:  # left half matched; extend right over h2
                dirs[hid] = 1
                ext_pats[hid] = h2
                la[hid] = esb - len(h1)
                ra[hid] = eeb
            else:  # right half matched; extend left over h1
                dirs[hid] = -1
                ext_pats[hid] = h1
                la[hid] = esb
                ra[hid] = eeb - len(h2)
                geomA[hid] = len(h1) + len(h2) + k
                geomB[hid] = len(h2)
        batch = BatchSeedExtender(self._extender, self.db, dirs, ext_pats,
                                  la, ra, geomA, geomB)
        self._halves_ctx_c = (np.asarray(owner, np.int64), scanner, batch,
                              dirs, ext_pats, geomB)
        return self._halves_ctx_c

    def _seed_candidates(self, scanner, dirs, ext_pats, geomB, hid_of):
        """(ends [C] int64, hids [C] int64) seed-hit candidates of a
        pigeonhole engine, in no order.  The gated route (the device seed
        scan and extension gate, ``ConvScanner.scan_gated``) takes every
        scan it is available for and returns only the gate's survivors,
        a superset of the candidates whose exact extension succeeds, so
        the engine output does not change; other scans (the host rung)
        iterate ``scanner.scan``.  ``dirs``/``ext_pats``/``geomB`` are
        indexed by engine seed id; ``hid_of`` maps the scanner's 0-based
        pattern index to that id."""
        codes = self.db.codes
        if scanner.gated_available(len(codes)):
            gate = self._engine_gate(scanner, dirs, ext_pats, geomB, hid_of)
            anchors, sids0 = scanner.scan_gated(codes, gate, self.indels,
                                                self.k)
            return anchors, self._hid_lut(scanner, hid_of)[sids0]
        ends_l = []
        hids_l = []
        for end, p0, _ in scanner.scan(codes):
            ends_l.append(end)
            hids_l.append(hid_of(p0))
        return (np.asarray(ends_l, np.int64),
                np.asarray(hids_l, np.int64))

    _gate_cache = None

    def _engine_gate(self, scanner, dirs, ext_pats, geomB, hid_of):
        """Extension :class:`GateTables` of a pigeonhole engine, indexed
        by the scanner's pattern index, cached per scanner."""
        if self._gate_cache is not None \
                and self._gate_cache[0] is scanner:
            return self._gate_cache[1]
        k = self.k
        S = len(ext_pats)
        gate = GateTables.from_seed_meta(
            self.db, [ext_pats[hid_of(p0)] for p0 in range(S - 1)],
            np.asarray([dirs[hid_of(p0)] for p0 in range(S - 1)]),
            np.asarray([geomB[hid_of(p0)] for p0 in range(S - 1)]),
            k, k if self.indels else 0, self.wc, self.textn)
        self._gate_cache = (scanner, gate)
        return gate

    @staticmethod
    def _hid_lut(scanner, hid_of):
        """The p0 -> engine seed id map as an int64 array, cached on the
        scanner."""
        lut = getattr(scanner, "_hid_lut_c", None)
        if lut is None:
            lut = np.fromiter(
                (hid_of(p) for p in range(scanner.tables.P)), np.int64,
                scanner.tables.P)
            scanner._hid_lut_c = lut
        return lut

    _bases_ctx_c = None

    def _bases_ctx(self):
        """(owner, seeds, scanner, batch extender, dirs, ext_pats, geomB)
        of the bases engine, built once per model."""
        if self._bases_ctx_c is not None:
            return self._bases_ctx_c
        ps, k = self.ps, self.k
        seeds: list[str] = [""]
        owner: list[int] = [0]
        prefix: list[bool] = [False]
        rempat: list[str] = [""]
        for pid in range(1, ps.n_total + 1):
            pat = ps.pattern(pid)
            esb, eeb = ps.esb[pid], ps.eeb[pid]
            if esb >= eeb:
                seed, pfx, rem = pat[:esb], True, pat[esb:]
            else:
                seed, pfx, rem = pat[len(pat) - eeb :], False, \
                    pat[: len(pat) - eeb]
            if seed == "":
                # an empty constrained part registers an empty inner
                # pattern, which never matches (exact_bases.cc:146-148)
                continue
            seeds.append(seed)
            prefix.append(pfx)
            rempat.append(rem)
            owner.append(pid)
        seed_ps = PatternSet(patterns=seeds, esb=[0] * len(seeds),
                             eeb=[0] * len(seeds), n_forward=len(seeds) - 1)
        tables = build_tables(seed_ps, self.db, wc=self.wc, textn=self.textn)
        scanner = self._attach(ConvScanner(tables, k=0, device=self.device))
        S = len(seeds)
        dirs = np.zeros(S, np.int32)
        la = np.zeros(S, np.int32)
        ra = np.zeros(S, np.int32)
        geomA = np.zeros(S, np.int32)
        geomB = np.zeros(S, np.int32)
        ext_pats = [""] * S
        for sid in range(1, S):
            pid = owner[sid]
            esb, eeb = ps.esb[pid], ps.eeb[pid]
            ext_pats[sid] = rempat[sid]
            if prefix[sid]:  # lmatch(end, seed, rempat)
                dirs[sid] = 1
                la[sid] = esb - len(seeds[sid])
                ra[sid] = eeb
            else:  # rmatch(end, rempat, seed)
                dirs[sid] = -1
                la[sid] = esb
                ra[sid] = eeb - len(seeds[sid])
                geomA[sid] = len(rempat[sid]) + len(seeds[sid]) + k
                geomB[sid] = len(seeds[sid])
        batch = BatchSeedExtender(self._extender, self.db, dirs, ext_pats,
                                  la, ra, geomA, geomB)
        self._bases_ctx_c = (
            owner, seeds, scanner, batch, dirs, ext_pats, geomB)
        return self._bases_ctx_c

    def _bases_engine(self):
        """exact_bases (exact_bases.cc:69-160): constrained-seed
        extension, no dedup; candidates in inner keyword-tree order."""
        _o, _s, scanner, _b, dirs, ext_pats, geomB = self._bases_ctx()
        ends, sids = self._seed_candidates(
            scanner, dirs, ext_pats, geomB, _hid_of)
        yield from self._bases_emit(ends, sids)

    def _bases_emit(self, ends, sids):
        """exact_bases host tail from a candidate (ends, sids) pair:
        extension first, emission order restored on the survivors."""
        owner, seeds, _scanner, batch, _d, _e, _g = self._bases_ctx()
        S = len(seeds)
        ok, hend, value = batch(ends, sids.astype(np.int32))
        okidx = np.flatnonzero(ok)
        if self.node == 10:
            # shift_and inner engine emits in registration (bit) order
            sub = okidx[np.lexsort((sids[okidx], ends[okidx]))]
        else:
            # keyword-tree order: end asc, longer seed first, duplicates
            # in reverse registration order
            slen = np.fromiter((len(s) for s in seeds), np.int64, S)
            sub = okidx[np.lexsort(
                (-sids[okidx], -slen[sids[okidx]], ends[okidx]))]
        for i in sub:
            yield int(hend[i]), owner[int(sids[i])], int(value[i])

    # -- final hits (reference main-loop re-verification) -------------------

    def hits(self) -> Iterator[Hit]:
        ps, k = self.ps, self.k
        for end, pid, _ in self.engine_hits():
            pat = ps.pattern(pid)
            if k > 0:
                fa = self._final_aligner.align(
                    self._text_at, pat, end, end,
                    esb=ps.esb[pid], eeb=ps.eeb[pid])
                if fa.editdist() <= k:
                    yield Hit(pid, fa)
            elif self.wc:
                text = self._text_at(end - len(pat), len(pat))
                yield Hit(pid, exact_wc_align(end, pat, text, self.textn))
            else:
                yield Hit(pid, exact_align(end, pat))


def _hid_of(p0: int) -> int:
    """Engine seed id of the seed scanner's 0-based pattern p0 (id 0 is
    the empty placeholder of both pigeonhole engines)."""
    return p0 + 1
