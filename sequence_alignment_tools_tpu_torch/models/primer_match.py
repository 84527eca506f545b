"""The primer_match scan model on the port's scanners.

Port of ``sequence_alignment_tools_tpu/models/primer_match.py::PrimerMatchModel``
with the JAX model's hit semantics and emission order, for the exact
engines ``exact_kt``, ``exact_sa`` and ``suftree``, the pigeonhole (k > 0)
engines ``halves`` (exact_halves) and ``bases`` (exact_bases), the filter
engine (filter_bitvec: ``-k`` with any k the pigeonhole engines do not
take, and ``-K``), and the seed-table engines ``hash`` (hash_table) and
``gs`` (gs_hash_table).

- The pigeonhole engines scan their exact seeds on the device with the
  extension gate (``ConvScanner.scan_gated``: the fused route for at most
  2048 seeds, the census and the slot gate for more) and extend the
  survivors with the native batched extension
  (``engine/extend.BatchSeedExtender``); on the CPU many seeds go through
  the native census with its inline gate (``scan_seed_arrays``).
- The seed-table engines take their seed hits from ``ConvScanner.scan``
  (dense 4-base seeds: the census rung; gapped-seed templates: the fused
  or pattern-blocked rung) and verify behind the per-pattern ``lastpos``
  gate.
- The filter engine takes its k-edit candidates from the Myers or
  Sellers kernel (``ops/sellers.SellersScanner``), or its k-mismatch
  candidates from the poisoned scan (``ConvScanner`` under ``-K``), then
  runs the reference's batch / cluster / verify host tail.

Under a mesh (``mesh="auto"``: ``SAT_MESH``, or every GPU when more than
one is visible; :mod:`..parallel.shard`) every scanner gets the mesh and
scans per position shard: the exact scans and streams through the fused
route, the pigeonhole seeds through the gated route (up to 2,048 seeds;
more take the census unsharded), the k-edit filter engine through
``SellersScanner.scan`` (Myers and the pairs routes are not sharded, as
in the JAX model).

The jax-free parts of the JAX module (engine selection, the verbose
reports, ``Hit``) are the port's copies.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..device import LazyDevice
from ..engine.extend import BatchSeedExtender, Extender
from ..engine.verify import (
    Alignment,
    EditDistAligner,
    exact_align,
    exact_wc_align,
)
from ..io.database import SeqDB
from ..io.patterns import PatternSet
from ..ops.conv_scan import ConvScanner
from ..ops.sellers import SellersScanner
from ..ops.tables import PatternTables, build_tables


@dataclass
class Hit:
    pid: int  # 1-based pattern id (revcomp ids in n+1..2n)
    alignment: Alignment

    @property
    def end(self) -> int:
        return self.alignment.end


class SelectionError(SystemExit):
    pass


def _constraint_stats(ps: PatternSet):
    """min_exact_const / cumdiff / cumbooldiff / min_inexact_bases over all
    patterns (select.cc:31-67)."""
    MAXINT = 1 << 62
    min_exact = MAXINT
    cumdiff = 0
    cumbool = 0
    min_inexact = MAXINT
    min_len = MAXINT
    for i in range(1, ps.n_total + 1):
        n = len(ps.pattern(i))
        min_len = min(min_len, n)
        c = ps.esb[i] if ps.esb[i] >= ps.eeb[i] else ps.eeb[i]
        min_exact = min(min_exact, c)
        cumdiff += c - n // 2
        cumbool += 1 if (c - n // 2) >= 0 else 0
        min_inexact = min(min_inexact, n - c)
    min_inexact = min(min_inexact, min_len)
    return min_exact, cumdiff, cumbool, min_inexact, min_len


def select_engine(db: SeqDB, ps: PatternSet, k: int, wc: bool,
                  seedlen: int, node: int) -> str:
    """pick_pattern_index auto logic (select.cc:103-142).  Returns one of
    'exact_kt', 'exact_sa', 'halves', 'bases', 'filter'."""
    min_exact, cumdiff, cumbool, min_inexact, min_len = _constraint_stats(ps)
    if k >= min_inexact and k > 0:
        import sys

        sys.stderr.write(
            "Fatal error: Number of edits >= Minimum number of inexact "
            f"bases: {min_inexact}\n"
        )
        raise SelectionError(1)
    if node != 0:
        if node in (1, 2, 3):
            # a prebuilt suffix tree overrides the keyword tree
            # (select.cc:184-209)
            if db.has_suffix_tree:
                return "suftree"
            return "exact_kt"
        if node == 4:
            return "exact_sa"
        if node == 5:
            return "filter"
        if node == 6:
            return "hash"
        if node in (7, 8, 9, 10):
            return "bases"
        if node in (11, 12, 13, 14):
            return "halves"
        if node == 15:
            return "gs"
        return "filter"
    if k == 0:
        if wc:
            return "exact_sa"
        return "suftree" if db.has_suffix_tree else "exact_kt"
    # ff->size(): 256 for raw FASTA / .seq streams, .tbl size for normalized
    # databases (select.cc:107-127 keys off the producer's alphabet)
    alpha = db.producer_alphabet
    if (
        k == 1
        and ((min_len >= 12 and alpha < 10) or (min_len >= 8 and alpha >= 10))
        and (cumbool <= 0 or cumdiff <= 0)
    ):
        return "halves"
    if min_exact >= 6:
        return "bases"
    if seedlen > 0:
        return "hash"  # hash_table / rand_hash_table (select.cc:134-136)
    return "filter"


_KT_STYLE = {1: "list nodes", 2: "nodes optimized for DNA",
             3: "jump table nodes"}


def _pmselect(db: SeqDB, ps: PatternSet, k: int, wc: bool,
              seedlen: int, node: int) -> int:
    """Reconstruct the reference's numeric strategy index
    (select.cc:103-142).  Matches the oracle's NOPRIMEGEN build: the
    auto-path gapped-seed branch (select.cc:128-130) is compiled out
    there, so auto never yields 15."""
    if node != 0:
        return node
    if wc:
        pm = 4
    elif db.producer_alphabet < 255:
        pm = 2 if (db.nch("A") == 0 and db.nch("C") == 1
                   and db.nch("G") == 2 and db.nch("T") == 3) else 3
    else:
        pm = 3
    if k > 0:
        min_exact, cumdiff, cumbool, _, min_len = _constraint_stats(ps)
        alpha = db.producer_alphabet
        if (k == 1
                and ((min_len >= 12 and alpha < 10)
                     or (min_len >= 8 and alpha >= 10))
                and (cumbool <= 0 or cumdiff <= 0)):
            pm = 11 + pm - 1
        elif min_exact >= 6:
            pm = 7 + pm - 1
        elif seedlen > 0:
            pm = 6
        else:
            pm = 5
    return pm


def select_report(db: SeqDB, ps: PatternSet, k: int, wc: bool, textn: bool,
                  seedlen: int, node: int, indels: bool,
                  dna_mut: bool) -> list[str]:
    """The verbose lines pick_pattern_index emits (select.cc:149-278):
    primer statistics, options summary, and the strategy announcement.
    Returned without the ``[asctime]`` prefix — callers render each with
    :func:`..utils.log.timestamp`."""
    import math

    N1 = ps.n_total
    lines: list[str] = []
    if N1:
        patlens = [len(ps.pattern(i)) for i in range(1, N1 + 1)]
        min_length = min(patlens)
        avlen = sum(patlens) / N1
        min_exact, cumdiff, cumbool, _, _ = _constraint_stats(ps)
        cum_exact = sum(max(ps.esb[i], ps.eeb[i]) for i in range(1, N1 + 1))
        lines.append("Primer stats: min length: %d" % min_length)
        lines.append("              average len: %g"
                     % (math.floor(avlen * 10 + 0.5) / 10))
        if k > 0:
            lines.append("              min exact bases: %d" % min_exact)
            lines.append("              average exact: %g"
                         % (math.floor(cum_exact / N1 * 10 + 0.5) / 10))
            lines.append("              average (exact - len/2): %g"
                         % (math.floor(cumdiff / N1 * 10 + 0.5) / 10))
            lines.append("              count (exact >= len/2): %d" % cumbool)
            lines.append("              seed length: %d" % seedlen)
        lines.append("              number of primers: %d" % N1)
    if indels:
        lines.append("Options summary: string edits: %d" % k)
    else:
        lines.append("Options summary: mismatches: %d" % k)
    if dna_mut:
        lines.append("                 DNA mutation scoring")
    if wc:
        lines.append("                 wildcard, w/ text N" if textn
                     else "                 wildcard, no text N")
    else:
        lines.append("                 no wildcard")
    pm = _pmselect(db, ps, k, wc, seedlen, node)
    if pm in (1, 2, 3):
        lines.append("Using suffix tree..." if db.has_suffix_tree
                     else "Using keyword tree with %s..." % _KT_STYLE[pm])
    elif pm == 4:
        lines.append("Using bitvector...")
    elif pm == 5:
        lines.append("Using inexact bitvector...")
    elif pm == 6:
        if math.log2(max(db.producer_alphabet, 2)) * seedlen <= 25:
            lines.append("Using exact seed with hash table...")
        else:
            lines.append(
                "Using (large) exact seed with randomized hash table...")
    elif pm in (7, 8, 9):
        lines.append("Using keyword tree with %s for exact portion..."
                     % _KT_STYLE[pm - 6])
    elif pm == 10:
        lines.append("Using bitvector for exact portion...")
    elif pm in (11, 12, 13):
        lines.append("Using keyword tree with %s for exact halves..."
                     % _KT_STYLE[pm - 10])
    elif pm == 14:
        lines.append("Using bitvector for exact halves...")
    elif pm == 15:
        from ..ops.gapped_seeds import select as gs_select

        sch = gs_select(ps.min_len, k, indels)
        if sch is not None:
            lines.append("Using gapped seed set, scheme %s(n%d)"
                         % (sch.name, sch.n))
    # TPU scan-path capability notice (this framework's analog of the
    # reference's engine announcements): patterns longer than the Mosaic
    # kernel halo fall back to the XLA conv path — a real perf cliff the
    # operator should see, not a silent rerouting.  Reference configs
    # never exceed 128, so stderr parity is unaffected.
    if N1 and max(patlens) > 128:
        lines.append(
            "Long patterns (max length %d > 128): Mosaic scan kernel "
            "unavailable, using the slower XLA conv scan path..."
            % max(patlens))
    return lines


def db_pick_report(db: SeqDB, memmap: bool) -> list[str]:
    """The verbose lines pick_fasta_file emits (select.t:29-188) for the
    representation load_db chose and the reference-compatible I/O mode
    flag (-B; our loads are flat ``np.fromfile`` reads either way)."""
    kind = {
        "sqn": "Normalized sequence database...",
        "sqz": "Compressed sequence database...",
        "seq": "Indexed sequence database...",
        "raw": "Raw sequence database...",
    }[db.source_kind]
    io = ("Using mmap for sequence I/O..." if memmap
          else "Not using mmap for sequence I/O...")
    return [kind, io]


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
        mesh="auto",
        device=None,
    ):
        if mesh == "auto":
            # the cached no-mesh answer first: a host-routed one-shot run
            # must not ask the CUDA driver for its device count
            from ..parallel.devcache import peek_no_mesh

            if peek_no_mesh():
                mesh = None
            else:
                from ..parallel.shard import auto_mesh

                mesh = auto_mesh(device=device)
        self.mesh = mesh
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
        # the unsharded rungs run on the mesh's first device; resolved
        # (torch imported) when a device route first reads it
        self._device_arg = (mesh.devices[0]
                            if mesh is not None and device is None
                            else device)
        # verbose-mode progress reporter, attached to every scanner
        self.progress = None
        eos = chr(db.eos_char)
        self._final_aligner = EditDistAligner(
            k, eos, wc, textn, indels, dna_mut, yesno=False)
        if self.engine == "filter":
            self._cluster_aligner = EditDistAligner(
                k, eos, wc, textn, indels, dna_mut, yesno=True)
        if self.engine in ("halves", "bases"):
            self._extender = Extender(k, eos, wc, textn, indels, dna_mut)
        if self.engine in ("hash", "gs"):
            self._hash_aligner = EditDistAligner(
                k, eos, wc, textn, indels, dna_mut, yesno=True)

    _tail_exec = None
    _tailproc_c = None

    def _filter_tailproc(self):
        """Persistent out-of-process ``_filter_emit`` executor (built once
        per model; None when spawning is unavailable)."""
        if self._tailproc_c is None:
            try:
                from ..parallel.tailproc import FilterTailPool

                self._tailproc_c = FilterTailPool(self)
            except Exception:
                self._tailproc_c = False
        return self._tailproc_c or None

    @classmethod
    def _tail_pool(cls):
        """One worker thread for the host tail (the tail stages share
        per-model state, so they run serially; the point is overlap with
        the main thread's device pipeline)."""
        if cls._tail_exec is None:
            from concurrent.futures import ThreadPoolExecutor

            cls._tail_exec = ThreadPoolExecutor(max_workers=1)
        return cls._tail_exec

    # None = per-size auto; False pins engine scanners to the device route
    use_host = None
    # the torch.device of the device routes, resolved on their first read
    device = LazyDevice()

    def close(self) -> None:
        """Stop the filter engine's tail processes, if any were started."""
        if self._tailproc_c:
            self._tailproc_c.close()
        self._tailproc_c = None

    def _attach(self, scanner):
        scanner.progress = self.progress
        if self.use_host is not None:
            scanner.use_host = self.use_host
        if self.mesh is not None:
            scanner.mesh = self.mesh
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
            "filter": self._filter_engine,
            "hash": self._hash_engine,
            "gs": self._gs_engine,
        }[self.engine]()

    _exact_ctx_c = None

    def _exact_ctx(self):
        """(tables, scanner) for the exact engines, built once per model
        (a resident database must not re-pay table builds or uploads)."""
        if self._exact_ctx_c is None:
            tables = build_tables(self.ps, self.db, self.wc, self.textn)
            scanner = self._attach(ConvScanner(
                tables, k=0, device=self._device_arg))
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
        the pigeonhole engines, ``SellersScanner.scan_pairs_stream`` for
        the k-edit filter engine); per-run output identical to
        :meth:`engine_hits`."""
        codes = self.db.codes
        if self.engine == "filter":
            yield from self._filter_stream(reps)
            return
        if self.engine in ("halves", "bases"):
            if self.engine == "halves":
                _o, scanner, _b, dirs, ext_pats, geomB = self._halves_ctx()
                emit = self._halves_emit
            else:
                _o, _s, scanner, _b, dirs, ext_pats, geomB = \
                    self._bases_ctx()
                emit = self._bases_emit
            if not self._gated(scanner, len(codes)):
                for _ in range(reps):
                    yield list(self.engine_hits())
                return
            if not self._mesh_gated_ok(scanner):
                # more seeds than the sharded gated route takes: the
                # per-run engine, its seed scan the census unsharded
                scanner._route(
                    "sharded gated slots INELIGIBLE (P=%d, Lmax=%d): "
                    "per-run engine (census seed scan) under the mesh"
                    % (scanner.tables.P, scanner.tables.Lmax))
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
        if self.engine in ("hash", "gs"):
            # the seed-table engines verify per run, as the JAX model's
            for _ in range(reps):
                yield list(self.engine_hits())
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
        from ..native import load_shift_and_lib

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
        scanner = self._attach(ConvScanner(tables, k=0,
                                           device=self._device_arg))
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
        pigeonhole engine, in no order, by whichever route the scanner
        takes (the JAX order):

        - the gated route (``ConvScanner.scan_gated``: the device seed
          scan and extension gate) for every scan it is available for;
        - else the array-native census (``scan_seed_arrays``, unsorted:
          the emit tails re-order anyway), with the native inline prefix
          gate on the CPU or the slot gate on the device (none over an
          alphabet the gate tables cannot hold);
        - else the ``scanner.scan`` generator (the host rung).

        Each gate keeps a superset of the candidates whose exact
        extension succeeds, so the engine output does not depend on the
        route.  ``dirs``/``ext_pats``/``geomB`` are indexed by engine
        seed id; ``hid_of`` maps the scanner's 0-based pattern index to
        that id."""
        codes = self.db.codes
        if self._gated(scanner, len(codes)) \
                and self._mesh_gated_ok(scanner):
            gate = self._engine_gate(scanner, dirs, ext_pats, geomB, hid_of)
            anchors, sids0 = scanner.scan_gated(codes, gate, self.indels,
                                                self.k)
            return anchors, self._hid_lut(scanner, hid_of)[sids0]
        if scanner.census_serves(codes):
            if scanner.census_on_device():
                from ..ops.gate import ExtendGate

                gates = ({"ext_gate": ExtendGate(self._engine_gate(
                    scanner, dirs, ext_pats, geomB, hid_of), self.indels)}
                    if scanner.gate_alphabet_ok() and self._gate_faithful()
                    else {})
            else:
                gates = {"gate": self._census_gate(scanner, dirs, ext_pats,
                                                   hid_of)}
            ends, pids0 = scanner.scan_seed_arrays(codes, sort=False,
                                                   **gates)
            return ends, self._hid_lut(scanner, hid_of)[pids0]
        ends_l = []
        hids_l = []
        for end, p0, _ in scanner.scan(codes):
            ends_l.append(end)
            hids_l.append(hid_of(p0))
        return (np.asarray(ends_l, np.int64),
                np.asarray(hids_l, np.int64))

    _census_gate_c = None

    def _census_gate(self, scanner, dirs, ext_pats, hid_of):
        """The native census's inline prefix extension gate
        (``native/shift_and.cpp::mer_gate_pass``): per seed the walk
        direction and the first k + 4 extension CODES (6 for k <= 2, the
        packed record's capacity).  A superset filter: it charges a
        substitution or indel 1 and an unknown character a plain mismatch,
        so what it drops cannot survive the exact extension.  None when it
        does not apply (wildcard or compat accepts, substitution-cost
        maps, databases whose characters are not code-faithful)."""
        if self._census_gate_c is not None \
                and self._census_gate_c[0] is scanner:
            return self._census_gate_c[1]
        spec = None
        k = self.k
        if (not self.wc and not self.textn and not self.dna_mut
                and 1 <= k <= 8
                and getattr(self.db, "decode_chars", None) is None):
            S = scanner.tables.P
            G = 6 if k <= 2 else k + 4
            band = k if self.indels else 0
            c2c = {chr(b): i for i, b in enumerate(bytes(self.db.table))}
            gdir = np.zeros(S, np.int8)
            gpref = np.zeros((S, G), np.uint8)
            gglen = np.zeros(S, np.uint8)
            for pid0 in range(S):
                hid = hid_of(pid0)
                d = int(dirs[hid])
                walk = ext_pats[hid]
                if d <= 0:
                    walk = walk[::-1]
                gl = min(len(walk), G)
                for j in range(gl):
                    gpref[pid0, j] = c2c.get(walk[j], 0xFE)
                gdir[pid0] = 0 if gl == 0 else (1 if d > 0 else -1)
                gglen[pid0] = gl
            spec = (np.ascontiguousarray(gdir),
                    np.ascontiguousarray(gpref.reshape(-1)),
                    np.ascontiguousarray(gglen), G, int(k), int(band))
        self._census_gate_c = (scanner, spec)
        return spec

    _gate_cache = None

    def _gate_faithful(self) -> bool:
        """Whether the extension gate's accept tables, built by comparing
        characters, hold the extension's matches: not over a mapped
        database (``decode_chars``, the amino-acid maps of ``-M 2`` and
        ``-M 3``), whose codes stand for more than their table
        characters."""
        return getattr(self.db, "decode_chars", None) is None

    def _gated(self, scanner, n: int) -> bool:
        """Whether a pigeonhole engine takes ``scanner.scan_gated``."""
        return scanner.gated_available(n) and self._gate_faithful()

    @staticmethod
    def _mesh_gated_ok(scanner) -> bool:
        """Under a mesh the gated route is the sharded one, which takes
        at most ``_PBLOCK`` seeds (the JAX ``mesh_ok``); more go to the
        census unsharded."""
        mesh = scanner.mesh
        return mesh is None or mesh.size <= 1 or scanner._sharded_capable()

    def _engine_gate(self, scanner, dirs, ext_pats, geomB, hid_of):
        """Extension :class:`GateTables` of a pigeonhole engine, indexed
        by the scanner's pattern index, cached per scanner."""
        if self._gate_cache is not None \
                and self._gate_cache[0] is scanner:
            return self._gate_cache[1]
        from ..ops.gate import GateTables

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
        scanner = self._attach(ConvScanner(tables, k=0,
                                           device=self._device_arg))
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

    # -- the seed-table engines: hash_table and gs_hash_table ---------------

    def _hash_engine(self):
        """hash_table / rand_hash_table (hash_table.cc:66-226): every
        pattern is indexed at EVERY ws-character seed offset; each text
        seed match projects a candidate pattern end, gated by a
        per-pattern ``lastpos`` window and verified with a yes/no banded
        DP.  Hash cells are lists built with push_front, so co-located
        candidates process in reverse insertion order (pattern desc,
        offset desc)."""
        ps, k = self.ps, self.k
        ws = self.seedlen if self.seedlen > 0 else 4
        seeds: list[str] = [""]
        owner: list[tuple[int, int]] = [(0, 0)]
        for pid in range(1, ps.n_total + 1):
            pat = ps.pattern(pid)
            for j in range(ws - 1, len(pat)):
                seeds.append(pat[j + 1 - ws : j + 1])
                owner.append((pid, j))
        seed_ps = PatternSet(patterns=seeds, esb=[0] * len(seeds),
                             eeb=[0] * len(seeds), n_forward=len(seeds) - 1)
        tables = build_tables(seed_ps, self.db, wc=False, textn=False)
        scanner = self._attach(ConvScanner(tables, k=0,
                                           device=self._device_arg))
        # (pos asc, seed index desc): scan order with push_front cell lists
        cands = sorted(
            ((end, -(s0 + 1)) for end, s0, _ in scanner.scan(self.db.codes))
        )
        if k == 0:
            for end, negs in cands:
                pid, _j = owner[-negs]
                yield end, pid, 0
            return
        pids = np.fromiter((owner[-negs][0] for _, negs in cands), np.int64,
                           len(cands))
        patends = np.fromiter(
            (end + len(ps.pattern(owner[-negs][0])) - owner[-negs][1] - 1
             for end, negs in cands), np.int64, len(cands))
        yield from self._lastpos_verify(pids, patends)

    def _lastpos_verify(self, pids, patends):
        """The per-pattern ``lastpos`` gate and yes/no verify of
        hash_table.cc:179-226, the verifies batched (one native call per
        chunk).  A gated-out candidate's verify is simply unused: the
        align is pure, so the output equals the sequential loop's."""
        from ..engine.verify import BatchVerifier

        ps, k = self.ps, self.k
        verifier = BatchVerifier(
            self._hash_aligner, self.db,
            [ps.pattern(pid) for pid in range(1, ps.n_total + 1)],
            [ps.esb[pid] for pid in range(1, ps.n_total + 1)],
            [ps.eeb[pid] for pid in range(1, ps.n_total + 1)],
        )
        band = k if self.indels else 0
        lastpos = [0] * (ps.n_total + 1)
        CH = 1 << 15
        for c0 in range(0, len(pids), CH):
            pc = pids[c0 : c0 + CH]
            pe = patends[c0 : c0 + CH]
            found, aend, aval = verifier(
                (pc - 1).astype(np.int32), pe - band, pe + band)
            for i in range(len(pc)):
                pid = int(pc[i])
                patend = int(pe[i])
                if lastpos[pid] + band < patend:
                    if found[i]:
                        e = int(aend[i])
                        if lastpos[pid] + band < e:
                            lastpos[pid] = e
                            yield e, pid, int(aval[i])
                        else:
                            lastpos[pid] = patend
                    else:
                        lastpos[pid] = patend

    def _gs_engine(self):
        """gs_hash_table (gs_hash_table.cc:268-487): gapped-seed-set
        filtration.  Each (pattern, window offset, template) registers the
        template-sampled pattern characters; a text window is a candidate
        when its sampled characters all match, evaluated as one sparse
        scan (zero weight at unsampled positions, threshold = l), then
        the ``lastpos`` dedup and yes/no banded verify of hash_table.

        Emission order per text position: template asc, then reverse
        registration (pattern desc, offset desc) like the push_front hash
        cells; ``patend`` clamps to the pattern length near the stream
        start (gs_hash_table.cc:430-437)."""
        from ..ops.gapped_seeds import select as gs_select

        ps, k = self.ps, self.k
        scheme = gs_select(ps.min_len, k, self.indels)
        if scheme is None:
            raise SelectionError(
                "no gapped seed scheme for this pattern set"
            )
        m, L = scheme.m, scheme.l
        db = self.db
        # sparse seed table: one row per (pattern, offset, template)
        entries = []  # (pid, j, templ)
        for pid in range(1, ps.n_total + 1):
            pat = ps.pattern(pid)
            for j in range(0, len(pat) - m + 1):
                for t in range(scheme.n):
                    entries.append((pid, j, t))
        P = len(entries)
        # the text window spans tmax = max txtpos + 1 positions
        tmax = max(max(r) for r in scheme.txtpos) + 1
        alpha = db.alphabet_size
        match = np.zeros((P, tmax, alpha), dtype=bool)
        lengths = np.full(P, L, dtype=np.int32)
        for row, (pid, j, t) in enumerate(entries):
            pat = ps.pattern(pid)
            ok = True
            for pp, tp in zip(scheme.patpos[t], scheme.txtpos[t]):
                code = db.nch(pat[j + pp])
                if code < 0:
                    ok = False
                    break
                match[row, tp, code] = True
            if not ok:
                match[row] = False
        tables = PatternTables(
            match=match, lengths=lengths,
            pat_codes=np.full((P, tmax), -1, dtype=np.int16),
            Lmax=tmax, alpha=alpha, eos_code=db.eos_code,
        )
        # gap columns are never-accepting weight columns, so the template
        # scan takes the scanner's ordinary rungs (the host machine for a
        # one-shot run, the fused or pattern-blocked route otherwise)
        scanner = self._attach(ConvScanner(tables, k=0,
                                           device=self._device_arg))
        cands = []
        for end, row, _ in scanner.scan(db.codes):
            win_start = end - L  # ConvScanner end = start + lengths
            pid, j, t = entries[row]
            # (window end pos, template asc, pattern desc, offset desc)
            cands.append((win_start + tmax, t, -pid, -j))
        cands.sort()
        pids_l = []
        patends_l = []
        for oldpos, t, negpid, negj in cands:
            pid, j = -negpid, -negj
            patlen = len(ps.pattern(pid))
            if oldpos > patlen:
                patend = oldpos + patlen - tmax - j
            else:
                patend = patlen
            pids_l.append(pid)
            patends_l.append(patend)
        yield from self._lastpos_verify(
            np.asarray(pids_l, np.int64), np.asarray(patends_l, np.int64))

    # -- the filter engine: k-edit / k-mismatch candidates, clusters -------

    def _filter_stream(self, reps: int):
        """:meth:`engine_hits_stream` of the filter engine.  ``-K``
        (substitutions only) pipelines the poisoned k-mismatch scan
        through ``ConvScanner.scan_stream`` with the cluster/verify tail
        per run; k-edit pipelines the Myers or Sellers kernel through
        ``SellersScanner.scan_pairs_stream`` with the tail in worker
        processes (a worker thread would share the dispatch loop's GIL),
        or a worker thread where processes cannot be spawned."""
        codes = self.db.codes
        scanner, _v = self._filter_ctx()
        if not self.indels:
            for _i, hits in scanner.scan_stream(codes for _ in range(reps)):
                sends = np.fromiter((h[0] for h in hits), np.int64,
                                    len(hits))
                spids = np.fromiter((h[1] for h in hits), np.int64,
                                    len(hits))
                yield list(self._filter_emit(sends, spids))
            return
        if self.use_host or scanner.mesh is not None \
                or not scanner.kernel_available(len(codes)):
            for _ in range(reps):
                yield list(self.engine_hits())
            return
        tailp = self._filter_tailproc()
        if tailp is not None:
            pend = 0
            for _i, sends, spids in scanner.scan_pairs_stream(
                    codes for _ in range(reps)):
                tailp.submit(sends, spids)
                pend += 1
                while pend > 6:
                    yield tailp.result()
                    pend -= 1
            while pend:
                yield tailp.result()
                pend -= 1
            return
        pool = self._tail_pool()
        futs = deque()
        for _i, sends, spids in scanner.scan_pairs_stream(
                codes for _ in range(reps)):
            futs.append(pool.submit(
                lambda s=sends, p=spids: list(self._filter_emit(s, p))))
            while len(futs) > 4:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()

    _filter_ctx_c = None

    def _filter_ctx(self):
        """(scanner, verifier) of the filter engine, built once per model
        (a resident database must not re-pay table builds or uploads):
        k-edit takes the :class:`SellersScanner`, ``-K`` the poisoned
        k-mismatch :class:`ConvScanner`."""
        if self._filter_ctx_c is not None:
            return self._filter_ctx_c
        from ..engine.verify import BatchVerifier

        ps, k = self.ps, self.k
        tables = build_tables(ps, self.db, self.wc, self.textn)
        if self.indels:
            scanner = self._attach(SellersScanner(
                tables, k=k, indels=True, device=self._device_arg))
        else:
            scanner = self._attach(ConvScanner(
                tables, k=k, poison_eos=True, device=self._device_arg))
        verifier = BatchVerifier(
            self._cluster_aligner, self.db,
            [ps.pattern(pid) for pid in range(1, ps.n_total + 1)],
            [ps.esb[pid] for pid in range(1, ps.n_total + 1)],
            [ps.eeb[pid] for pid in range(1, ps.n_total + 1)],
        )
        self._filter_ctx_c = (scanner, verifier)
        return self._filter_ctx_c

    def _filter_engine(self):
        """filter_bitvec (filter_bitvec.cc:73-183): the k-edit candidate
        set from the native Sellers rows (small scans) or the device
        kernels, or the k-mismatch scan under ``-K``, then the reference's
        batch / cluster / defer host tail (:meth:`_filter_emit_rounds`).
        Under a mesh the candidates come from ``scanner.scan`` (Sellers
        per shard)."""
        scanner, _verifier = self._filter_ctx()
        codes = self.db.codes
        if self.indels and scanner.mesh is None \
                and scanner._host_eligible(len(codes)):
            scanner._route("native Sellers row machine "
                           "(one-shot latency path)")
            sends, spids = scanner.host_pairs(codes)
        elif self.indels and scanner.mesh is None and not self.use_host \
                and scanner.kernel_available(len(codes)):
            sends, spids = scanner.scan_pairs(codes)
        else:
            ends_l: list[int] = []
            pids_l: list[int] = []
            for end, p0, _ in scanner.scan(codes):
                ends_l.append(end)
                pids_l.append(p0)
            sends = np.asarray(ends_l, np.int64)
            spids = np.asarray(pids_l, np.int64)
        yield from self._filter_emit(sends, spids)

    def _filter_emit(self, sends, spids):
        """Tuple-stream form of :meth:`_filter_emit_rounds` (the
        engine_hits contract)."""
        for ea, pa, va in self._filter_emit_rounds(sends, spids):
            yield from zip(ea.tolist(), pa.tolist(), va.tolist())

    def _filter_emit_rounds(self, sends, spids):
        """filter_bitvec host tail from an unordered candidate array pair,
        the JAX model's vectorised form of the reference's batch /
        cluster / defer state machine (filter_bitvec.cc:88-181).  Yields
        one (ends, pids_1based, values) array triple per emission round;
        concatenated in round order they are the engine's hit stream:

        - batch formation: the incremental find_patterns break (>= minka
          new candidates and a 2-position silence) is the first index
          ``i >= si + minka`` with ``ends[i] > ends[i-1] + 2``;
        - clustering: a cluster is a maximal same-pattern chain with
          successive gaps <= 2k+1, from one lexsort and a diff;
        - discovery order: clusters sort by their first member's index in
          the (key, pid)-sorted batch (the reference's i-loop);
        - deferral: the loop breaks at the first discovered cluster whose
          window may still grow (oldcharspos < pos + window), so exactly
          the discovery-order prefix before it is emitted and every other
          entry carries over in batch order."""
        from ..engine.verify import sort_pairs_stdsort

        k = self.k
        minka = self.report_interval
        _scanner, verifier = self._filter_ctx()
        sorder = np.lexsort((spids, sends))
        sends, spids = sends[sorder].astype(np.int64), \
            spids[sorder].astype(np.int64)
        n_stream = len(sends)
        si = 0  # stream cursor
        window = 2 * k + 1
        total_len = len(self.db)
        keys = np.zeros(0, np.int64)
        pids = np.zeros(0, np.int64)
        while True:
            # -- emulate pm_->find_patterns(cp, l, minka) ------------------
            more = False
            oldcharspos = total_len
            if si < n_stream:
                brk = n_stream
                lo = si + minka
                if lo < n_stream:
                    gaps = np.flatnonzero(
                        sends[lo:] > sends[lo - 1 : -1] + 2)
                    if len(gaps):
                        brk = lo + int(gaps[0])
                        oldcharspos = int(sends[brk - 1]) + 2
                more = True
                keys = np.concatenate([keys, sends[si:brk]])
                pids = np.concatenate([pids, spids[si:brk]])
                si = brk
                if brk == n_stream:
                    oldcharspos = total_len
            if not more and not len(keys):
                return
            # -- normalize (std::sort tie order) + vectorized clusters ----
            skeys, spayload = sort_pairs_stdsort(keys, pids)
            n_l = len(skeys)
            idx = np.arange(n_l)
            o = np.lexsort((idx, skeys, spayload))  # (pid, key, index)
            kp, pp, ip = skeys[o], spayload[o], idx[o]
            newc = np.ones(n_l, bool)
            newc[1:] = (pp[1:] != pp[:-1]) | (kp[1:] - kp[:-1] > window)
            cid = np.cumsum(newc) - 1
            first_of = np.flatnonzero(newc)
            last_of = np.append(first_of[1:], n_l) - 1
            firstpos = kp[first_of]
            pos_c = kp[last_of]
            pid_c = pp[first_of]
            disc = ip[first_of]
            order_c = np.argsort(disc, kind="stable")
            nclust = len(first_of)
            emit_rank = nclust
            if more:
                dd = (oldcharspos < pos_c + window)[order_c]
                w = np.flatnonzero(dd)
                if len(w):
                    emit_rank = int(w[0])
            emit_cids = order_c[:emit_rank]
            # one batched native verify per round; emission order is the
            # cluster discovery order (filter_bitvec.cc:140-170)
            if len(emit_cids):
                found, aend, aval = verifier(
                    pid_c[emit_cids].astype(np.int32),
                    firstpos[emit_cids], pos_c[emit_cids])
                fi = np.flatnonzero(found)
                if len(fi):
                    yield (aend[fi], pid_c[emit_cids[fi]] + 1,
                           aval[fi].astype(np.int64))
            emitted = np.zeros(nclust, bool)
            emitted[emit_cids] = True
            liveA = np.empty(n_l, bool)
            liveA[o] = ~emitted[cid]
            keys = skeys[liveA]
            pids = spayload[liveA]
            if not more and si >= n_stream:
                if not len(keys):
                    return
                # leftovers remain but the scan is over: the next pass has
                # more=False and takes them without deferral
                continue

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
