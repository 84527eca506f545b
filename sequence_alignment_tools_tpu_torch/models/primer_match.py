"""The primer_match scan model on the port's scanner.

Port of ``sequence_alignment_tools_tpu/models/primer_match.py::PrimerMatchModel``
for exact search (k = 0): the engines ``exact_kt``, ``exact_sa`` and
``suftree``, with the JAX model's hit semantics and emission order.  The
jax-free parts of that module (engine selection, the verbose reports,
``Hit``) are imported from it as they are.  The k > 0 engines are not
ported yet: ``halves``, ``bases``, ``hash`` and ``gs`` wait for ROADMAP
queue 1 item 6, ``filter`` for item 7.
"""

from __future__ import annotations

from typing import Iterator

from sequence_alignment_tools_tpu.engine.verify import (
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

_EXACT_ENGINES = ("exact_kt", "exact_sa", "suftree")
_WAITING = {
    "halves": "ROADMAP queue 1 item 6",
    "bases": "ROADMAP queue 1 item 6",
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
        if self.engine not in _EXACT_ENGINES or k != 0:
            raise NotImplementedError(
                "primer_match engine %r with k=%d is not ported yet (%s)"
                % (self.engine, k,
                   _WAITING.get(self.engine, "ROADMAP queue 1 item 6")))
        self.device = resolve_device(device)
        # verbose-mode progress reporter, attached to every scanner
        self.progress = None

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
        if self.engine == "suftree":
            return self._suftree_engine()
        return self._exact_engine()

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
        emission (``ConvScanner.scan_stream``); per-run output identical
        to :meth:`engine_hits`."""
        codes = self.db.codes
        _tables, scanner = self._exact_ctx()
        emit = (self._suftree_emit if self.engine == "suftree"
                else self._exact_emit)
        for _i, hits in scanner.scan_stream(codes for _ in range(reps)):
            yield list(emit(hits))

    # -- final hits (reference main-loop re-verification) -------------------

    def hits(self) -> Iterator[Hit]:
        ps = self.ps
        for end, pid, _ in self.engine_hits():
            pat = ps.pattern(pid)
            if self.wc:
                text = self._text_at(end - len(pat), len(pat))
                a = exact_wc_align(end, pat, text, self.textn)
            else:
                a = exact_align(end, pat)
            yield Hit(pid, a)
