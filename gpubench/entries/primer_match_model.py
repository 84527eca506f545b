"""The system under test: ``sequence_alignment_tools_tpu_torch``, driven
as ``apps/primer_match.run`` and ``apps/peptide_scan.run`` drive it once
the database is loaded (a traffic file's ``entry``: ``primer_match_model``).

The harness hands it the database's codes, which it wraps in the port's
``SeqDB`` (mapped with ``apply_charmap`` where the search says so), and
the cell's cards.  One query is one client request: a pattern set built
with ``build_pattern_set``, a new ``PrimerMatchModel`` over the resident
database, every hit of ``hits()`` in hand, then ``close()``.  The app's
output formatting is not part of it.

On one card the model gets no mesh and the card by name, and the
database is uploaded once here.  On several it gets one mesh over the
cards (``parallel.shard.make_mesh``), as the apps' ``mesh="auto"`` takes
every visible GPU, and the first card by name; the database goes onto
the cards as the port's sharded routes put it there, on the first query
that scans (the warm-up), and any later re-upload counts in the window.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from ..databases import Database


class Program:
    def __init__(self, db: Database, search: dict, devices: list[str]):
        import torch

        from sequence_alignment_tools_tpu_torch.io.database import SeqDB
        from sequence_alignment_tools_tpu_torch.io.translate import (
            apply_charmap,
        )
        from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
            device_form,
        )

        # a copy of its own: the port caches its device copy by the host
        # array, which then goes with the program when the window closes
        self.seqdb = SeqDB(codes=db.codes.copy(), table=db.table,
                           entry_starts=db.entry_starts,
                           entry_lengths=db.entry_lengths,
                           headers=[f"entry{i}" for i in
                                    range(len(db.entry_starts))],
                           producer_alphabet=len(db.table))
        self.db = apply_charmap(self.seqdb, int(search.get("charmap", 0)))
        self.search = search
        self.device = devices[0]
        self._device_form = device_form
        self.mesh = None
        if len(devices) > 1:
            from sequence_alignment_tools_tpu_torch.parallel.shard import (
                make_mesh,
            )

            self.mesh = make_mesh(devices)
        else:
            device_form(self.db.codes, torch.device(self.device))
        self.engine = None

    @property
    def uploads(self) -> int:
        return self._device_form.uploads

    def query(self, patterns: list[str], phases: list | None = None):
        """Every hit of one query, as the client holds them: the port's
        ``Hit`` objects.  With ``phases``, each call into the port is
        appended to it as (name, start ns, end ns) on the host clock."""
        from sequence_alignment_tools_tpu_torch.io.patterns import (
            build_pattern_set,
        )
        from sequence_alignment_tools_tpu_torch.models.primer_match import (
            PrimerMatchModel,
        )

        s = self.search
        span = _Spans(phases)
        with span("pattern_set"):
            ps = build_pattern_set(patterns, rev_comp=bool(s.get("rev_comp")))
        with span("model"):
            model = PrimerMatchModel(
                self.db, ps, k=int(s["k"]), indels=bool(s["indels"]),
                dna_mut=bool(s.get("dna_mut")),
                seedlen=int(s.get("seedlen", 0)), mesh=self.mesh,
                device=self.device)
        try:
            with span("hits"):
                hits = list(model.hits())
        finally:
            with span("close"):
                model.close()
        self.engine = model.engine
        return hits

    @staticmethod
    def rows(hits) -> np.ndarray:
        """(end, pattern id, edits) of each hit, as ``primer_match``
        reports them, sorted."""
        rows = np.array([(h.end, h.pid, h.alignment.editdist())
                         for h in hits], np.int64).reshape(-1, 3)
        return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


class _Spans:
    """A context manager per named call, appending to ``out`` (None: no
    record)."""

    def __init__(self, out):
        self.out = out

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.out is None:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.out.append((name, t0, time.perf_counter_ns()))
