"""Out-of-process host tail of the filter engine's serving stream.

Port of ``sequence_alignment_tools_tpu/parallel/tailproc.py``.  The k-edit
filter engine's host tail (the cluster state machine and the batched
native verify, ``models.primer_match._filter_emit_rounds``) is mostly
GIL-held Python; on a worker thread it would serialise with the main
process's dispatch loop.  A worker process has its own GIL, so the tail
overlaps the device scans: the stream ships each run's candidate arrays
over a pipe and receives the emitted hit arrays back.

The child rebuilds the port's model from primitives (codes, table, entry
layout, patterns, flags) with ``device="cpu"`` and runs only host code,
so it opens no CUDA context; it never imports jax.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from collections import deque

import numpy as np


def _tail_worker(conn, spec):
    """Child main: rebuild the model, serve _filter_emit_rounds requests."""
    try:
        # a child is one lane of a round-robin pool on a small host: keep
        # its native verify pool single-threaded
        os.environ.setdefault("SAT_VERIFY_THREADS", "1")
        from ..engine.verify import EditDistAligner
        from ..io.database import SeqDB
        from ..io.patterns import PatternSet
        from ..models.primer_match import PrimerMatchModel

        db = SeqDB(
            codes=np.frombuffer(spec["codes"], dtype=np.uint8),
            table=spec["table"],
            entry_starts=spec["entry_starts"],
            entry_lengths=spec["entry_lengths"],
            headers=spec["headers"],
        )
        ps = PatternSet()
        ps.patterns = spec["patterns"]
        ps.esb = spec["esb"]
        ps.eeb = spec["eeb"]
        ps.n_forward = spec["n_forward"]
        model = PrimerMatchModel(
            db, ps, k=spec["k"], indels=spec["indels"], wc=spec["wc"],
            textn=spec["textn"], dna_mut=spec["dna_mut"],
            report_interval=spec["report_interval"], mesh=None,
            device="cpu")
        if model.engine != "filter":
            model._cluster_aligner = EditDistAligner(
                spec["k"], chr(db.eos_char), spec["wc"], spec["textn"],
                spec["indels"], spec["dna_mut"], yesno=True)
            model.engine = "filter"
        conn.send("ready")
        while True:
            msg = conn.recv()
            if msg is None:
                break
            sends, spids = msg
            rounds = list(model._filter_emit_rounds(sends, spids))
            z = np.zeros(0, np.int64)
            conn.send((
                np.concatenate([r[0] for r in rounds]) if rounds else z,
                np.concatenate([r[1] for r in rounds]) if rounds else z,
                np.concatenate([r[2] for r in rounds]) if rounds else z,
            ))
    except (EOFError, KeyboardInterrupt):
        pass
    except Exception as e:  # surface build/protocol errors to the parent
        try:
            conn.send(("error", repr(e)))
        except Exception:
            pass


class FilterTailProcess:
    """Persistent out-of-process ``_filter_emit_rounds`` executor.

    ``submit(sends, spids)`` ships one run's candidates; ``result()``
    blocks for the oldest outstanding run and returns its hit list.  The
    protocol is FIFO over one pipe; the caller keeps its own queue.
    """

    def __init__(self, model):
        ps, db = model.ps, model.db
        spec = {
            "codes": np.ascontiguousarray(
                np.asarray(db.codes, np.uint8)).tobytes(),
            "table": db.table,
            "entry_starts": np.asarray(db.entry_starts),
            "entry_lengths": np.asarray(db.entry_lengths),
            "headers": list(db.headers),
            "patterns": list(ps.patterns),
            "esb": list(ps.esb),
            "eeb": list(ps.eeb),
            "n_forward": ps.n_forward,
            "k": model.k, "indels": model.indels, "wc": model.wc,
            "textn": model.textn, "dna_mut": model.dna_mut,
            "report_interval": model.report_interval,
        }
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_tail_worker, args=(child, spec), daemon=True)
        self._proc.start()
        child.close()
        msg = self._conn.recv()
        if msg != "ready":
            raise RuntimeError(f"tail worker failed: {msg}")

    def submit(self, sends, spids):
        self._conn.send((sends, spids))

    def result(self):
        msg = self._conn.recv()
        if isinstance(msg, tuple) and len(msg) == 2 and msg[0] == "error":
            raise RuntimeError(f"tail worker failed: {msg[1]}")
        ends, pids, vals = msg
        return list(zip(ends.tolist(), pids.tolist(), vals.tolist()))

    def close(self):
        try:
            self._conn.send(None)
            self._proc.join(timeout=5)
        except Exception:
            pass
        finally:
            try:
                self._conn.close()
            except Exception:
                pass
            if self._proc.is_alive():
                self._proc.terminate()


class FilterTailPool:
    """Round-robin lanes of :class:`FilterTailProcess`: each lane's arrival
    rate drops with the lane count while submit/result stay strictly FIFO
    (results come back in submission order, lane after lane).

    A lane serves one request at a time: a request and its result each
    carry megabytes at a resident genome's scale, and with two requests
    in flight the child can block writing a result while the parent
    blocks writing the next request, each waiting for the other to read.
    So ``submit`` first collects the result its lane still owes."""

    def __init__(self, model, lanes: int = 3):
        self._lanes = [FilterTailProcess(model) for _ in range(lanes)]
        self._sub = 0
        # [lane, result or None] per outstanding request, oldest first
        self._queue = deque()

    def submit(self, sends, spids):
        lane = self._sub % len(self._lanes)
        self._sub += 1
        for item in self._queue:
            if item[0] == lane and item[1] is None:
                item[1] = self._lanes[lane].result()
        self._lanes[lane].submit(sends, spids)
        self._queue.append([lane, None])

    def result(self):
        lane, res = self._queue.popleft()
        return res if res is not None else self._lanes[lane].result()

    def close(self):
        for lane in self._lanes:
            lane.close()
