#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken (the traffic file's
``control``: no indels for the primer panels, I and L told apart for the
peptides), run through the harness as a run runs the program.

    python3 gpubench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

run from the repository's root, on the card.  For each seed it runs the
cell at its own size with the control in the program's place, over a
window of ``--seconds``, and prints the run's ``correct`` and its
compared numbers, each beside its limit: ``correct`` has to come out
false.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class ControlProgram:
    """The reference with the traffic's ``control`` parameters, in the
    program's place (an entry's ``Program`` interface): a query's hits
    are its rows already."""

    def __init__(self, db, search: dict, devices: list[str],
                 control: dict):
        from gpubench.reference import Reference

        self.ref = Reference(db.codes, db.table, devices[0])
        self.search = dict(search, **control)
        self.engine = "control"
        self.uploads = 0

    def query(self, patterns, phases=None):
        return self.ref.answer(self.search, patterns)

    @staticmethod
    def rows(hits):
        return hits


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    spec = harness.cell_files(ROOT, args.workload)[3]
    control = partial(ControlProgram, control=spec["control"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                             program_cls=control)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "seconds": time.perf_counter() - t0, "correct": r["correct"],
            "queries_checked": len(r["info"]["checked_queries"]),
            "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
