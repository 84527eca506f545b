#!/usr/bin/env python3
"""Benchmark of ``sequence_alignment_tools_tpu_torch`` on NVIDIA GPUs.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the repository's root.  The cell is an entry of ``workloads``
in ``BENCHMARK.json``; ``gpubench/harness.py`` says what one run does.
The last line of standard output is the result, a JSON object; the line
before it the run's facts (the model's engine, the route lines of the
warm-up, the card and its power limit); the last lines of standard error
are the numbers compared, each beside its limit.  Without as many CUDA
devices as the cell asks for, it exits 2 and prints no result.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # any kernel cache inside the checkout, at a fixed path, so that only a
    # checkout's first run builds: the port's own build directories are
    # there already, and these catch a Triton or cpp_extension kernel
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    import sequence_alignment_tools_tpu_torch  # noqa: F401  (the program)
    from gpubench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print("loaded in the measured process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    info = result.pop("info")
    print(json.dumps({"run": info}), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
