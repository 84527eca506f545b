"""solid_simulation CLI — SOLiD colorspace read simulator
(solid_simulation.cc): samples random mersize reads (optionally reverse
complement), encodes them as colorspace (color = 2-bit XOR of adjacent
bases, 'G' primer base), applies per-round color errors, and emits
``>index original\\ncolorread`` records.

The reference seeds drand48 with time(NULL); ``-s``/RAND48_SEED gives
reproducible output with an exact drand48 replication (draw-for-draw the
same consumption order as the reference loop).

The port's copy of
``sequence_alignment_tools_tpu/apps/solid_simulation.py``, kept byte-
compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import math
import os
import sys
import time

from ..io.compress import load_db
from .genome_simulation import Drand48

USAGE = """Usage: solid_simulation [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -m <int>               Read length (mersize).
  -S <int>               Number of samples.
  -R                     Sample reverse-complement reads too.
  -e <probs>             Per-round error probabilities. Default "0 0 0 0 0.1".
  -r <int>               Rounds. Default 5.   -p <int>  Period. Default 5.
  -s <seed>              drand48 seed (default RAND48_SEED env or time).
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character.
  -v                     Verbose.
  -h                     This help.
"""

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}
_INV = "ACGT"
_RC = {"A": "T", "C": "G", "G": "C", "T": "A"}


def tocs(read: str) -> str:
    """Colorspace encoding (solid_simulation.cc:166-229): color =
    base XOR base, leading 'G' primer."""
    out = ["G", str(_BASE["G"] ^ _BASE[read[0]])]
    for i in range(1, len(read)):
        out.append(str(_BASE[read[i - 1]] ^ _BASE[read[i]]))
    return "".join(out)


def main(argv=None) -> int:
    o = {"database": None, "out": None, "mersize": 0, "samples": 0,
         "rc": False, "errprob": "0 0 0 0 0.1", "rounds": 5, "period": 5,
         "eos_char": ord("\n"), "seed": None}
    try:
        parsed, _ = getopt.getopt(
            sys.argv[1:] if argv is None else argv, "i:o:r:p:E:hvBIm:RS:e:s:"
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        return 1
    for flag, val in parsed:
        if flag == "-i":
            o["database"] = val
        elif flag == "-o":
            o["out"] = val
        elif flag == "-m":
            o["mersize"] = int(val)
        elif flag == "-S":
            o["samples"] = int(val)
        elif flag == "-R":
            o["rc"] = True
        elif flag == "-e":
            o["errprob"] = val
        elif flag == "-r":
            o["rounds"] = int(val)
        elif flag == "-p":
            o["period"] = int(val)
        elif flag == "-E":
            o["eos_char"] = int(val, 0)
        elif flag == "-s":
            o["seed"] = int(val)
        elif flag in ("-v", "-B", "-I"):
            pass
        else:
            sys.stderr.write(USAGE)
            return 1
    if not o["database"] or o["mersize"] <= 0 or o["samples"] <= 0:
        sys.stderr.write(USAGE)
        return 1
    seed = o["seed"]
    if seed is None:
        env = os.environ.get("RAND48_SEED")
        seed = int(env) if env else int(time.time())
    rng = Drand48(seed)
    eprob = [float(x) for x in o["errprob"].split()][: o["rounds"]]
    eprob += [0.0] * (o["rounds"] - len(eprob))

    db = load_db(o["database"], eos_char=o["eos_char"])
    size = len(db.codes)
    m = o["mersize"]
    out = open(o["out"], "w") if o["out"] else sys.stdout

    def rndcs(c: str) -> str:
        c1 = c
        while c1 == c:
            c1 = chr(ord("0") + int(math.floor(rng.next() * 4)))
        return c1

    def applyerror(cs: list) -> None:
        for r in range(o["rounds"]):
            ep = eprob[r]
            if ep > 0:
                for p in range(o["period"]):
                    if rng.next() < ep:
                        idx = 1 + r * o["period"] + p
                        if idx < len(cs):
                            cs[idx] = rndcs(cs[idx])

    i = 0
    while i < o["samples"]:
        s = int(rng.next() * size)
        rc = False
        if o["rc"] and rng.next() > 0.5:
            rc = True
            if s < m:
                continue
            chars = db.decode(s - m, s)
        else:
            chars = db.decode(s, s + m)
        if len(chars) < m or any(c not in _BASE for c in chars):
            continue
        read = "".join(_RC[c] for c in reversed(chars)) if rc else chars
        cs = list(tocs(read))
        applyerror(cs)
        label = -i if rc else i
        out.write(f">{label} {read}\n{''.join(cs)}\n")
        i += 1
    if o["out"]:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
