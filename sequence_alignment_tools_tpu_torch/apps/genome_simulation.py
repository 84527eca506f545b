"""genome_simulation / solid_simulation-style random genome synthesis
(genome_simulation.cc): emits a ``.sqn``-like raw code stream — byte 4
sentinels around ``-l`` uniform bytes 0..3 drawn from drand48.

The reference seeds with time(NULL); for reproducible corpora this driver
accepts ``-s <seed>`` (or the RAND48_SEED env var, matching
rand_hash_table.cc:119-124) and replicates glibc's drand48 LCG exactly, so
identically-seeded runs are byte-identical with a same-seeded reference.

The port's copy of
``sequence_alignment_tools_tpu/apps/genome_simulation.py``, kept byte-
compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import os
import sys
import time

USAGE = """Usage: genome_simulation [options]

Options:
  -l <length>            Number of characters.
  -s <seed>              srand48 seed (default: RAND48_SEED env or time).
  -o <output-file>       Output file. Defaults to standard out.
  -v                     Verbose output.
  -h                     Command line option help.
"""


class Drand48:
    """glibc drand48: X' = (a*X + c) mod 2^48, a=0x5DEECE66D, c=0xB;
    srand48(s) sets X = (s << 16) | 0x330E."""

    A = 0x5DEECE66D
    C = 0xB
    M = 1 << 48

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> float:
        self.x = (self.A * self.x + self.C) % self.M
        return self.x / self.M


def main(argv=None) -> int:
    opts = {"length": 0, "out": None, "seed": None, "verbose": False}
    try:
        parsed, _ = getopt.getopt(
            sys.argv[1:] if argv is None else argv, "o:E:l:hvs:"
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        return 1
    for flag, val in parsed:
        if flag == "-l":
            opts["length"] = int(val)
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-s":
            opts["seed"] = int(val)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-E":
            pass
        else:
            sys.stderr.write(USAGE)
            return 1
    seed = opts["seed"]
    if seed is None:
        env = os.environ.get("RAND48_SEED")
        seed = int(env) if env else int(time.time())
    rng = Drand48(seed)
    out = open(opts["out"], "wb") if opts["out"] else sys.stdout.buffer
    import math

    buf = bytearray()
    buf.append(4)
    for _ in range(opts["length"]):
        buf.append(int(math.floor(rng.next() * 4)))
        if len(buf) >= 1 << 20:
            out.write(buf)
            buf = bytearray()
    buf.append(4)
    out.write(buf)
    if opts["out"]:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
