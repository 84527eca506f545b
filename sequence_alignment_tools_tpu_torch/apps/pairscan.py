"""pairscan CLI — gapped mer-pair uniqueness census (reference
``pairscan.cc:159-325``).

For every gap span ``i`` in [-d, -D], hashes the pair template
``1^m 0^i 1^m`` over the normalized sequence (``<db>.sqn``/``.tbl`` —
the reference's ``Normalized<BufferedFileChars>`` swaps the ``.seq``
extension) and marks two cumulative bitmaps over the 4^(2m) hash space:
``first`` (pair value seen) and ``again`` (seen at least twice, counting
forward and reverse-complement marks separately and accumulating across
spans).  The output file is an atomically rewritten checkpoint:
``BEGIN\\n{span} {pos}\\n`` + first.write + again.write + ``END\\n``
(``pairscan.cc:154-176``), resumable on restart (``pairscan.cc:203-218``).
``-e`` exits with status 2 once fewer than the threshold bits of
``again`` remain unset.

Quirk parity: the hash register ORs raw codes without alphabet checks
(EOS/N codes bleed into neighbouring slots), templates truncate to 64
positions, and long-span masks wrap x86-style — see
:mod:`..ops.merhash`.  Values are masked into the table (the reference
writes out of bounds when a wrapped-mask value exceeds it).  Mid-scan
timed checkpoints are not replicated (wall-clock dependent); end-of-span
checkpoints, resume, and final state are.

The port's copy of ``sequence_alignment_tools_tpu/apps/pairscan.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np

from ..ops.merhash import hash_values
from .allvall import read_bitmap_block, write_bitmap_block

USAGE = """Usage: pairscan [options] \n
Options: \n\
  -m <int>               Mersize of mers.
  -d <int>               Min. distance between 3' ends of mers
  -D <int>               Max. distance between 3' ends of mers
  -i <sequence-database> Input sequence database. Required.
  -o <output-file>       Output file. Required.
  -l <log-file>          Redirect stderr.
  -v                     Verbose (version & diagnostic) output.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"database": "", "output": "", "verbose": 0, "mersize": 0,
            "distmin": 0, "distmax": 1000, "exitthresh": -1}
    try:
        parsed, _ = getopt.getopt(argv, "i:o:hvm:l:d:D:e:")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-m":
            opts["mersize"] = int(val)
        elif flag == "-d":
            opts["distmin"] = int(val)
        elif flag == "-D":
            opts["distmax"] = int(val)
        elif flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["output"] = val
        elif flag == "-e":
            opts["exitthresh"] = int(val)
        elif flag in ("-l",):
            pass
        elif flag == "-v":
            opts["verbose"] += 1
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["database"] or not opts["output"] or opts["mersize"] == 0:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def _write_chkpnt(path: str, span: int, pos: int, first: np.ndarray,
                  again: np.ndarray) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"BEGIN\n")
        f.write(f"{span} {pos}\n".encode())
        write_bitmap_block(f, first, ascii_out=False)
        write_bitmap_block(f, again, ascii_out=False)
        f.write(b"END\n")
    os.replace(tmp, path)


def run(opts) -> int:
    base = opts["database"]
    codes = np.fromfile(base + ".sqn", dtype=np.uint8)
    m = opts["mersize"]
    # hash_t is uint32: 1 << (4*m) wraps mod 32 (pairscan.cc:194)
    hashsize = 1 << ((4 * m) % 32)

    first = np.zeros(hashsize, dtype=bool)
    again = np.zeros(hashsize, dtype=bool)
    spanin, posin = opts["distmin"], 0
    if os.path.exists(opts["output"]):
        data = open(opts["output"], "rb").read()
        if data.startswith(b"BEGIN\n"):
            hdr_end = data.index(b"\n", 6)
            spanin, posin = (int(x) for x in data[6:hdr_end].split())
            first, p = read_bitmap_block(data, hdr_end + 1)
            again, p = read_bitmap_block(data, p)
            assert data[p:p + 4] == b"END\n"

    vmask = np.uint32(hashsize - 1)
    for i in range(spanin, opts["distmax"] + 1):
        tstr = "1" * m + "0" * i + "1" * m
        v, rcv, _w, span = hash_values(codes, tstr)
        start = span - 1
        if i == spanin and posin > 0:
            start = max(start, posin)
        vals = np.concatenate([v[start:], rcv[start:]]) & vmask
        uniq, counts = np.unique(vals, return_counts=True)
        again[uniq[counts >= 2]] = True
        again[uniq[first[uniq]]] = True
        first[uniq] = True
        if 0 < opts["exitthresh"] and \
                (hashsize - int(again.sum())) < opts["exitthresh"]:
            _write_chkpnt(opts["output"], 0, 0, first, again)
            return 2
        _write_chkpnt(opts["output"], i + 1, 0, first, again)

    _write_chkpnt(opts["output"], 0, 0, first, again)
    if 0 < opts["exitthresh"] and \
            (hashsize - int(again.sum())) < opts["exitthresh"]:
        return 2
    return 0


def main(argv=None) -> int:
    return run(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    raise SystemExit(main())
