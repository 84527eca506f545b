"""aacomp / aacomplookup CLIs — byte-compatible amino-acid composition mass
index builder and query tool (aacomp.cc, aacomplookup.cc).

aacomp indexes every substring mass in [min, max] (cumulative monoisotopic
residue masses, window capped at max/50 residues) as a binary sortedvector of
(float mass, (entry, midpoint-position)) — serialized as the reference's raw
element structs (4-byte float key + 4 pad + two int64s).  aacomplookup scans
query masses from stdin and prints all index records within tolerance.

The port's copy of ``sequence_alignment_tools_tpu/apps/aacomp.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import struct
import sys

import numpy as np

from ..io.fasta import iter_fasta
from ..utils.aa import monomolwt

AACOMP_USAGE = """Usage: aacomp [options]

Options:
  -i <fasta-file>        Input sequences. Required.
  -m <float>             Minimum mass. Default: 100.
  -M <float>             Maximum mass. Default: 3000.
  -r <float>             Random inclusion probability. Default: 1.
  -o <output-file>       Output (binary) file. Defaults to standard out.
  -h                     Command line option help.
"""

LOOKUP_USAGE = """Usage: aacomplookup [options] < masses

Options:
  -i <index-file>        Binary index from aacomp. Required.
  -t <float>             Mass tolerance. Default: 0.1.
  -o <output-file>       Output file. Defaults to standard out.
  -h                     Command line option help.
"""

_ELT = struct.Struct("<f4xqq")  # element<float, pair<ulong, int64>>


def aacomp_main(argv=None) -> int:
    opts = {"database": None, "out": None, "min": 100.0, "max": 3000.0,
            "randprob": 1.0}
    try:
        parsed, _ = getopt.getopt(
            sys.argv[1:] if argv is None else argv, "i:o:hm:M:r:"
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + AACOMP_USAGE)
        return 1
    for flag, val in parsed:
        if flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-m":
            opts["min"] = float(val)
        elif flag == "-M":
            opts["max"] = float(val)
        elif flag == "-r":
            opts["randprob"] = float(val)
        else:
            sys.stderr.write(AACOMP_USAGE)
            return 1
    if not opts["database"]:
        sys.stderr.write(AACOMP_USAGE)
        return 1

    recs: list[tuple[float, int, int]] = []
    pos = 0
    maxwin = int(opts["max"] / 50)
    for i, (header, seq) in enumerate(iter_fasta(opts["database"])):
        s = seq.decode("latin-1")
        if s == "":
            break
        n = len(s)
        # float (32-bit) accumulation exactly as the reference's float m0/m1
        mtab = np.array([np.float32(monomolwt(chr(c))) for c in range(256)],
                        dtype=np.float32)
        for start in range(n):
            m0 = np.float32(0.0)
            for ln in range(maxwin):
                if start + ln >= n:
                    break
                m1 = mtab[ord(s[start + ln])]
                if m1 < 0:
                    break
                m0 = np.float32(m0 + m1)
                if opts["min"] <= m0 <= opts["max"]:
                    recs.append([float(m0), i, pos + start + ln // 2])
        pos += n
    # normalize_strict: full (key, entry, pos) lexicographic order
    # (element::lt, sortedvector.t:52-60)
    recs.sort()
    out = open(opts["out"], "wb") if opts["out"] else sys.stdout.buffer
    out.write(struct.pack("<Q", len(recs)))
    for m0, ent, p in recs:
        out.write(_ELT.pack(m0, ent, p))
    if opts["out"]:
        out.close()
    return 0


def aacomplookup_main(argv=None) -> int:
    opts = {"index": None, "out": None, "tol": 0.1}
    try:
        parsed, _ = getopt.getopt(
            sys.argv[1:] if argv is None else argv, "i:o:hct:a"
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + LOOKUP_USAGE)
        return 1
    for flag, val in parsed:
        if flag == "-i":
            opts["index"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-t":
            opts["tol"] = float(val)
        elif flag in ("-c", "-a"):
            pass
        else:
            sys.stderr.write(LOOKUP_USAGE)
            return 1
    if not opts["index"]:
        sys.stderr.write(LOOKUP_USAGE)
        return 1
    data = open(opts["index"], "rb").read()
    (count,) = struct.unpack_from("<Q", data, 0)
    recs = [list(_ELT.unpack_from(data, 8 + i * _ELT.size))
            for i in range(count)]
    if not recs:
        return 0
    # bread() re-sorts with the KEY-ONLY unstable normalize()
    # (sortedvector.t:502-504) — equal-key runs come out in libstdc++
    # introsort order, which the output exposes
    from ..utils.introsort import introsort

    introsort(recs, lambda a, b: a[0] < b[0])
    keys = [r[0] for r in recs]
    from bisect import bisect_left

    out = open(opts["out"], "w") if opts["out"] else sys.stdout
    tol = opts["tol"]
    i = 0
    for tok in sys.stdin.read().split():
        try:
            m = float(tok)
        except ValueError:
            break
        if m <= 0:
            break
        j = bisect_left(keys, m - tol)
        while j < len(recs) and keys[j] <= m + tol:
            out.write(f"{i} {recs[j][1]} {recs[j][2]}\n")
            j += 1
        i += 1
    if opts["out"]:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(aacomp_main())
