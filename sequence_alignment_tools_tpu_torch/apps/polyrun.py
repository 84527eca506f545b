"""polyrun CLI — byte-compatible homopolymer / N-run finder (polyrun.cc).

Run detection is vectorized over the flat code array (np.diff boundaries)
instead of the reference's char-at-a-time loop; coordinates and the
%-escape output format are identical.

The port's copy of ``sequence_alignment_tools_tpu/apps/polyrun.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.compress import load_db

USAGE = """Usage: polyrun [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -l <int>               Minimum run length. Default: 20.
  -n                     Report N runs (instead of ACGT runs).
  -N                     Treat all non-ACGT chars as N (implies -n).
  -A <format>            Output format. Default: ">%h\\n %s %e %t x %l\\n".
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character. Default '\\n'.
  -B / -D (0|1|2|3|4)    I/O and indexing hints.
  -v                     Verbose output.
  -h                     Command line option help.
"""

DEFAULT_FORMAT = ">%h\n %s %e %t x %l\n"


def parse_args(argv):
    opts = {"database": None, "out": None, "eos_char": ord("\n"),
            "dbind": 0, "verbose": False, "l": 20, "outputn": False,
            "outputanynonacgt": False, "alignformat": DEFAULT_FORMAT}
    try:
        parsed, _ = getopt.getopt(argv, "i:o:E:hBD:vl:nNA:")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-l":
            opts["l"] = int(val)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-n":
            opts["outputn"] = True
        elif flag == "-N":
            opts["outputanynonacgt"] = True
            opts["outputn"] = True
        elif flag == "-A":
            opts["alignformat"] = val
        elif flag == "-B":
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["database"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def _fmt(fmt: str, s, e, S, E, t, h, H, f) -> str:
    out = []
    pos = 0
    n = len(fmt)
    while pos < n:
        c = fmt[pos]
        if c == "%":
            pos += 1
            if pos >= n:
                out.append("%")
                break
            v = fmt[pos]
            out.append({
                "s": str(s), "e": str(e), "l": str(e - s), "S": str(S),
                "E": str(E), "t": t, "h": h, "H": H, "f": str(f), "%": "%",
            }.get(v, v))
        elif c == "\\":
            pos += 1
            if pos >= n:
                out.append("\\")
                break
            out.append({"n": "\n", "t": "\t", "\\": "\\"}.get(fmt[pos],
                                                              fmt[pos]))
        else:
            out.append(c)
        pos += 1
    return "".join(out)


def run(opts, out) -> None:
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    raw = np.frombuffer(db.table, dtype=np.uint8)[db.codes].copy()
    eos = opts["eos_char"]
    if opts["outputanynonacgt"]:
        acgt = np.zeros(256, dtype=bool)
        for c in b"ACGT":
            acgt[c] = True
        acgt[eos] = True
        raw[~acgt[raw]] = ord("N")
    n = len(raw)
    if n == 0:
        return
    # run boundaries: indices where the char changes
    change = np.flatnonzero(raw[1:] != raw[:-1]) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])  # runs [start, end)
    lens = ends - starts
    chars = raw[starts]
    is_n = chars == ord("N")
    keep = (
        (lens >= opts["l"])
        & (chars != eos)
        & (is_n if opts["outputn"] else ~is_n)
        # the reference only flushes when a next char breaks the run —
        # a run ending exactly at EOF is never reported
        & (ends < n)
    )
    for i in np.flatnonzero(keep):
        pe = int(ends[i])
        polylen = int(lens[i])
        ps = pe - polylen
        spe = int(db.get_seq_pos(pe))
        sps = spe - polylen
        header = db.get_header_data(pe)
        short = header.split()[0] if header.split() else header
        findex = int(db.entry_of(pe)) + 1  # Header_SI 1-based index
        out.write(_fmt(opts["alignformat"], sps, spe, ps, pe,
                       chr(chars[i]), header, short, findex))


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["out"]:
        with open(opts["out"], "w") as f:
            run(opts, f)
    else:
        run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
