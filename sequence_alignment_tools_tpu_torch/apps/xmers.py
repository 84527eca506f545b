"""xmers CLI on the port's model.

Port of ``sequence_alignment_tools_tpu/apps/xmers.py``: context-branching
mer census and extension counting (reference ``xmers.cc:62-277`` option
handling, ``:718-1203`` main loop).

See :mod:`..models.xmers` for the algorithm and quirk-parity notes.
``-H`` is accepted for compatibility but ignored: the hash-table prime
only picks internal bucket indices in the reference and never affects
output.  ``-l``/-B/-v are accepted no-ops (logging / buffered-IO hints).
"""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..models.xmers import XmersModel, XmersOptions
from ..utils.iupac import reverse_comp

USAGE = """Usage: xmers [options] \n
Options: \n\
  -m <int>               Mersize of mers.
  -r <sequences>         Regular expressions for mers, separated by whitespace.
  -R                     Reverse complement too.
  -k <int>               Edit distance.
  -K <int>               Hamming distance.
  -b <int>               Inexact search pattern batch size. Default: 50000
  -d                     Delete patterns in phase 1 once xmers. Default: Do not delete.
  -U                     Establish Unique xmers only. Default: Count all matches.
  -X                     Establish xmers with eXact matches only. Default: Count all matches.
  -i <sequence-database> Input sequence database. Required.
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character. Default is '\\n'
  -I                     Do not load fasta database index.
  -v                     Verbose (version & diagnostic) output.
  -B                     Don't use memmap for I/O, use buffered I/O instead.
  -D (0|1|2|3|4)         Fasta database indexing and preprocessing.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"patterns": "", "database": "", "out": None, "eos": 10,
            "verbose": False, "dbind": 0, "mersize": 0, "u": -1,
            "noindex": False, "indels": False, "rc": False, "node1": 0,
            "node2": 0, "nmismatch": 0, "blocksize": 50000, "delpat": False,
            "uniq": False, "exonly": False}
    try:
        parsed, _ = getopt.getopt(argv, "r:i:o:E:hvBID:m:k:K:u:b:l:dRn:N:UXH:")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-m":
            opts["mersize"] = int(val)
        elif flag == "-k":
            opts["nmismatch"] = int(val)
            opts["indels"] = True
        elif flag == "-K":
            opts["nmismatch"] = int(val)
            opts["indels"] = False
        elif flag == "-u":
            opts["u"] = int(val)
        elif flag == "-n":
            opts["node1"] = int(val)
        elif flag == "-N":
            opts["node2"] = int(val)
        elif flag == "-r":
            opts["patterns"] = val
        elif flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-E":
            opts["eos"] = int(val, 0)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-b":
            opts["blocksize"] = int(val)
        elif flag == "-d":
            opts["delpat"] = True
        elif flag == "-U":
            opts["uniq"] = True
            opts["exonly"] = False
        elif flag == "-X":
            opts["exonly"] = True
            opts["uniq"] = False
        elif flag == "-R":
            opts["rc"] = True
        elif flag == "-I":
            opts["noindex"] = True
        elif flag == "-v":
            opts["verbose"] = True
        elif flag in ("-B", "-l", "-H"):
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["database"] or opts["mersize"] == 0:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    if not (0 <= opts["dbind"] <= 4):
        sys.stderr.write(
            "Invalid integer for fasta database indexing (-D).\n\n" + USAGE)
        raise SystemExit(1)
    if not opts["patterns"]:
        opts["patterns"] = "." * opts["mersize"]
    return opts


def run(opts, out) -> None:
    pats = opts["patterns"].split()
    for p in pats:
        if len(p) != opts["mersize"]:
            sys.stderr.write(
                f"Bad pattern: {p} has length {len(p)} != "
                f"{opts['mersize']}\n")
            raise SystemExit(1)
    if not pats:
        return
    pats = [p.upper() for p in pats]
    db = load_db(opts["database"], eos_char=opts["eos"])
    mopt = XmersOptions(
        mersize=opts["mersize"], patterns=opts["patterns"], rc=opts["rc"],
        nmismatch=opts["nmismatch"], indels=opts["indels"],
        blocksize=opts["blocksize"], delpat=opts["delpat"],
        uniq=opts["uniq"], exonly=opts["exonly"], noindex=opts["noindex"],
        u=opts["u"], node1=opts["node1"], node2=opts["node2"],
        verbose=opts["verbose"], always_u=opts.get("always_u", False),
    )
    model = XmersModel(db, mopt, out.write)
    # interleave fwd/rc registration (xmers.cc:822-833)
    reg: list[str] = []
    for p in pats:
        reg.append(p)
        if opts["rc"]:
            reg.append(reverse_comp(p))
    model.run_phase0(reg)
    if opts["nmismatch"] > 0:
        model.run_inexact_phases()


def merstream_main(argv=None) -> int:
    """merstream CLI — the xmers variant in ``merstream.cc`` (a 3-line
    diff): ``-u`` is unsigned with default 0, the ``u:`` tag prints
    unconditionally in location dumps, and ``-r`` patterns are
    required."""
    import io

    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["u"] == -1:
        opts["u"] = 0
    if opts["patterns"] == "." * opts["mersize"] and "-r" not in (
            argv or sys.argv[1:]):
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    opts["always_u"] = True
    if opts["out"]:
        with open(opts["out"], "w", encoding="latin-1") as f:
            run(opts, f)
    else:
        out = io.TextIOWrapper(sys.stdout.buffer, encoding="latin-1")
        run(opts, out)
        out.flush()
    return 0


def main(argv=None) -> int:
    import io

    opts = parse_args(sys.argv[1:] if argv is None else argv)
    # phase-2 phantom extension chars can be >127; emit raw bytes like the
    # reference, not UTF-8
    if opts["out"]:
        with open(opts["out"], "w", encoding="latin-1") as f:
            run(opts, f)
    else:
        out = io.TextIOWrapper(sys.stdout.buffer, encoding="latin-1")
        run(opts, out)
        out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
