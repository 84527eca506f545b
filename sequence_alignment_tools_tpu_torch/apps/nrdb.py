"""nrdb CLI on the port's model.

Port of ``sequence_alignment_tools_tpu/apps/nrdb.py``, the byte-compatible
tool that builds a non-redundant database (nrdb.cc).  The self-scan is
``PrimerMatchModel(k=0)``: one literal seed per entry, so past 2,048
entries (and 2^18 positions) the census rung (``seed_slots.cu`` on the
card); the extension after each hit runs on the host.

Registers each entry's seedlen-char prefix as an exact pattern, scans the
database against itself, extends seed hits char-by-char to detect exact
duplicates (and contained entries with -C), then unions deflines
(';'-joined, BFS over the containment lists) and emits the non-redundant
set wrapped at 60 chars (nrdb.cc:196-330)."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..io.patterns import PatternSet
from ..models.primer_match import PrimerMatchModel

USAGE = """Usage: nrdb [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -x <#-chars>           Seed length. Default: 6.
  -C                     Also remove contained sequences.
  -S                     Skip entries shorter than the seed.
  -b                     Bare output (no deflines).
  -u                     Uppercase sequence characters.
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character. Default '\\n'.
  -R <int>               Report interval. Default 1000.
  -B / -D (0|1|2|3|4)    I/O and indexing hints.
  -v                     Verbose output.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"database": None, "out": None, "seedlen": 6, "ucdict": False,
            "bareout": False, "noshort": False, "contained": False,
            "eos_char": ord("\n"), "report_interval": 1000, "dbind": 0,
            "verbose": False}
    try:
        parsed, _ = getopt.getopt(argv, "i:o:x:SCbE:huvR:BD:")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-x":
            opts["seedlen"] = int(val)
        elif flag == "-u":
            opts["ucdict"] = True
        elif flag == "-b":
            opts["bareout"] = True
        elif flag == "-S":
            opts["noshort"] = True
        elif flag == "-R":
            opts["report_interval"] = int(val)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-C":
            opts["contained"] = True
        elif flag == "-B":
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["database"]:
        raise SystemExit(1)
    return opts


def run(opts, out) -> None:
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    eos_code = db.eos_code
    codes = db.codes
    n_ent = db.n_entries
    seedlen = opts["seedlen"]

    seeds: list[str] = [""]
    owners: list[int] = [0]
    for i in range(n_ent):
        s = int(db.entry_starts[i])
        length = int(db.entry_lengths[i])
        j = min(seedlen, length)
        seed = db.decode(s, s + j)
        if j < seedlen and opts["noshort"]:
            continue
        seeds.append(seed)
        owners.append(i)
    ps = PatternSet(n_forward=len(seeds) - 1)
    ps.patterns = seeds
    ps.esb = [0] * len(seeds)
    ps.eeb = [0] * len(seeds)

    contains: list[list[int]] = [[] for _ in range(n_ent)]
    contained = [False] * n_ent

    model = PrimerMatchModel(db, ps, k=0, node=3)
    for pos, pid, _ in model.engine_hits():
        feq = owners[pid]
        patlen = len(ps.pattern(pid))
        fed = int(db.entry_of(pos))
        if fed < 0 or feq == fed:
            continue
        # extend: query continues after its seed; db continues after the hit
        q = int(db.entry_starts[feq]) + patlen
        d = pos
        total = len(codes)
        while (q < total and d < total and codes[q] == codes[d]
               and codes[q] != eos_code):
            q += 1
            d += 1
        qch = codes[q] if q < total else eos_code
        dch = codes[d] if d < total else eos_code
        if qch == eos_code:
            if dch == eos_code and int(db.get_seq_pos(pos)) == patlen:
                if feq > fed:
                    contains[fed].append(feq)
                    contained[feq] = True
            elif opts["contained"]:
                contains[fed].append(feq)
                contained[feq] = True

    output = [True] * n_ent
    for i in range(n_ent):
        if output[i] and not contained[i]:
            output[i] = False
            if not opts["bareout"]:
                header = ""
                stck = [i]
                while stck:
                    j = stck.pop(0)
                    for c in contains[j]:
                        if output[c]:
                            stck.append(c)
                    output[j] = False
                    # the reference asks for the header at the entry's FIRST
                    # char — set_header_item's pos-1 lookup then resolves to
                    # the PREVIOUS entry (null for the first), so deflines
                    # come out shifted by one (nrdb.cc:292-303)
                    h = db.get_header_data(int(db.entry_starts[j]))
                    if header != "":
                        header += ";"
                    header += h
                out.write(">" + header)
            s = int(db.entry_starts[i])
            length = int(db.entry_lengths[i])
            text = db.decode(s, s + length)
            if opts["bareout"]:
                out.write(text + "\n")
            else:
                for p in range(0, length, 60):
                    out.write("\n" + text[p : p + 60])
                if length == 0:
                    pass
                out.write("\n")


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
