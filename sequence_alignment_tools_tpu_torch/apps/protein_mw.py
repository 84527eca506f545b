"""protein_mw CLI, the port's copy of
``sequence_alignment_tools_tpu/apps/protein_mw.py``: byte-compatible with
the reference (protein_mw.cc), it sums a user-supplied per-symbol mass
table over whole database entries.  Host code only."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db

USAGE = """Usage: protein_mw [options]

Options:
  -I <protein-indices>   Indices of proteins to compute MW for. Required.
  -i <sequence-database> Input sequence database. Required.
  -m <mass-file>         File of masses. Required.
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character. Default is '\\n'.
  -B / -D (0|1|2|3|4)    I/O and indexing hints.
  -v                     Verbose output.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"indfile": None, "database": None, "massfile": None,
            "out": None, "eos_char": ord("\n"), "dbind": 0,
            "verbose": False}
    try:
        parsed, _ = getopt.getopt(argv, "i:o:hm:I:BD:vE:")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-m":
            opts["massfile"] = val
        elif flag == "-I":
            opts["indfile"] = val
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-B":
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not (opts["indfile"] and opts["database"] and opts["massfile"]):
        sys.stderr.write("One of protein indices, sequence database, or "
                         "mass file is missing.\n\n" + USAGE)
        raise SystemExit(1)
    return opts


def _fmt10(x: float) -> str:
    """ostream << setprecision(10) default-format float."""
    return f"{x:.10g}"


def run(opts, out) -> None:
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    masses = [0.0] * max(db.alphabet_size, 1)
    toks = open(opts["massfile"]).read().split()
    for i in range(0, len(toks) - 1, 2):
        symbol = toks[i]
        try:
            mass = float(toks[i + 1])
        except ValueError:
            break
        b = ord(symbol[0])
        if 31 < b <= 127:
            code = db.nch(b)
            if code >= 0:
                masses[code] = mass

    eos_code = db.eos_code
    data = sys.stdin.read() if opts["indfile"] == "-" else \
        open(opts["indfile"]).read()
    cursor = 0  # reference keeps reading from the stale cursor when
    # fasta_pos rejects an out-of-range index (protein_mw.cc:214-219)
    for tok in data.split():
        try:
            index = int(tok)
        except ValueError:
            break
        if 1 <= index <= db.n_entries:
            cursor = int(db.entry_starts[index - 1])
        mass = 0.0
        while cursor < len(db.codes) and db.codes[cursor] != eos_code:
            mass += masses[db.codes[cursor]]
            cursor += 1
        out.write(f"{index} {_fmt10(mass)}\n")


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
