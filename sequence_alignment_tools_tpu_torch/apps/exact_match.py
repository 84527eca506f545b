"""exact_match CLI on the port's model.

Port of ``sequence_alignment_tools_tpu/apps/exact_match.py``, byte-
compatible with the reference's minimal exact scanner (exact_match.cc):
``PrimerMatchModel(k=0)`` with the keyword-tree (``node=3``) or
shift-and (``node=4``) emission order, so the scan is
``ConvScanner.scan`` (the filter kernel on the card).

Notable reference quirks reproduced: the per-hit ``exact_alignment`` is
constructed with the PATTERN ID as its end position (exact_match.cc:158),
so the non-quiet coordinates derive from ``get_seq_pos(pid)``."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..io.patterns import PatternSet, read_pattern_words
from ..models.primer_match import PrimerMatchModel
from ..utils.introsort import introsort
from ..utils.iupac import reverse_comp

USAGE = """Usage: exact_match [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -p <sequences>         Pattern sequences, separated by whitespace.
  -P <sequence-file>     Pattern sequences, separated by whitespace.
  -r                     Match reverse complement of patterns too.
  -u                     Uppercase pattern sequences.
  -k                     Use keyword tree.
  -b                     Use bitvector.
  -q                     Suppress diagnostic messages. Optional.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"patterns": None, "pattern_mode": "inline", "database": None,
            "rev_comp": False, "ucdict": False, "quiet": False,
            "keyword_tree": False, "bitvec": False}
    try:
        parsed, _ = getopt.getopt(argv, "p:ri:P:hrukbq")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-p":
            opts["patterns"], opts["pattern_mode"] = val, "inline"
        elif flag == "-P":
            opts["patterns"], opts["pattern_mode"] = val, "words"
        elif flag == "-i":
            opts["database"] = val
        elif flag == "-q":
            opts["quiet"] = True
        elif flag == "-r":
            opts["rev_comp"] = True
        elif flag == "-u":
            opts["ucdict"] = True
        elif flag == "-k":
            opts["keyword_tree"] = True
        elif flag == "-b":
            opts["bitvec"] = True
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["patterns"] or not opts["database"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def run(opts, out) -> None:
    if opts["pattern_mode"] == "inline":
        pats = opts["patterns"].split()
    else:
        pats = read_pattern_words(opts["patterns"])
    if opts["ucdict"]:
        pats = [p.upper() for p in pats]
    n = len(pats)
    # registration order: pattern i, then its revcomp as id n+i
    ps = PatternSet(n_forward=n)
    both = opts["rev_comp"]
    ps.patterns = [""] * (1 + (2 * n if both else n))
    ps.esb = [0] * len(ps.patterns)
    ps.eeb = [0] * len(ps.patterns)
    for i, p in enumerate(pats, start=1):
        ps.patterns[i] = p
        if both:
            ps.patterns[i + n] = reverse_comp(p)

    db = load_db(opts["database"])
    engine = "exact_sa" if (opts["bitvec"] and not opts["keyword_tree"]) \
        else "exact_kt"
    model = PrimerMatchModel(db, ps, k=0,
                             node=4 if engine == "exact_sa" else 3)

    # batches of >= 100 hits, each key-normalized (exact_match.cc:136-139)
    hits = [[end, pid] for end, pid, _ in model.engine_hits()]
    introsort(hits, lambda a, b: a[0] < b[0])
    for end, pid in hits:
        kw = ps.pattern(pid - n) if pid > n else ps.pattern(pid)
        if not opts["quiet"]:
            # reference constructs exact_alignment with END = pattern id
            # (exact_match.cc:158), so the coordinates derive from the id and
            # the start underflows as uint64
            seq_end = int(db.get_seq_pos(pid))
            out.write(f">{db.get_header_data(pid)}\n")
            out.write(f"{pid} {kw} {kw} "
                      f"{(seq_end - len(kw)) % (1 << 64)} {seq_end}\n")
        else:
            line = f"{end} {kw} "
            if pid > n:
                line += "REV"
            out.write(line + "\n")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
