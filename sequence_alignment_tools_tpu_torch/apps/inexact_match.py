"""inexact_match CLI on the port's scanners.

Port of ``sequence_alignment_tools_tpu/apps/inexact_match.py``, byte-
compatible with the reference's k-error scanner demo (inexact_match.cc).
It binds the scanners directly and prints their raw candidates, with no
clustering: ``SellersScanner.scan`` (the Sellers row DP, ``sellers.cu``
on the card) for k > 0, ``ConvScanner.scan`` (the filter kernel) for
k = 0.  The JAX app's ``block=`` hints have no counterpart.

Reference quirks reproduced:
- ``-P`` appends the LAST pattern twice (the post-loop ``if (pattern != "")
  push_back`` at inexact_match.cc:140-142);
- per-hit verify anchors ``editdist_alignment(pid, key, ...)`` — the pattern
  ID serves as the window's lower end, making every column up to the hit a
  free end (inexact_match.cc:198-200)."""

from __future__ import annotations

import getopt
import sys

from ..engine.verify import EditDistAligner
from ..io.compress import load_db
from ..io.patterns import PatternSet
from ..models.primer_match import PrimerMatchModel
from ..ops.conv_scan import ConvScanner
from ..ops.sellers import SellersScanner
from ..ops.tables import build_tables
from ..utils.iupac import reverse_comp

USAGE = """Usage: inexact_match [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -p <sequences>         Pattern sequences, separated by whitespace.
  -P <sequence-file>     Pattern sequences, separated by whitespace.
  -k <#-edits>           Edit distance. Default 0.
  -r                     Match reverse complement of patterns too.
  -u                     Uppercase pattern sequences.
  -w / -W                IUPAC wildcards (W: text N too).
  -E <int>               End-of-sequence character.
  -B / -D <int>          I/O strategy hints.
  -q                     Suppress diagnostic messages.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"patterns": None, "pattern_mode": "inline", "database": None,
            "rev_comp": False, "ucdict": False, "quiet": False,
            "wc": False, "tn": False, "nmismatch": 0,
            "eos_char": ord("\n"), "dbind": 0}
    try:
        parsed, _ = getopt.getopt(argv, "p:i:P:hruqwWk:E:BD:")
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
        elif flag == "-w":
            opts["wc"], opts["tn"] = True, False
        elif flag == "-W":
            opts["wc"], opts["tn"] = True, True
        elif flag == "-k":
            opts["nmismatch"] = int(val)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-B":
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if (not opts["patterns"] or not opts["database"]
            or opts["nmismatch"] < 0):
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def run(opts, out) -> None:
    if opts["pattern_mode"] == "inline":
        pats = opts["patterns"].split()
    else:
        data = open(opts["patterns"]).read()
        pats = data.split()
        if pats:
            pats.append(pats[-1])  # reference re-appends the last token
    if opts["ucdict"]:
        pats = [p.upper() for p in pats]
    n = len(pats)
    ps = PatternSet(n_forward=n)
    both = opts["rev_comp"]
    ps.patterns = [""] * (1 + (2 * n if both else n))
    ps.esb = [0] * len(ps.patterns)
    ps.eeb = [0] * len(ps.patterns)
    for i, p in enumerate(pats, start=1):
        ps.patterns[i] = p
        if both:
            ps.patterns[i + n] = reverse_comp(p)

    db = load_db(opts["database"], eos_char=opts["eos_char"])
    k = opts["nmismatch"]
    # raw shift_and_inexact candidates: the Sellers filter without clustering
    model = PrimerMatchModel(db, ps, k=k, indels=True, wc=opts["wc"],
                             textn=opts["tn"], node=5)
    tables = build_tables(ps, db, opts["wc"], opts["tn"])
    if k > 0:
        scanner = SellersScanner(tables, k=k, indels=True)
    else:
        scanner = ConvScanner(tables, k=0)
    aligner = EditDistAligner(k, chr(opts["eos_char"]), opts["wc"],
                              opts["tn"], indels=True, dna_mut=False)
    cands = sorted((end, p0) for end, p0, _ in scanner.scan(db.codes))
    for end, p0 in cands:
        pid = p0 + 1
        kw = ps.pattern(pid)
        if not opts["quiet"]:
            ea = aligner.align(model._text_at, kw, pid, end, esb=0, eeb=0)
            header = db.get_header_data(ea.end)
            out.write(f">{header}\n")
            out.write(f" {ea.alignment_text()} {ea.start} {end} "
                      f"{ea.editdist()}\n")
            out.write(f" {ea.alignment_string()}\n")
            out.write(f" {ea.alignment_pattern(kw)} {pid}\n")
        else:
            out.write(f"{pid} {kw} {end}\n")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
