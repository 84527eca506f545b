"""pcr_match CLI of the port: the JAX package's flags, output bytes and
verbose protocol (reference program pcr_match.cc:80-345 options, :688-1265
main), over the port's ``PcrMatchModel``.  ``SAT_DEVICE`` picks the device
(default ``cuda``), as for primer_match."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..io.patterns import (
    PatternSet,
    STSEntry,
    _fold_constraints,
    read_pattern_fasta,
    read_pattern_words,
    read_sts,
)
from ..models.pcr_match import PcrMatchModel
from ..utils.format import DEFAULT_PCR_ALIGN_FORMAT, pcr_alignformat
from ..utils.iupac import reverse_comp

USAGE = """Usage: pcr_match [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -p/-P <sequences>      Primer pairs, separated by whitespace.
  -S <sequence-file>     Primer pairs in UniSTS format.
  -F <sequence-file>     Primer pairs in FASTA format.
  -o <output-file>       Output file (appends). Defaults to standard out.
  -k / -K <#-edits>      Edits / substitutions-only permitted.
  -r                     Reverse reverse complement primer.
  -a                     Output all primer-pair orientations.
  -x <#-chars>           Exact primer seed length.
  -s/-e/-5/-3 <#-chars>  Exact-match constraints (~ negates sense).
  -u                     Upper-case all primers.
  -w / -W                IUPAC wildcards (W: text N wildcard too).
  -E <int>               End-of-sequence character. Default '\\n'.
  -m <int>               Minimum amplicon length. Default: 0.
  -M <int>               Maximum amplicon length. Default: 2000.
  -d <int>               Deviation from reported amplicon length (STS input).
  -b                     Ignore primers in amplicon length computation.
  -A <format>            Alignment output format.
  -R <int>               Alignment report interval. Default 1000.
  -N <int> / -D <int>    Engine / database strategy hints (auto).
  -B                     Buffered I/O hint (accepted for compatibility).
  -v                     Verbose output.
  -h                     This help.
"""


def _signed(arg: str) -> int:
    if arg.startswith("~"):
        return -int(arg[1:])
    return int(arg)


def parse_args(argv):
    opts = {
        "patterns": None,
        "pattern_mode": "inline",
        "database": None,
        "out": None,
        "k": 0,
        "indels": True,
        "rev_comp": False,
        "allorient": False,
        "ucdict": False,
        "wc": False,
        "tn": False,
        "stlen": 0,
        "edlen": 0,
        "fplen": 0,
        "tplen": 0,
        "seedlen": 0,
        "eos_char": ord("\n"),
        "report_interval": 1000,
        "mindist": 0,
        "maxdist": 2000,
        "deviation": -1,
        "betweenlen": False,
        "alignformat": DEFAULT_PCR_ALIGN_FORMAT,
        "verbose": False,
        "veryverbose": False,
        "memmap": True,
        "node": 0,
        "dbind": 0,
    }
    try:
        parsed, _ = getopt.getopt(
            argv, "p:i:o:P:S:F:E:R:k:K:s:e:5:3:x:hrvVubaA:BD:wWN:M:m:d:"
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-p":
            opts["patterns"], opts["pattern_mode"] = val, "inline"
        elif flag == "-P":
            opts["patterns"], opts["pattern_mode"] = val, "words"
        elif flag == "-S":
            opts["patterns"], opts["pattern_mode"] = val, "sts"
        elif flag == "-F":
            opts["patterns"], opts["pattern_mode"] = val, "fasta"
        elif flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag in ("-k", "-K"):
            opts["k"] = int(val)
            opts["indels"] = flag == "-k"
        elif flag == "-3":
            opts["tplen"] = _signed(val)
        elif flag == "-5":
            opts["fplen"] = _signed(val)
        elif flag == "-s":
            opts["stlen"] = _signed(val)
        elif flag == "-e":
            opts["edlen"] = _signed(val)
        elif flag == "-x":
            opts["seedlen"] = int(val)
        elif flag == "-R":
            opts["report_interval"] = int(val)
        elif flag == "-A":
            opts["alignformat"] = val
        elif flag == "-w":
            opts["wc"], opts["tn"] = True, False
        elif flag == "-W":
            opts["wc"], opts["tn"] = True, True
        elif flag == "-u":
            opts["ucdict"] = True
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-N":
            opts["node"] = int(val)
        elif flag == "-M":
            opts["maxdist"] = int(val)
        elif flag == "-d":
            opts["deviation"] = int(val)
        elif flag == "-m":
            opts["mindist"] = int(val)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-V":
            opts["verbose"] = opts["veryverbose"] = True
        elif flag == "-b":
            opts["betweenlen"] = True
        elif flag == "-r":
            opts["rev_comp"] = True
        elif flag == "-a":
            opts["allorient"] = True
        elif flag == "-B":
            opts["memmap"] = False  # buffered I/O mode (verbose msg only)
        elif flag == "-h":
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    # verbose skips the usage check (pcr_match.cc:246)
    if (not opts["patterns"] or not opts["database"]) \
            and not opts["verbose"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    if opts["k"] < 0:
        sys.stderr.write("Number of mismatches (-k) must be at least 0\n\n"
                         + USAGE)
        raise SystemExit(1)
    return opts


def load_patterns(opts):
    """Primer-pair loading (pcr_match.cc:704-791): flat primer list
    (fwd, rev, fwd, rev, ...), STS entries, FASTA deflines."""
    mode = opts["pattern_mode"]
    sts: list[STSEntry] = []
    deflines: list[str] = []
    if mode == "inline":
        pats = opts["patterns"].split()
    elif mode == "words":
        pats = read_pattern_words(opts["patterns"])
    elif mode == "sts":
        sts = read_sts(opts["patterns"])
        pats = []
        for s in sts:
            if s.forward_primer == "":
                break
            pats.append(s.forward_primer)
            pats.append(s.reverse_primer)
    else:
        pats, deflines = read_pattern_fasta(opts["patterns"])
    return pats, sts, deflines


def build_pair_pattern_set(pats, opts, sts, deflines) -> PatternSet:
    """Register the 2n orientations with pair-aware constraints: -5/-3 are
    swapped for even-index (reverse) primers (pcr_match.cc:803-910)."""
    n = len(pats)
    if opts["ucdict"]:
        pats = [p.upper() for p in pats]
    if opts["rev_comp"]:
        pats = [reverse_comp(p) if i % 2 == 1 else p
                for i, p in enumerate(pats)]
    ps = PatternSet(n_forward=n, deflines=deflines, sts=sts)
    ps.patterns = [""] * (2 * n + 1)
    ps.esb = [0] * (2 * n + 1)
    ps.eeb = [0] * (2 * n + 1)
    for i, p in enumerate(pats, start=1):
        fplen, tplen = opts["fplen"], opts["tplen"]
        if i % 2 == 0:
            fplen, tplen = tplen, fplen
        ps.patterns[i] = p
        ps.esb[i], ps.eeb[i] = _fold_constraints(
            len(p), opts["stlen"], opts["edlen"], fplen, tplen, is_rc=False
        )
        ps.patterns[i + n] = reverse_comp(p)
        ps.esb[i + n], ps.eeb[i + n] = _fold_constraints(
            len(p), opts["stlen"], opts["edlen"], fplen, tplen, is_rc=True
        )
    return ps


def run(opts, out) -> None:
    """Reference main-loop structure incl. the verbose stderr protocol
    (pcr_match.cc:698-702 release tag, :810-880 primer listing,
    :928-935 scan milestones, :1261-1263 Done)."""
    from ..models.primer_match import db_pick_report, select_report
    from ..utils.log import ProgressReporter, timestamp

    v = opts["verbose"]
    if v:
        timestamp("Release Tag: $Name:  $")
    if not opts["patterns"] or not opts["database"]:
        return  # verbose-mode early exit 0 (pcr_match.cc:246,768-769)
    pats, sts, deflines = load_patterns(opts)
    if not pats:
        return
    if len(pats) % 2 != 0:
        sys.stderr.write("Odd number of primers!\n\n" + USAGE)
        raise SystemExit(1)
    if opts["pattern_mode"] == "sts":
        opts["rev_comp"] = True
    ps = build_pair_pattern_set(pats, opts, sts, deflines)
    if v and (ps.n_forward < 100 or opts["veryverbose"]):
        n = ps.n_forward
        for i in range(1, n + 1):
            kind = "Forward" if i % 2 == 1 else "Reverse"
            pair = (i - 1) // 2 + 1
            timestamp("[%4d] %s primer: %3d > %s"
                      % (i, kind, pair, ps.pattern(i)))
            timestamp("[%4d] %s primer: %3d < %s"
                      % (i + n, kind, pair, ps.pattern(i + n)))
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    if v:
        for line in db_pick_report(db, opts["memmap"]):
            timestamp(line)
    model = PcrMatchModel(
        db,
        ps,
        k=opts["k"],
        indels=opts["indels"],
        wc=opts["wc"],
        textn=opts["tn"],
        seedlen=opts["seedlen"],
        node=opts["node"],
        report_interval=opts["report_interval"],
        mindist=opts["mindist"],
        maxdist=opts["maxdist"],
        deviation=opts["deviation"],
        betweenlen=opts["betweenlen"],
        allorient=opts["allorient"],
        rev_comp=opts["rev_comp"],
        sts_mode=opts["pattern_mode"] == "sts",
        fasta_mode=opts["pattern_mode"] == "fasta",
    )
    if v:
        for line in select_report(db, ps, k=opts["k"], wc=opts["wc"],
                                  textn=opts["tn"], seedlen=opts["seedlen"],
                                  node=opts["node"], indels=opts["indels"],
                                  dna_mut=False):
            timestamp(line)
        # pm->progress_interval(*ff) (pcr_match.cc:928-930)
        model.inner.progress = ProgressReporter(0.01)
        timestamp("Scanning sequence database...")
    for hit in model.pairs():
        out.write(pcr_alignformat(opts["alignformat"], hit))
    if v:
        timestamp("Done.")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["out"]:
        with open(opts["out"], "a") as f:
            run(opts, f)
    else:
        run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
