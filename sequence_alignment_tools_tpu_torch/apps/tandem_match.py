"""tandem_match CLI on the port's model.

Port of ``sequence_alignment_tools_tpu/apps/tandem_match.py``, the
tandem-repeat motif finder (tandem_match.cc); the motif scan is
``PrimerMatchModel(k=0)`` (the filter kernel on the card).

Scans for motif occurrences (optionally + reverse complements), chains
consecutive hits spaced exactly one motif length apart into repeat arrays
(absorbing overlapping same-motif hits, tandem_match.cc:395-436), verifies
the whole array ``motif x copyn`` at edit distance 0, and reports arrays
passing the min-copy-count / min-length gates (tandem_match.cc:446-470).

The reference's main program has bit-rotted (it no longer compiles against
its own pattern_hit API, and its getopt switch is missing the -r/-A/-c/-l
cases), so this implementation completes the documented option surface;
output uses the same %-escape alignformat family as primer_match."""

from __future__ import annotations

import getopt
import sys

from ..engine.verify import EditDistAligner
from ..io.compress import load_db
from ..io.patterns import PatternSet
from ..models.primer_match import PrimerMatchModel
from ..utils.format import AlignRecord, alignformat
from ..utils.iupac import reverse_comp

DEFAULT_FORMAT = ">%h\n %T %s %e\n %A\n %Q %i%R\n"

USAGE = """Usage: tandem_match [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -p <sequences>         Tandem repeat motifs, separated by whitespace.
  -r                     Match reverse complement of motifs too.
  -c <int>               Minimum motif copy count.
  -l <int>               Minimum tandem array length.
  -w / -W                IUPAC wildcards (W: text N wildcard too).
  -A <format>            Alignment output format.
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character. Default '\\n'.
  -B / -D / -N           I/O and engine strategy hints.
  -v                     Verbose output.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"patterns": None, "database": None, "out": None,
            "eos_char": ord("\n"), "rev_comp": False, "wc": False,
            "tn": False, "minmotifcount": -1, "minmotiflen": -1,
            "alignformat": DEFAULT_FORMAT, "node": 0, "dbind": 0,
            "verbose": False}
    try:
        parsed, _ = getopt.getopt(argv, "p:i:o:E:hrvA:BD:wWN:c:l:")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-p":
            opts["patterns"] = val
        elif flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-r":
            opts["rev_comp"] = True
        elif flag == "-A":
            opts["alignformat"] = val
        elif flag == "-w":
            opts["wc"], opts["tn"] = True, False
        elif flag == "-W":
            opts["wc"], opts["tn"] = True, True
        elif flag == "-N":
            opts["node"] = int(val)
        elif flag == "-c":
            opts["minmotifcount"] = int(val)
        elif flag == "-l":
            opts["minmotiflen"] = int(val)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-B":
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["patterns"] or not opts["database"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def run(opts, out) -> None:
    pats = [p.upper() for p in opts["patterns"].split()]
    if not pats:
        return
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
    model = PrimerMatchModel(db, ps, k=0, wc=opts["wc"], textn=opts["tn"],
                             node=opts["node"])
    aligner = EditDistAligner(0, chr(opts["eos_char"]), opts["wc"],
                              opts["tn"], indels=True, dna_mut=False)

    hits = [(end, pid) for end, pid, _ in model.engine_hits()]
    consumed = [False] * len(hits)
    for idx, (pos, pid) in enumerate(hits):
        if consumed[idx]:
            continue
        motif = ps.pattern(pid)
        L = len(motif)
        chain = [idx]
        next_pos = pos + L
        for j in range(idx + 1, len(hits)):
            if consumed[j]:
                continue
            pos_j, pid_j = hits[j]
            if pos_j > next_pos:
                break
            if pid_j == pid:
                chain.append(j)
                if pos_j == next_pos:
                    next_pos = pos_j + L
        first_pos = hits[chain[0]][0]
        last_pos = hits[chain[-1]][0]
        copyn = (last_pos - first_pos + L) // L
        if (copyn >= opts["minmotifcount"]
                and last_pos - first_pos + L >= opts["minmotiflen"]):
            alignstr = motif * copyn
            pa = aligner.align(model._text_at, alignstr, last_pos, last_pos)
            if pa.found and pa.editdist() == 0:
                spe = int(db.get_seq_pos(pa.end))
                sps = spe - pa.length + 1
                pe = pa.end
                pstart = pe - pa.length + 1
                rc = pid > n
                ind = pid - (n if rc else 0)
                header = db.get_header_data(pa.end)
                rec = AlignRecord(
                    s=sps, e=spe,
                    five=spe if rc else sps, three=sps if rc else spe,
                    S=pstart, E=pe, i=ind, d=0,
                    p=ps.pattern(ind), P="", q=alignstr,
                    Q=pa.alignment_pattern(alignstr),
                    r="R" if rc else "F", R=" REVCOMP" if rc else "",
                    t=pa.matching_text, T=pa.alignment_text(),
                    A=pa.alignment_string(), h=header,
                    H=header.split()[0] if header.split() else "",
                    f=int(db.entry_of(pa.end)) + 1,
                )
                out.write(alignformat(opts["alignformat"], rec))
        for j in chain:
            consumed[j] = True


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
