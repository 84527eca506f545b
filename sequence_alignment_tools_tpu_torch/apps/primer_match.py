"""primer_match CLI on the port's model.

Port of ``sequence_alignment_tools_tpu/apps/primer_match.py``: the same
options (``USAGE``, ``parse_args`` and ``load_patterns`` are the port's
copies of the JAX app's), the same verbose protocol and the same output
bytes, for exact search, for ``-k``/``-K`` through the pigeonhole engines
(halves, bases), the k-edit and k-mismatch filter engine (``-k 2``,
``-K 2``), the seed-table engines (``-N 6`` hash, ``-N 15`` gs) and
``-T`` (peptide patterns against the 6-frame translation,
:mod:`..io.translate`).
"""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..io.patterns import (
    STSEntry,
    build_pattern_set,
    read_pattern_fasta,
    read_pattern_words,
    read_sts,
)
from ..io.translate import translate_db
from ..models.primer_match import (
    PrimerMatchModel,
    db_pick_report,
    select_report,
)
from ..utils.format import (
    DEFAULT_ALIGN_FORMAT,
    DEFAULT_COUNT_FORMAT,
    AlignRecord,
    alignformat,
    countformat,
)
from ..utils.iupac import reverse_comp
from ..utils.log import ProgressReporter, timestamp

USAGE = """Usage: primer_match [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -p <sequences>         Primer sequences, separated by whitespace.
  -P <sequence-file>     Primer sequences, separated by whitespace.
  -F <sequence-file>     Primer sequences in FASTA format.
  -S <sequence-file>     Primer sequences in UniSTS format.
  -o <output-file>       Output file (appends). Defaults to standard out.
  -k <#-mismatches>      Insertions, deletions and substitutions permitted.
  -K <#-mismatches>      Substitutions only. At most one of -k and -K.
  -r                     Match reverse complement of primers too.
  -s/-e/-5/-3 <#-chars>  Exact-match constraints (~ negates sense).
  -u                     Uppercase pattern sequences.
  -w / -W                IUPAC wildcards (W: text N wildcard too).
  -E <int>               End-of-sequence character. Default '\\n'.
  -c                     Output counts (only).
  -a                     Aggregate forward & reverse complement counts.
  -M <max-count>         Maximum number of occurrences to count.
  -A <format>            Alignment output format.
  -C <format>            Counts output format.
  -R <int>               Alignment report interval.
  -N <int> / -D <int>    Engine / database strategy hints (auto).
  -B / -I                I/O hints (accepted for compatibility).
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
        "dna_mut": False,
        "rev_comp": False,
        "ucdict": False,
        "wc": False,
        "tn": False,
        "stlen": 0,
        "edlen": 0,
        "fplen": 0,
        "tplen": 0,
        "seedlen": 0,
        "eos_char": ord("\n"),
        "maxcount": 0,
        "report_interval": 1000,
        "alignformat": DEFAULT_ALIGN_FORMAT,
        "countformat": DEFAULT_COUNT_FORMAT,
        "alignments": True,
        "counts": False,
        "aggregate": False,
        "translate": False,
        "verbose": False,
        "node": 0,
        "dbind": 0,
        "memmap": True,
    }
    try:
        parsed, _ = getopt.getopt(
            argv, "p:i:o:P:F:S:M:k:K:s:e:3:5:x:E:hrucavA:C:R:BN:D:IwWT"
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-p":
            opts["patterns"], opts["pattern_mode"] = val, "inline"
        elif flag == "-P":
            opts["patterns"], opts["pattern_mode"] = val, "words"
        elif flag == "-F":
            opts["patterns"], opts["pattern_mode"] = val, "fasta"
        elif flag == "-S":
            opts["patterns"], opts["pattern_mode"] = val, "sts"
            opts["rev_comp"] = True
        elif flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-k" or flag == "-K":
            if val.startswith("."):
                opts["k"] = int(val[1:])
                opts["dna_mut"] = True
            else:
                opts["k"] = int(val)
            opts["indels"] = flag == "-k"
        elif flag == "-r":
            opts["rev_comp"] = True
        elif flag == "-u":
            opts["ucdict"] = True
        elif flag == "-c":
            opts["counts"] = True
            opts["alignments"] = False
        elif flag == "-a":
            opts["aggregate"] = True
        elif flag == "-w":
            opts["wc"], opts["tn"] = True, False
        elif flag == "-W":
            opts["wc"], opts["tn"] = True, True
        elif flag == "-s":
            opts["stlen"] = _signed(val)
        elif flag == "-e":
            opts["edlen"] = _signed(val)
        elif flag == "-5":
            opts["fplen"] = _signed(val)
        elif flag == "-3":
            opts["tplen"] = _signed(val)
        elif flag == "-x":
            opts["seedlen"] = int(val)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-M":
            opts["maxcount"] = int(val)
        elif flag == "-A":
            if val:
                opts["alignformat"] = val
            opts["alignments"] = True
        elif flag == "-C":
            if val:
                opts["countformat"] = val
            opts["counts"] = True
        elif flag == "-R":
            opts["report_interval"] = int(val)
        elif flag == "-N":
            opts["node"] = int(val)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-B":
            opts["memmap"] = False  # buffered I/O mode (verbose msg only)
        elif flag == "-T":
            opts["translate"] = True
        elif flag == "-I":
            pass  # I/O strategy hint
        elif flag == "-h":
            sys.stdout.write(USAGE)
            raise SystemExit(0)
    # verbose skips the usage check (primer_match.cc:274) — an empty pattern
    # list then exits 0 after the Release Tag line
    if (not opts["patterns"] or not opts["database"]) and not opts["verbose"]:
        sys.stderr.write("No primers and/or no sequence database supplied.\n\n"
                         + USAGE)
        raise SystemExit(1)
    return opts


def load_patterns(opts):
    deflines: list[str] = []
    sts: list[STSEntry] = []
    mode = opts["pattern_mode"]
    if mode == "inline":
        pats = opts["patterns"].split()
    elif mode == "words":
        pats = read_pattern_words(opts["patterns"])
    elif mode == "fasta":
        pats, deflines = read_pattern_fasta(opts["patterns"])
    else:
        sts = read_sts(opts["patterns"])
        pats = []
        for s in sts:
            pats.append(s.forward_primer)
            pats.append(s.reverse_primer)
    return pats, deflines, sts




def run(opts, out) -> None:
    """The JAX app's main loop (reference primer_match.cc structure,
    verbose stderr protocol included) over the port's model."""
    v = opts["verbose"]
    if v:
        timestamp("Release Tag: $Name:  $")
    if not opts["patterns"] or not opts["database"]:
        return  # verbose-mode early exit 0 (primer_match.cc:274,927-929)
    pats, deflines, sts = load_patterns(opts)
    if not pats:
        return
    if v:
        timestamp("Read primers")
        if opts["ucdict"]:
            timestamp("Uppercase primers")
    ps = build_pattern_set(
        pats,
        rev_comp=opts["rev_comp"],
        translate=opts["translate"],
        uppercase=opts["ucdict"],
        stlen=opts["stlen"],
        edlen=opts["edlen"],
        fplen=opts["fplen"],
        tplen=opts["tplen"],
        deflines=deflines,
        sts=sts,
    )
    if v:
        if ps.n_forward < 100:
            for i in range(1, ps.n_forward + 1):
                timestamp("Pattern %3d > %s" % (i, ps.pattern(i)))
                if opts["rev_comp"]:
                    timestamp("Pattern %3d < %s"
                              % (i, ps.pattern(i + ps.n_forward)))
        timestamp("Put primers in an array")
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    if v:
        for line in db_pick_report(db, opts["memmap"]):
            timestamp(line)
    # -T: peptide patterns against the 6-frame translation
    # (primer_match.cc:229-230 option, :1026-1031 reversed patterns,
    # :1161-1232 frame + coordinate math).  The reference requires a
    # normalized database for translation (select.t:163-164); the
    # translated flat AA space comes from io/translate.py, shared with
    # peptide_scan.
    tdb = translate_db(db, all_frames=True) if opts["translate"] else None
    model = PrimerMatchModel(
        tdb.aa_db if tdb is not None else db,
        ps,
        k=opts["k"],
        indels=opts["indels"],
        wc=opts["wc"],
        textn=opts["tn"],
        dna_mut=opts["dna_mut"],
        seedlen=opts["seedlen"],
        node=opts["node"],
        report_interval=opts["report_interval"],
    )
    if v:
        for line in select_report(db, ps, k=opts["k"], wc=opts["wc"],
                                  textn=opts["tn"], seedlen=opts["seedlen"],
                                  node=opts["node"], indels=opts["indels"],
                                  dna_mut=opts["dna_mut"]):
            timestamp(line)
        # kt->progress_interval(*ff, 1.0) (primer_match.cc:1109-1111)
        model.progress = ProgressReporter(0.01)

    n = ps.n_forward
    k = opts["k"]
    counts = opts["counts"]
    maxcount = opts["maxcount"]
    patcount = [[0] * (k + 1) for _ in range(ps.n_total + 1)]
    maxpatcount = [False] * (ps.n_total + 1)
    null_sts = STSEntry()

    for hit in model.hits():
        pid = hit.pid
        if maxcount > 0 and maxpatcount[pid]:
            continue
        a = hit.alignment
        ed = a.editdist()
        if ed > k:
            continue
        rc = pid > n
        ind = pid - (n if rc else 0)
        if opts["alignments"] and tdb is not None:
            # translated coordinates (primer_match.cc:1160-1232): map the
            # AA end position to bases, frame = base seq pos % 3 + 1
            # (negated for reversed patterns), seq coords in AA units,
            # %n = the matched DNA codons (revcomp'd for R)
            bp, _f0 = tdb.getbasepos(a.end)
            spe = int(db.get_seq_pos(bp))
            frame = spe % 3 + 1
            spe = spe // 3
            sps = spe - a.length + 1
            pe = a.end
            pstart = pe - a.length + 1
            pat = ps.pattern(pid)
            header = db.get_header_data(bp)
            entry_idx = int(db.entry_of(bp)) + 1
            bps, _f1 = tdb.getbasepos(pstart)
            buffer = tdb.base_decode(bps, (a.length - 1) * 3)
            if rc:
                rec = AlignRecord(
                    s=sps, e=spe, five=spe, three=sps, S=pstart, E=pe,
                    i=ind, d=ed, p=ps.pattern(ind),
                    P=deflines[ind - 1] if deflines else "",
                    q=pat[::-1], Q=a.alignment_pattern(pat)[::-1],
                    r="R", R=" REVSTRAND",
                    t=a.matching_text[::-1], T=a.alignment_text()[::-1],
                    A=a.alignment_string()[::-1],
                    h=header,
                    H=header.split()[0] if header.split() else "",
                    f=entry_idx,
                    sts=sts[(ind + 1) // 2 - 1] if sts else null_sts,
                    frame=-frame, buffer=reverse_comp(buffer),
                )
            else:
                rec = AlignRecord(
                    s=sps, e=spe, five=sps, three=spe, S=pstart, E=pe,
                    i=ind, d=ed, p=ps.pattern(ind),
                    P=deflines[ind - 1] if deflines else "",
                    q=pat, Q=a.alignment_pattern(pat),
                    r="F", R="",
                    t=a.matching_text, T=a.alignment_text(),
                    A=a.alignment_string(),
                    h=header,
                    H=header.split()[0] if header.split() else "",
                    f=entry_idx,
                    sts=sts[(ind + 1) // 2 - 1] if sts else null_sts,
                    frame=frame, buffer=buffer,
                )
            out.write(alignformat(opts["alignformat"], rec))
        elif opts["alignments"]:
            p = a.end
            spe = int(model.db.get_seq_pos(p))
            sps = spe - a.length + 1
            pe = a.end
            pstart = pe - a.length + 1
            pat = ps.pattern(pid)
            header = model.db.get_header_data(p)
            entry_idx = int(model.db.entry_of(p)) + 1
            rec = AlignRecord(
                s=sps,
                e=spe,
                five=spe if rc else sps,
                three=sps if rc else spe,
                S=pstart,
                E=pe,
                i=ind,
                d=ed,
                p=ps.pattern(ind),
                P=deflines[ind - 1] if deflines else "",
                q=pat,
                Q=a.alignment_pattern(pat),
                r="R" if rc else "F",
                R=" REVCOMP" if rc else "",
                t=a.matching_text,
                T=a.alignment_text(),
                A=a.alignment_string(),
                h=header,
                H=header.split()[0] if header.split() else "",
                f=entry_idx,
                sts=sts[(ind + 1) // 2 - 1] if sts else null_sts,
            )
            out.write(alignformat(opts["alignformat"], rec))
        if counts:
            patcount[pid][ed] += 1
            if maxcount > 0 and sum(patcount[pid]) >= maxcount:
                maxpatcount[pid] = True

    if counts:
        for i in range(1, n + 1):
            c = list(patcount[i])
            total = sum(c)
            gtmax = maxpatcount[i] if maxcount > 0 else False
            patdef = deflines[i - 1] if deflines else ""
            stsref = sts[(i + 1) // 2 - 1] if sts else null_sts
            if not opts["aggregate"]:
                out.write(
                    countformat(opts["countformat"], i, ps.pattern(i), patdef,
                                ps.pattern(i), "F", "", total, c, k, gtmax,
                                stsref)
                )
            if opts["rev_comp"] or opts["translate"]:
                # translate also carries reversed patterns
                # (primer_match.cc:1296: rev_comp || translate)
                if not opts["aggregate"]:
                    c = [0] * (k + 1)
                    total = 0
                    gtmax = False
                for kk in range(k + 1):
                    c[kk] += patcount[i + n][kk]
                    total += patcount[i + n][kk]
                if maxcount > 0:
                    gtmax = gtmax or maxpatcount[i + n]
                if not opts["aggregate"]:
                    out.write(
                        countformat(opts["countformat"], i, ps.pattern(i),
                                    patdef, ps.pattern(i + n), "R", " REVCOMP",
                                    total, c, k, gtmax, stsref)
                    )
            if opts["aggregate"]:
                out.write(
                    countformat(opts["countformat"], i, ps.pattern(i), patdef,
                                "", "", "", total, c, k, gtmax, stsref)
                )

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
