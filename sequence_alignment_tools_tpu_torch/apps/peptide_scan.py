"""peptide_scan CLI on the port's model.

Port of ``sequence_alignment_tools_tpu/apps/peptide_scan.py`` (the
reference program's peptide_scan.cc:63-204 options, :205-437 main), with
the same options and output bytes: peptides against a protein database
or the 6-frame translation of a DNA database (host-precomputed flat AA
space, :mod:`..io.translate`), with DNA-substitution-aware scoring
(aasubdist / codon-anchored aacodonsubdist) and flanking-context
extraction.  The scan runs through the port's ``PrimerMatchModel``: an
amino-acid alphabet takes the same kernels as any alphabet of up to 256
codes."""

from __future__ import annotations

import getopt
import sys

from ..engine.verify import Alignment, EditDistAligner
from ..io.compress import load_db
from ..io.patterns import PatternSet, read_pattern_words
from ..io.translate import TranslatedDB, apply_charmap, translate_db
from ..models.primer_match import PrimerMatchModel
from ..utils.aa import aasubdist, monomolwt
from ..utils.iupac import reverse_comp

USAGE = """Usage: peptide_scan [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -p <sequences>         Peptide sequences, separated by whitespace.
  -P <sequence-file>     Peptide sequences, separated by whitespace.
  -T (A|F)               Translate DNA sequence (All / Forward frames).
  -M <int>               Amino-acid symbol map index. 2: I/L; 3: I/L,K/Q.
  -K <int>               Number of permitted DNA substitutions. Default: 0.
  -x <int>               Hash size (in amino-acids). Default: 4.
  -C <int>               Length of amino-acid context. Default: 1.
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character. Default '\\n'.
  -R <int>               Alignment report interval. Default is 1000.
  -B / -D / -N           I/O & engine strategy hints.
  -v                     Verbose output.
  -h                     This help.
"""


def parse_args(argv):
    opts = {
        "patterns": None,
        "pattern_mode": "inline",
        "database": None,
        "out": None,
        "eos_char": ord("\n"),
        "report_interval": 1000,
        "verbose": False,
        "tryptic": False,
        "translate": False,
        "frame": 0,
        "mapindex": 0,
        "node": 0,
        "dbind": 0,
        "hashsize": 4,
        "nmismatches": 0,
        "contextlen": 1,
    }
    try:
        parsed, _ = getopt.getopt(argv, "p:i:o:P:E:hvR:BN:D:tT:x:K:C:M:")
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
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-R":
            opts["report_interval"] = int(val)
        elif flag == "-N":
            opts["node"] = int(val)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-K":
            opts["nmismatches"] = int(val)
        elif flag == "-x":
            opts["hashsize"] = int(val)
        elif flag == "-M":
            opts["mapindex"] = int(val)
        elif flag == "-C":
            opts["contextlen"] = int(val)
        elif flag == "-T":
            opts["translate"] = True
            opts["frame"] = {"A": 0, "F": 4}.get(val[:1], 0)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-t":
            opts["tryptic"] = True
        elif flag == "-B":
            pass
        elif flag == "-h":
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["patterns"] or not opts["database"]:
        sys.stderr.write("No peptides and/or no sequence database supplied."
                         "\n\n" + USAGE)
        raise SystemExit(1)
    return opts


def _fmt_delta(x: float) -> str:
    return f"{x:.2f}"


def run(opts, out) -> None:
    if opts["pattern_mode"] == "inline":
        pats = opts["patterns"].split()
    else:
        pats = read_pattern_words(opts["patterns"])
    if not pats:
        return
    pats = [p.upper() for p in pats]
    n = len(pats)
    translate = opts["translate"]
    all_frames = translate and opts["frame"] <= 0
    nm = opts["nmismatches"]
    ctx = opts["contextlen"]
    eos_s = chr(opts["eos_char"])

    base_db = load_db(opts["database"], eos_char=opts["eos_char"])
    tdb: TranslatedDB | None = None
    if translate:
        tdb = translate_db(base_db, all_frames=all_frames,
                           mapindex=opts["mapindex"])
        aa_db = tdb.aa_db
    else:
        aa_db = apply_charmap(base_db, opts["mapindex"])

    ps = PatternSet(n_forward=n)
    both = all_frames
    ps.patterns = [""] * (1 + (2 * n if both else n))
    ps.esb = [0] * len(ps.patterns)
    ps.eeb = [0] * len(ps.patterns)
    for i, p in enumerate(pats, start=1):
        ps.patterns[i] = p
        if both:
            ps.patterns[i + n] = p[::-1]

    model = PrimerMatchModel(
        aa_db, ps, k=nm, indels=False, wc=False, textn=False,
        dna_mut=True, seedlen=opts["hashsize"], node=opts["node"],
        report_interval=opts["report_interval"],
    )

    aligner = None
    if nm > 0:
        # editdist_peptide_alignment(key, key, nm, eos, wc=F, tn=F,
        # indels=F, dna_mut=translate, 0, 0, yesno=F, trans=translate)
        # (peptide_scan.cc:325-328)
        aligner = EditDistAligner(
            nm, eos_s, wc=False, textn=False, indels=False,
            dna_mut=translate, yesno=False, trans=translate,
        )

    def text_at(start, length):
        return model._text_at(start, length)

    def codon_at(start, length):
        cids = tdb.codon_ids
        s = max(0, start)
        e = min(start + length, len(cids))
        out_ = list(cids[s:e])
        out_ += [-1] * (length - len(out_))
        return out_

    def getstr(pos, length):
        return aa_db.decode(max(pos, 0), max(pos, 0) + max(length, 0))

    for end, pid, _val in model.engine_hits():
        rc = pid > n
        ind = pid - n if rc else pid
        pat = ps.pattern(pid)
        if nm == 0:
            pa = Alignment(end=end, found=True, value=0)
            pa.start = end - len(pat)
            start = pa.start
            llen = ctx if start >= ctx else start
            lcontext = getstr(start - llen, llen)
            pa.matching_text = getstr(start, len(pat))
            rcontext = getstr(end, ctx)
            pa.codes = [1] * len(pat)
        else:
            pa = aligner.align(
                text_at, pat, end, end, esb=0, eeb=0,
                codon_at=codon_at if translate else None,
            )
            if not pa.found:
                continue
            start = pa.start
            llen = ctx if start >= ctx else start
            lcontext = getstr(start - llen, llen)
            rcontext = getstr(pa.end, ctx)
        pepstr = pat[::-1] if rc else pat
        p = pa.end
        frame = 0
        if translate:
            p, frame = tdb.getbasepos(p)
        if pa.value > nm or (rc and frame < 3) or (not rc and frame > 2):
            continue
        coord_db = base_db if translate else aa_db
        spe = int(coord_db.get_seq_pos(p))
        if translate:
            frame = spe % 3 + 1
            spe = spe // 3
        length = pa.length  # end - start + 1
        sps = spe - length + 1
        pe = pa.end
        psf = pe - length + 1
        header = coord_db.get_header_data(p)
        hindex = int(coord_db.entry_of(p)) + 1
        if rc:
            lcontext, rcontext = rcontext, lcontext
        pos_ = lcontext.rfind(eos_s)
        if pos_ != -1:
            lcontext = "-" + lcontext[pos_ + 1 :]
        pos_ = rcontext.find(eos_s)
        if pos_ != -1:
            rcontext = rcontext[:pos_] + "-"
        if sps < 0:
            continue
        if translate:
            bp, _f2 = tdb.getbasepos(psf)
            buffer = tdb.base_decode(bp, (length - 1) * 3)
            if rc:
                buffer = reverse_comp(buffer)
        else:
            buffer = pa.matching_text
        gsp = int(coord_db.get_seq_pos(p))
        line = (
            f"{ind} {sps} {spe} {lcontext} {pepstr} {rcontext} "
            f"{gsp - (length - 1) * (3 if translate else 1)} {gsp} "
            f"{frame} {'R' if rc else 'F'} {buffer} {hindex} >{header}"
        )
        out.write(line)
        if pa.value > 0:
            delta = 0.0
            at = pa.alignment_string()
            mt = pa.matching_text
            j = 1
            qpos = 0
            while True:
                qpos = next(
                    (i for i in range(qpos, len(at)) if at[i] != "|"), -1
                )
                if qpos < 0:
                    break
                to = pepstr[qpos]
                frm = mt[qpos]
                out.write(
                    f" /sub{j}={frm}{qpos + 1}->{to}({aasubdist(frm, to)})"
                )
                delta += monomolwt(to) - monomolwt(frm)
                qpos += 1
                j += 1
            out.write(f" /delta={_fmt_delta(delta)}")
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
