"""Output formatting: alignformat / countformat %-escape engines.

Byte-exact reimplementation of the reference's printf-like conversions
(primer_match.cc:355-720 alignformat, :722-843 countformat), including
backslash escapes (\\n, \\t, \\\\), the %= 50-char wrapped block format and
the %|/%^/%v/%*/%+ alignment-character counters (and their quirks, e.g. %M
iterating q's length over t's characters, primer_match.cc:455-467).

The port's copy of ``sequence_alignment_tools_tpu/utils/format.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .aa import monomolwt
from ..io.patterns import STSEntry

_NULL_STS = STSEntry()


@dataclass
class AlignRecord:
    s: int
    e: int
    five: int
    three: int
    S: int
    E: int
    i: int
    d: int
    p: str
    P: str
    q: str
    Q: str
    r: str
    R: str
    t: str
    T: str
    A: str
    h: str
    H: str
    f: int
    sts: STSEntry = field(default_factory=STSEntry)
    frame: int = -1
    buffer: str = ""


def alignformat(fmt: str, rec: AlignRecord) -> str:
    out: list[str] = []
    pos = 0
    sc = False
    mat = ins = dele = sub = wcm = 0

    def scan_A():
        nonlocal sc, mat, ins, dele, sub, wcm
        if not sc:
            for ch in rec.A:
                if ch == "|":
                    mat += 1
                elif ch == "^":
                    dele += 1  # reference names this counter 'del'
                elif ch == "v":
                    ins += 1  # and this one 'ins' (primer_match.cc:560-656)
                elif ch == "*":
                    sub += 1
                elif ch == "+":
                    wcm += 1
            sc = True

    n = len(fmt)
    while pos < n:
        c = fmt[pos]
        if c == "%":
            pos += 1
            if pos >= n:
                out.append("%")
                break
            v = fmt[pos]
            if v == "s":
                out.append(str(rec.s))
            elif v == "e":
                out.append(str(rec.e))
            elif v == "l":
                out.append(str(rec.e - rec.s))
            elif v == "5":
                out.append(str(rec.five))
            elif v == "3":
                out.append(str(rec.three))
            elif v == "S":
                out.append(str(rec.S))
            elif v == "E":
                out.append(str(rec.E))
            elif v == "i":
                out.append(str(rec.i))
            elif v == "d":
                out.append(str(rec.d))
            elif v == "D":
                out.append(str(len(rec.p) - (rec.s - rec.e)))
            elif v == "M":
                m1 = sum(monomolwt(ch) for ch in rec.p)
                # reference iterates q's length over t's chars (:461-463)
                m2 = sum(monomolwt(rec.t[i0]) for i0 in range(len(rec.q)))
                import math

                out.append(_fmt_float(math.floor((m1 - m2) * 100) / 100))
            elif v == "p":
                out.append(rec.p)
            elif v == "P":
                out.append(rec.P)
            elif v == "q":
                out.append(rec.q)
            elif v == "Q":
                out.append(rec.Q)
            elif v == "r":
                out.append(rec.r)
            elif v == "R":
                out.append(rec.R)
            elif v == "t":
                out.append(rec.t)
            elif v == "T":
                out.append(rec.T)
            elif v == "U":
                from .iupac import reverse_comp

                out.append(reverse_comp(rec.t) if rec.r == "R" else rec.t)
            elif v == "A":
                out.append(rec.A)
            elif v == "h":
                out.append(rec.h)
            elif v == "H":
                out.append(rec.H)
            elif v == "f":
                out.append(str(rec.f))
            elif v == "I":
                out.append(rec.sts.id)
            elif v == "L":
                out.append(rec.sts.size_str)
            elif v == "a":
                out.append(rec.sts.accession)
            elif v == "O":
                out.append(rec.sts.species)
            elif v == "&":
                out.append(rec.sts.altacc)
            elif v == "X":
                out.append(rec.sts.chrom)
            elif v == "F":
                out.append(str(rec.frame))
            elif v == "n":
                out.append(rec.buffer)
            elif v in "mG":
                # %m/%G Tm/ΔG with optional source selector p/q/t/U
                # (primer_match.cc:528-567); unrecognized selector falls
                # back to t without consuming the char
                from .oligotm import oligodg, oligotm

                sel = fmt[pos + 1] if pos + 1 < n else ""
                if sel == "p":
                    dna = rec.p
                    pos += 1
                elif sel == "q":
                    dna = rec.q
                    pos += 1
                elif sel == "t":
                    dna = rec.t
                    pos += 1
                elif sel == "U":
                    from .iupac import reverse_comp

                    dna = reverse_comp(rec.t) if rec.r == "R" else rec.t
                    pos += 1
                else:
                    dna = rec.t
                dna = "".join(ch for ch in dna if ch in "ACGT")
                val = oligotm(dna) if v == "m" else oligodg(dna)
                out.append(f"{val:.2f}")
            elif v == "|":
                scan_A()
                out.append(str(mat))
            elif v == "^":
                scan_A()
                out.append(str(dele))
            elif v == "v":
                scan_A()
                out.append(str(ins))
            elif v == "*":
                scan_A()
                out.append(str(sub))
            elif v == "+":
                scan_A()
                out.append(str(wcm))
            elif v == "=":
                out.append(_default_block(rec))
            elif v == "%":
                out.append("%")
            else:
                out.append(v)
        elif c == "\\":
            pos += 1
            if pos >= n:
                out.append("\\")
                break
            v = fmt[pos]
            out.append({"n": "\n", "t": "\t", "\\": "\\"}.get(v, v))
        else:
            out.append(c)
        pos += 1
    return "".join(out)


def _fmt_float(x: float) -> str:
    """ostream default float formatting (6 significant digits)."""
    s = f"{x:.6g}"
    return s


def _default_block(rec: AlignRecord) -> str:
    """%= — the wrapped default alignment block (primer_match.cc:657-689)."""
    out = []
    len0 = len(rec.T)
    width = 50
    tstart = 0
    for i0 in range(0, len0, width):
        nchars = min(width, len0 - i0)
        tend = tstart + nchars
        editcount = nchars
        for j0 in range(nchars):
            a = rec.A[i0 + j0]
            if a in "|+":
                editcount -= 1
            if a == "v":
                tend -= 1
        out.append(
            f" {rec.T[i0:i0+width]} {tstart} {tend} {editcount}\n"
            f" {rec.A[i0:i0+width]}\n"
            f" {rec.Q[i0:i0+width]} {rec.i}{rec.R}\n"
        )
        if len0 - i0 > width:
            out.append("\n")
        tstart = tend
    return "".join(out)


def countformat(
    fmt: str,
    i: int,
    p: str,
    P: str,
    q: str,
    r: str,
    R: str,
    c: int,
    C: list[int],
    k: int,
    gtmax: bool,
    sts: STSEntry = _NULL_STS,
) -> str:
    out: list[str] = []
    pos = 0
    n = len(fmt)
    while pos < n:
        ch = fmt[pos]
        if ch == "%":
            pos += 1
            if pos >= n:
                out.append("%")
                break
            v = fmt[pos]
            if v == "i":
                out.append(str(i))
            elif v == "p":
                out.append(p)
            elif v == "P":
                out.append(P)
            elif v == "q":
                out.append(q)
            elif v == "r":
                out.append(r)
            elif v == "R":
                out.append(R)
            elif v == "c":
                out.append(str(c))
            elif v == "C":
                out.append(" ".join(str(C[j]) for j in range(k + 1)))
            elif v == "+":
                if gtmax:
                    out.append("+")
            elif v == "%":
                out.append("%")
            elif v == "I":
                out.append(sts.id)
            elif v == "L":
                out.append(sts.size_str)
            elif v == "a":
                out.append(sts.accession)
            elif v == "O":
                out.append(sts.species)
            elif v == "&":
                out.append(sts.altacc)
            elif v == "X":
                out.append(sts.chrom)
            else:
                out.append(v)
        elif ch == "\\":
            pos += 1
            if pos >= n:
                out.append("\\")
                break
            v = fmt[pos]
            out.append({"n": "\n", "t": "\t", "\\": "\\"}.get(v, v))
        else:
            out.append(ch)
        pos += 1
    return "".join(out)


DEFAULT_ALIGN_FORMAT = ">%h\n %T %s %e %d\n %A\n %Q %i%R\n"
DEFAULT_COUNT_FORMAT = "%i %r %q %c%+ ( %C )\n"


# -- pcr_match pair alignformat (pcr_match.cc:339-686) -----------------------

DEFAULT_PCR_ALIGN_FORMAT = (
    ">%h\\n %>T %>s ... %l ... %<e %<T\\n"
    " %>A  %!>s    %!l    %!<e  %<A\\n"
    " %>Q %>r%!>s    %!l    %!<e%<r %<Q %a%R\\n"
)


def _spaces_num(fp: int) -> str:
    """spaces(FILE_POSITION_TYPE) — one space per decimal digit
    (pcr_match.cc:255-259)."""
    ret = " "
    fp //= 10
    while fp:
        ret += " "
        fp //= 10
    return ret


def pcr_alignformat(fmt: str, rec) -> str:
    """The pair %-escape engine with %>/%</%! prefixes (pcr_match.cc:383-668).
    ``rec`` is a models.pcr_match.PairHit."""
    from ..utils.iupac import reverse_comp

    pa, pa1 = rec.pa, rec.pa1
    ppo = rec.ind < rec.ind1
    out: list[str] = []
    pos = 0
    n = len(fmt)
    while pos < n:
        c = fmt[pos]
        if c == "%":
            pos += 1
            if pos >= n:
                out.append("%")
                break
            widthonly = False
            if fmt[pos] == "!":
                widthonly = True
                pos += 1
            dirn = 0
            if pos < n and fmt[pos] == ">":
                dirn = 1
                pos += 1
            elif pos < n and fmt[pos] == "<":
                dirn = -1
                pos += 1
            if pos >= n:
                break
            v = fmt[pos]
            if v == "s":
                if dirn > 0:
                    out.append(_spaces_num(rec.sps) if widthonly
                               else str(rec.sps))
                elif dirn < 0:
                    out.append(_spaces_num(rec.sps1) if widthonly
                               else str(rec.sps1))
            elif v == "e":
                if dirn > 0:
                    out.append(_spaces_num(rec.spe) if widthonly
                               else str(rec.spe))
                elif dirn < 0:
                    out.append(_spaces_num(rec.spe1) if widthonly
                               else str(rec.spe1))
            elif v == "l":
                if dirn > 0:
                    out.append(str(rec.spe - rec.sps))
                elif dirn < 0:
                    out.append(str(rec.spe1 - rec.sps1))
                else:
                    val = rec.spe1 - rec.sps
                    out.append(_spaces_num(val) if widthonly else str(val))
            elif v == "S":
                if dirn > 0:
                    out.append(str(rec.ps))
                elif dirn < 0:
                    out.append(str(rec.ps1))
            elif v == "E":
                if dirn > 0:
                    out.append(str(rec.pe))
                elif dirn < 0:
                    out.append(str(rec.pe1))
            elif v == "i":
                out.append(str(rec.pind))
            elif v == "d":
                if dirn > 0:
                    out.append(str(pa.editdist()))
                elif dirn < 0:
                    out.append(str(pa1.editdist()))
            elif v == "p":
                if dirn > 0:
                    out.append(rec.pat_ind)
                elif dirn < 0:
                    out.append(rec.pat_ind1)
            elif v == "P":
                if dirn > 0:
                    out.append(rec.patdef)
                elif dirn < 0:
                    out.append(rec.patdef1)
            elif v == "I":
                out.append(rec.sts.id)
            elif v == "L":
                if rec.sts.sizeub != rec.sts.sizelb:
                    if dirn > 0:
                        out.append(str(rec.sts.sizelb))
                    elif dirn < 0:
                        out.append(str(rec.sts.sizeub))
                    else:
                        out.append(f"{rec.sts.sizelb}-{rec.sts.sizeub}")
                else:
                    out.append(str(rec.sts.sizelb))
            elif v == "D":
                amplen = rec.spe1 - rec.sps
                deviance = 0
                if amplen > rec.sts.sizeub:
                    deviance = amplen - rec.sts.sizeub
                elif amplen < rec.sts.sizelb:
                    deviance = rec.sts.sizelb - amplen
                out.append(str(deviance))
            elif v == "a":
                out.append(rec.sts.accession)
            elif v == "O":
                out.append(rec.sts.species)
            elif v == "&":
                out.append(rec.sts.altacc)
            elif v == "X":
                out.append(rec.sts.chrom)
            elif v == "q":
                if dirn > 0:
                    out.append(rec.pat_pid)
                elif dirn < 0:
                    out.append(rec.pat_pid1)
            elif v == "Q":
                if dirn > 0:
                    Q = pa.alignment_pattern(rec.pat_pid)
                    out.append(" " * len(Q) if widthonly else Q)
                elif dirn < 0:
                    Q1 = pa1.alignment_pattern(rec.pat_pid1)
                    out.append(" " * len(Q1) if widthonly else Q1)
            elif v == "r":
                if dirn > 0:
                    out.append("R" if rec.rc else "F")
                elif dirn < 0:
                    out.append("R" if rec.rc1 else "F")
                else:
                    out.append("F" if ppo else "R")
            elif v == "R":
                if dirn > 0:
                    out.append(" REVCOMP" if rec.rc else "")
                elif dirn < 0:
                    out.append(" REVCOMP" if rec.rc1 else "")
                else:
                    out.append("" if ppo else " REVERSE-STRAND")
            elif v == "t":
                if dirn > 0:
                    out.append(pa.matching_text)
                elif dirn < 0:
                    out.append(pa1.matching_text)
            elif v == "T":
                if dirn > 0:
                    out.append(pa.alignment_text())
                elif dirn < 0:
                    out.append(pa1.alignment_text())
            elif v == "A":
                if dirn > 0:
                    A = pa.alignment_string()
                    out.append(" " * len(A) if widthonly else A)
                elif dirn < 0:
                    A1 = pa1.alignment_string()
                    out.append(" " * len(A1) if widthonly else A1)
            elif v == "h":
                out.append(rec.header)
            elif v == "H":
                out.append(rec.header.split()[0] if rec.header.split() else "")
            elif v == "f":
                out.append(str(rec.entry_index))
            elif v == "@":
                out.append(rec.amplicon)
            elif v == "*":
                out.append(rec.amplicon if ppo else reverse_comp(rec.amplicon))
            elif v == "N":
                out.append(str(rec.ncount))
            elif v == "%":
                out.append("%")
            elif v == "0":
                h0 = rec.header.split()[0] if rec.header.split() else ""
                out.append(f"{h0} {rec.sps + 1}..{rec.spe1}\t{rec.sts.id}\t")
                if rec.sts.accession != "":
                    out.append("\t" + rec.sts.accession)
                    if rec.sts.chrom != "":
                        out.append("\t" + rec.sts.chrom)
                        if rec.sts.altacc != "":
                            out.append("\t" + rec.sts.altacc)
                            if rec.sts.species != "":
                                out.append("\t" + rec.sts.species)
            else:
                out.append(v)
        elif c == "\\":
            pos += 1
            if pos >= n:
                out.append("\\")
                break
            v = fmt[pos]
            out.append({"n": "\n", "t": "\t", "\\": "\\"}.get(v, v))
        else:
            out.append(c)
        pos += 1
    return "".join(out)
