"""Pattern (primer/peptide) input loaders and the pattern registry.

Mirrors the reference's pattern-input surface: whitespace-separated files/
strings (``-p``/``-P``), FASTA pattern files (``-F``), UniSTS (``-S``)
(primer_match.cc:871-924, sts_io.h:11-96), with per-pattern exact-start/
exact-end constraints folded from ``-s/-e/-5/-3`` exactly as
primer_match.cc:991-1080 does (negative = "~"-inexact sense).

The port's copy of ``sequence_alignment_tools_tpu/io/patterns.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.iupac import reverse_comp, reverse


@dataclass
class STSEntry:
    """One UniSTS record (sts_io.h:11-96)."""

    id: str = ""
    forward_primer: str = ""
    reverse_primer: str = ""
    sizelb: int = 0
    sizeub: int = 0
    accession: str = ""
    chrom: str = ""
    altacc: str = ""
    species: str = ""

    @property
    def size_str(self) -> str:
        if self.sizeub != self.sizelb:
            return f"{self.sizelb}-{self.sizeub}"
        return str(self.sizelb)


def _atoi(s: str) -> int:
    """C atoi: optional sign + leading digits, 0 on no parse."""
    s = s.lstrip(" \t\n\r\f\v")
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[: j])


def _parse_sts_line(line: str, prev: STSEntry) -> STSEntry:
    """One line via ``istream >>`` token semantics (sts_io.cc:11-43): 7
    whitespace tokens, then species = the REST of the line verbatim (leading
    whitespace included).  The reference reuses ONE ``sts_entry`` across the
    whole file, and a ``>>`` that hits end-of-line fails in the sentry BEFORE
    erasing the target string -- so missing trailing fields silently RETAIN
    the previous record's values (pcr_match.cc:733 ``while ((*ifs) >> s)``)."""
    ws = " \t\r\f\v"
    pos = 0
    n = len(line)

    def tok() -> str | None:
        nonlocal pos
        while pos < n and line[pos] in ws:
            pos += 1
        if pos == n:
            return None
        start = pos
        while pos < n and line[pos] not in ws:
            pos += 1
        return line[start:pos]

    toks = [tok() for _ in range(7)]
    ok = all(t is not None for t in toks)
    sid, fwd, rev, size, acc, chrom, altacc = (
        t if t is not None else old
        for t, old in zip(
            toks,
            (prev.id, prev.forward_primer, prev.reverse_primer, "",
             prev.accession, prev.chrom, prev.altacc),
        )
    )
    # species_ and the size bounds are recomputed every record (getline on a
    # failed stream leaves an empty buffer; `size` is a fresh local)
    species = line[pos:] if ok else ""
    p = size.find("-")
    if p != -1:
        sizelb = _atoi(size[:p])
        sizeub = _atoi(size[p + 1 :])
    else:
        sizelb = sizeub = _atoi(size)
    return STSEntry(sid, fwd, rev, sizelb, sizeub, acc, chrom, altacc, species)


def read_sts(path: str) -> list[STSEntry]:
    """Parse UniSTS records, stopping at the first record with an empty
    forward primer like both reference drivers do (pcr_match.cc:734-736,
    primer_match.cc:893-895)."""
    import sys

    data = sys.stdin.read() if path == "-" else open(path).read()
    lines = data.split("\n")
    if data.endswith("\n"):
        lines = lines[:-1]
    out = []
    cur = STSEntry()
    for line in lines:
        cur = _parse_sts_line(line, cur)
        if cur.forward_primer == "":
            break
        out.append(cur)
    return out


def read_pattern_words(path: str) -> list[str]:
    """Whitespace-separated patterns (-P); '-' = stdin."""
    import sys

    data = sys.stdin.read() if path == "-" else open(path).read()
    return data.split()


def read_pattern_fasta(path: str) -> tuple[list[str], list[str]]:
    """FASTA patterns (-F): returns (sequences, deflines)."""
    from .fasta import iter_fasta

    seqs, defs = [], []
    for header, seq in iter_fasta(path):
        s = seq.decode("latin-1")
        if s == "":
            break
        seqs.append(s)
        defs.append(header)
    return seqs, defs


@dataclass
class PatternSet:
    """The registry handed to engines: ids 1..n forward, n+1..2n revcomp
    (primer_match.cc:1026-1031), with per-pattern (esb, eeb) exact-base
    constraints."""

    patterns: list[str] = field(default_factory=list)  # index 0 unused
    esb: list[int] = field(default_factory=list)
    eeb: list[int] = field(default_factory=list)
    n_forward: int = 0
    deflines: list[str] = field(default_factory=list)
    sts: list[STSEntry] = field(default_factory=list)

    @property
    def n_total(self) -> int:
        return len(self.patterns) - 1

    def pattern(self, pid: int) -> str:
        return self.patterns[pid]

    def is_revcomp(self, pid: int) -> bool:
        return pid > self.n_forward

    def forward_index(self, pid: int) -> int:
        return pid - self.n_forward if pid > self.n_forward else pid

    @property
    def max_len(self) -> int:
        return max((len(p) for p in self.patterns[1:]), default=0)

    @property
    def min_len(self) -> int:
        return min((len(p) for p in self.patterns[1:]), default=0)


def _fold_constraints(n: int, stlen: int, edlen: int, fplen: int, tplen: int,
                      is_rc: bool) -> tuple[int, int]:
    """Fold -s/-e/-5/-3 into (esb, eeb) for one pattern of length ``n``
    (primer_match.cc:991-1011 forward, :1029-1056 revcomp).  Negative values
    carry the '~' inexact sense."""
    esb = 0
    eeb = 0
    if not is_rc:
        if stlen > 0:
            esb = stlen
        if fplen > esb:
            esb = max(esb, fplen)
        if edlen < 0 and n + edlen > esb:
            esb = n + edlen
        if tplen < 0 and n + tplen > esb:
            esb = n + tplen
        if edlen > 0:
            eeb = edlen
        if tplen > eeb:
            eeb = tplen
        if stlen < 0 and n + stlen > eeb:
            eeb = n + stlen
        if fplen < 0 and n + fplen > eeb:
            eeb = n + fplen
    else:
        if stlen > 0:
            esb = stlen
        if tplen > esb:
            esb = tplen
        if edlen < 0 and n + edlen > esb:
            esb = n + edlen
        if fplen < 0 and n + fplen > esb:
            esb = n + fplen
        if edlen > 0:
            eeb = edlen
        if fplen > eeb:
            eeb = fplen
        if stlen < 0 and n + stlen > eeb:
            eeb = n + stlen
        if tplen < 0 and n + tplen > eeb:
            eeb = n + tplen
    return esb, eeb


def build_pattern_set(
    patterns: list[str],
    rev_comp: bool = False,
    translate: bool = False,
    uppercase: bool = False,
    stlen: int = 0,
    edlen: int = 0,
    fplen: int = 0,
    tplen: int = 0,
    deflines: list[str] | None = None,
    sts: list[STSEntry] | None = None,
) -> PatternSet:
    if uppercase:
        patterns = [p.upper() for p in patterns]
    n = len(patterns)
    ps = PatternSet(n_forward=n, deflines=deflines or [], sts=sts or [])
    both = rev_comp or translate
    ps.patterns = [""] * (1 + (2 * n if both else n))
    ps.esb = [0] * len(ps.patterns)
    ps.eeb = [0] * len(ps.patterns)
    for i, p in enumerate(patterns, start=1):
        ps.patterns[i] = p
        ps.esb[i], ps.eeb[i] = _fold_constraints(
            len(p), stlen, edlen, fplen, tplen, is_rc=False
        )
        if both:
            rc = reverse(p) if translate else reverse_comp(p)
            ps.patterns[i + n] = rc
            ps.esb[i + n], ps.eeb[i + n] = _fold_constraints(
                len(p), stlen, edlen, fplen, tplen, is_rc=True
            )
    return ps
