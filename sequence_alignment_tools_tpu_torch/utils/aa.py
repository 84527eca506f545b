"""Amino-acid tables: genetic code, DNA-substitution distances, masses.

The reference hardcodes its ``aasubdist``/``aacodonsubdist`` tables
(util.cc:457-611); here they are *derived* from the standard genetic code —
``aasubdist(f, t)`` is the minimum nucleotide Hamming distance between any
codon of ``f`` and any codon of ``t``, and ``aacodonsubdist(f, codonid, t)``
anchors ``f`` to its ``codonid``-th codon in standard enumeration order
(TTT, TTC, TTA, ... — the order ``trans_codon`` assigns ids,
util.cc:714-766).  Monoisotopic/average residue masses match util.cc:392-441.

The port's copy of ``sequence_alignment_tools_tpu/utils/aa.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

AAS = "ARNDCQEGHILKMFPSTWYV"

# standard genetic code in TCAG enumeration order (util.cc:731-734 layout)
_AA = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_BASES = "TCAG"


def _codons():
    i = 0
    for b1 in _BASES:
        for b2 in _BASES:
            for b3 in _BASES:
                yield b1 + b2 + b3, _AA[i]
                i += 1


CODON_TO_AA: dict[str, str] = {c: a for c, a in _codons()}

# aa -> list of codons in enumeration order (defines codon ids)
AA_CODONS: dict[str, list[str]] = {}
for c, a in _codons():
    AA_CODONS.setdefault(a, []).append(c)


_NT_MAP = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}
_RC = {"A": "T", "C": "G", "G": "C", "T": "A", "U": "A"}


def trans_codon(frame: int, codon: str) -> tuple[str, int]:
    """DNA codon -> (amino acid, codon id).  Frames >= 3 read the reverse
    complement right-to-left (util.cc:757-766).  Unknown bases -> ('X', -1)."""
    if frame >= 3:
        try:
            codon = "".join(_RC[c] for c in reversed(codon.upper()))
        except KeyError:
            return "X", -1
    codon = codon.upper().replace("U", "T")
    aa = CODON_TO_AA.get(codon)
    if aa is None:
        return "X", -1
    return aa, AA_CODONS[aa].index(codon)


def _hamming(a: str, b: str) -> int:
    return sum(x != y for x, y in zip(a, b))


_AASUB: np.ndarray | None = None


def aasubdist_matrix() -> np.ndarray:
    """[256, 256] int8: min nucleotide substitutions to mutate a codon of
    ``f`` (row, by char code) into a codon of ``t``; -1 for non-AA chars.
    Matches the reference's 20x20 table (util.cc:611-660)."""
    global _AASUB
    if _AASUB is None:
        m = np.full((256, 256), -1, dtype=np.int8)
        for f in AAS:
            for t in AAS:
                d = min(
                    _hamming(cf, ct)
                    for cf in AA_CODONS[f]
                    for ct in AA_CODONS[t]
                )
                for fc in (f, f.lower()):
                    for tc in (t, t.lower()):
                        m[ord(fc), ord(tc)] = d
        _AASUB = m
    return _AASUB


_AACODONSUB: np.ndarray | None = None


def aacodonsubdist_matrix() -> np.ndarray:
    """[256, 6, 256] int8: min substitutions from the ``codonid``-th codon of
    ``f`` to any codon of ``t`` (util.cc:457-610); -1 where undefined."""
    global _AACODONSUB
    if _AACODONSUB is None:
        m = np.full((256, 6, 256), -1, dtype=np.int8)
        for f in AAS:
            for cid, cf in enumerate(AA_CODONS[f]):
                for t in AAS:
                    d = min(_hamming(cf, ct) for ct in AA_CODONS[t])
                    for fc in (f, f.lower()):
                        for tc in (t, t.lower()):
                            m[ord(fc), cid, ord(tc)] = d
        _AACODONSUB = m
    return _AACODONSUB


def aasubdist(f: str, t: str) -> int:
    return int(aasubdist_matrix()[ord(f), ord(t)])


def aacodonsubdist(f: str, codonid: int, t: str) -> int:
    if not (0 <= codonid < 6):
        return -1
    return int(aacodonsubdist_matrix()[ord(f), codonid, ord(t)])


# monoisotopic / average residue masses (util.cc:392-441)
MONO_MASS = {
    "A": 71.037113848, "C": 103.009185648, "D": 115.026943128,
    "E": 129.042593208, "F": 147.068414008, "G": 57.021463768,
    "H": 137.058911944, "I": 113.084064088, "K": 128.094963136,
    "L": 113.084064088, "M": 131.040485808, "N": 114.042927536,
    "P": 97.052763928, "Q": 128.058577616, "R": 156.101111152,
    "S": 87.032028488, "T": 101.047678568, "V": 99.068414008,
    "W": 186.079313056, "Y": 163.063328648,
}
AVE_MASS = {
    "A": 71.078826901, "C": 103.143216117, "D": 115.088513436,
    "E": 129.115401675, "F": 147.176750991, "G": 57.051938663,
    "H": 137.141315021, "I": 113.159491617, "K": 128.174180322,
    "L": 113.159491617, "M": 131.196992594, "N": 114.103877326,
    "P": 97.116752043, "Q": 128.130765564, "R": 156.187706397,
    "S": 87.078151717, "T": 101.105039956, "V": 99.132603378,
    "W": 186.213513503, "Y": 163.176075807,
}

WATER_MONO = 18.0105646863
WATER_AVE = 18.0152622208


def monomolwt(c: str) -> float:
    return MONO_MASS.get(c.upper(), -1.0)


def avemolwt(c: str) -> float:
    return AVE_MASS.get(c.upper(), -1.0)


def peptide_mass(seq: str, mono: bool = True, water: bool = False) -> float:
    tbl = MONO_MASS if mono else AVE_MASS
    m = sum(tbl.get(c.upper(), 0.0) for c in seq)
    if water:
        m += WATER_MONO if mono else WATER_AVE
    return m
