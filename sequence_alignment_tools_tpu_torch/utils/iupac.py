"""IUPAC nucleotide wildcard tables and sequence transforms.

Semantics mirror the reference's ``util.cc`` (``iupac_compatible`` at
util.cc:121, ``iupac_contains`` at :187, ``iupac_contained`` at :253,
``iupac_revcomp`` at :319, ``charmap`` at :348).  The *compatible* relation is
"the two IUPAC sets intersect"; the data below intentionally reproduces the
reference's table verbatim — including its quirks (e.g. ``T`` listing ``V``,
``N``'s list missing ``B``) — because downstream hit lists must match the
reference bit-for-bit.

The port's copy of ``sequence_alignment_tools_tpu/utils/iupac.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

# pattern char -> string of text chars it is *compatible* with (sets intersect)
# (util.cc:121-162; quirks preserved deliberately for hit-list parity)
COMPATIBLE: dict[str, str] = {
    "A": "ARMWDHVN",
    "B": "GTUCYKSBN",
    "C": "CYMSBHVN",
    "D": "GATURWKDN",
    "G": "GRKSBDVN",
    "H": "ACTUMYWHN",
    "K": "GTKBDN",
    "M": "ACMHVN",
    "N": "ACGTURYKMSWVDHVN",
    "R": "GARDVN",
    "S": "GCSBVN",
    "T": "TUYKWVDHN",
    "U": "UTYKWVDHN",
    "V": "GCARSMVN",
    "W": "ATUWDHN",
    "Y": "TUCYBHN",
    "X": "MRWSYKVHDBXN",
}

# wildcard char -> string of chars whose set it *contains* (util.cc:187-228)
CONTAINS: dict[str, str] = {
    "A": "A",
    "B": "GTUCYKSB",
    "C": "C",
    "D": "GATURWKD",
    "G": "G",
    "H": "ACTUMYWH",
    "K": "GTK",
    "M": "ACM",
    "N": "ACGTURYKMSWVDHVN",
    "R": "GAR",
    "S": "GCS",
    "T": "TU",
    "U": "UT",
    "V": "GCARSMV",
    "W": "ATUW",
    "Y": "TUCY",
    "X": "MRWSYKVHDBXN",
}

# char -> string of wildcards that contain it (util.cc:253-294)
CONTAINED: dict[str, str] = {
    "A": "ARMWDHVN",
    "B": "BNX",
    "C": "CYMSBHVN",
    "D": "DNX",
    "G": "GRKSBDVN",
    "H": "HNX",
    "K": "KBDNX",
    "M": "MHVNX",
    "N": "NX",
    "R": "RDVNX",
    "S": "SBVNX",
    "T": "TUYKWVDHN",
    "U": "UTYKWVDHN",
    "V": "VNX",
    "W": "WDHNX",
    "Y": "YBHNX",
    "X": "X",
}

_RC_PAIRS = {
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "M": "K", "R": "Y", "W": "W", "S": "S", "Y": "R", "K": "M",
    "V": "B", "H": "D", "D": "H", "B": "V",
}


def _build_revcomp_map() -> np.ndarray:
    """256-entry byte map; unknown chars map to themselves (util.cc:319-346)."""
    m = np.arange(256, dtype=np.uint8)
    for a, b in _RC_PAIRS.items():
        m[ord(a)] = ord(b)
        m[ord(a.lower())] = ord(b.lower())
    return m


REVCOMP_MAP: np.ndarray = _build_revcomp_map()

# 256x256 boolean matrices, [pattern_char, text_char]
_COMPAT_MATRIX: np.ndarray | None = None


def compat_matrix() -> np.ndarray:
    """[256, 256] bool: COMPAT[w, c] == iupac_compatible(w, c) (util.cc:164-185).

    Case-insensitive in each argument independently (the reference registers
    both cases in its per-wildcard strings; both-case cross pairs come from
    registering upper->upper and lower->lower only — replicated here).
    """
    global _COMPAT_MATRIX
    if _COMPAT_MATRIX is None:
        m = np.zeros((256, 256), dtype=bool)
        for w, s in COMPATIBLE.items():
            for c in s:
                m[ord(w), ord(c)] = True
                m[ord(w.lower()), ord(c.lower())] = True
        _COMPAT_MATRIX = m
    return _COMPAT_MATRIX


def iupac_compatible(w: str, c: str) -> bool:
    return bool(compat_matrix()[ord(w), ord(c)])


_CONTAINS_MATRIX: np.ndarray | None = None


def contains_matrix() -> np.ndarray:
    """[256, 256] bool: M[w, c] == iupac_contains(w, c)."""
    global _CONTAINS_MATRIX
    if _CONTAINS_MATRIX is None:
        m = np.zeros((256, 256), dtype=bool)
        for w, s in CONTAINS.items():
            for c in s:
                m[ord(w), ord(c)] = True
                m[ord(w.lower()), ord(c.lower())] = True
        _CONTAINS_MATRIX = m
    return _CONTAINS_MATRIX


def reverse_comp(sequence: str) -> str:
    """IUPAC-aware reverse complement (util.cc:375-381)."""
    b = sequence.encode("latin-1")
    arr = np.frombuffer(b, dtype=np.uint8)
    return REVCOMP_MAP[arr][::-1].tobytes().decode("latin-1")


def reverse(sequence: str) -> str:
    return sequence[::-1]


def charmap(mapindex: int, c: str) -> str:
    """Amino-acid equivalence maps: 2 = I->L, 3 = I->L and K->Q (util.cc:348-373)."""
    if mapindex == 2:
        return {"i": "l", "I": "L"}.get(c, c)
    if mapindex == 3:
        return {"i": "l", "I": "L", "k": "q", "K": "Q"}.get(c, c)
    return c


def map_string(mapindex: int, s: str) -> str:
    return "".join(charmap(mapindex, c) for c in s)


def is_iupac_wildcard(c: str) -> bool:
    """True if c is an ambiguity code (more than one base), per COMPATIBLE keys
    minus the concrete bases ACGTU."""
    return c.upper() in COMPATIBLE and c.upper() not in "ACGTU"


def pattern_has_wildcard(pat: str) -> bool:
    return any(is_iupac_wildcard(c) for c in pat)
