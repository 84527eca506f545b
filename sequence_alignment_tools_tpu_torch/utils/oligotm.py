"""Oligo melting temperature / duplex ΔG (primer3's oligotm library).

Nearest-neighbor thermodynamics per Breslauer et al. 1986 (PNAS 83:4746)
and SantaLucia 1998 (PNAS 95:1460); numeric behavior matches the
reference's ``oligotm.c`` (``oligotm()`` ``oligotm.c:283-458``,
``oligodg()`` ``oligotm.c:475-520``) including its quirks:

* integer dH/dS/dG accumulation in table units (100 cal, 0.1 cal/K,
  1 cal) before scaling;
* single-character input double-counts the terminal penalty (the first
  and "last" char are the same position, ``oligotm.c:322-341``);
* ``oligodg``'s symmetry correction is dead code — it calls
  ``symmetry()`` on a pointer to the LAST character only (length-1
  string → odd length → never symmetric, ``oligotm.c:503-509``);
* non-ACGTN characters (or length 0) yield ``OLIGOTM_ERROR``.

primer_match's ``%m``/``%G`` escapes and allvall's Tm gates call with
dna=50 nM, salt=50 mM, SantaLucia method + SantaLucia salt correction
(``primer_match.cc:561-563``, ``allvall.cc:648``).

The port's copy of ``sequence_alignment_tools_tpu/utils/oligotm.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math

OLIGOTM_ERROR = -999999.9999

BRESLAUER = "breslauer"
SANTALUCIA = "santalucia"
SALT_SCHILDKRAUT = "schildkraut"
SALT_SANTALUCIA = "santalucia"
SALT_OWCZARZY = "owczarzy"


def _table(rows: str) -> dict[str, int]:
    """Parse 'XY val' whitespace rows into a pair-keyed int table."""
    t: dict[str, int] = {}
    toks = rows.split()
    for j in range(0, len(toks), 2):
        t[toks[j]] = int(toks[j + 1])
    return t


# Breslauer 1986 (table units: dS 0.1 cal/K/mol, dH 100 cal/mol,
# dG cal/mol of disruption)
_S_BR = _table("""
AA 240 AC 173 AG 208 AT 239 AN 215
CA 129 CC 266 CG 278 CT 208 CN 220
GA 135 GC 267 GG 266 GT 173 GN 210
TA 169 TC 135 TG 129 TT 240 TN 168
NA 168 NC 210 NG 220 NT 215 NN 203
""")
_H_BR = _table("""
AA 91 AC 65 AG 78 AT 86 AN 80
CA 58 CC 110 CG 119 CT 78 CN 91
GA 56 GC 111 GG 110 GT 65 GN 85
TA 60 TC 56 TG 58 TT 91 TN 66
NA 66 NC 85 NG 91 NT 80 NN 80
""")
_G_BR = _table("""
AA 1900 AC 1300 AG 1600 AT 1500 AN 1575
CA 1900 CC 3100 CG 3600 CT 1600 CN 2550
GA 1600 GC 3100 GG 3100 GT 1300 GN 2275
TA 900 TC 1600 TG 1900 TT 1900 TN 1575
NA 1575 NC 2275 NG 2550 NT 1575 NN 1994
""")

# SantaLucia 1998
_S_SL = _table("""
AA 222 AC 224 AG 210 AT 204 AN 224
CA 227 CC 199 CG 272 CT 210 CN 272
GA 222 GC 244 GG 199 GT 224 GN 244
TA 213 TC 222 TG 227 TT 222 TN 227
NA 168 NC 210 NG 220 NT 215 NN 220
""")
_H_SL = _table("""
AA 79 AC 84 AG 78 AT 72 AN 72
CA 85 CC 80 CG 106 CT 78 CN 78
GA 82 GC 98 GG 80 GT 84 GN 80
TA 72 TC 82 TG 85 TT 79 TN 72
NA 72 NC 80 NG 78 NT 72 NN 72
""")
_G_SL = _table("""
AA 1000 AC 1440 AG 1280 AT 880 AN 880
CA 1450 CC 1840 CG 2170 CT 1280 CN 1450
GA 1300 GC 2240 GG 1840 GT 1440 GN 1300
TA 580 TC 1300 TG 1450 TT 1000 TN 580
NA 580 NC 1300 NG 1280 NT 880 NN 580
""")


def symmetry(seq: str) -> bool:
    """True iff seq is its own reverse complement (oligotm.c:599-631)."""
    n = len(seq)
    if n % 2 == 1:
        return False
    for i in range(n // 2):
        s, e = seq[i], seq[n - 1 - i]
        if (s == "A" and e != "T") or (s == "T" and e != "A") \
           or (e == "A" and s != "T") or (e == "T" and s != "A"):
            return False
        if (s == "C" and e != "G") or (s == "G" and e != "C") \
           or (e == "C" and s != "G") or (e == "G" and s != "C"):
            return False
    return True


def divalent_to_monovalent(divalent: float, dntp: float) -> float:
    if divalent == 0:
        dntp = 0
    if divalent < 0 or dntp < 0:
        return OLIGOTM_ERROR
    if divalent < dntp:
        divalent = dntp
    return 120.0 * math.sqrt(divalent - dntp)


def _pair_sums(seq: str, hs: dict[str, int], ss: dict[str, int]):
    """Accumulate the nearest-neighbor table over adjacent pairs; None on
    an out-of-alphabet character (the DFA's ERROR exit)."""
    dh = ds = 0
    for a, b in zip(seq, seq[1:]):
        key = a + b
        if key not in hs:
            return None
        dh += hs[key]
        ds += ss[key]
    if seq and seq[0] not in "ACGTN":
        return None
    return dh, ds


def oligotm(seq: str, dna_nM: float = 50.0, k_mM: float = 50.0,
            divalent: float = 0.0, dntp: float = 0.0,
            method: str = SANTALUCIA,
            salt_correction: str = SALT_SANTALUCIA) -> float:
    mono = divalent_to_monovalent(divalent, dntp)
    if mono == OLIGOTM_ERROR:
        return OLIGOTM_ERROR
    k_mM = k_mM + mono
    if method not in (BRESLAUER, SANTALUCIA):
        return OLIGOTM_ERROR
    if salt_correction not in (SALT_SCHILDKRAUT, SALT_SANTALUCIA,
                               SALT_OWCZARZY):
        return OLIGOTM_ERROR
    if not seq:
        return OLIGOTM_ERROR

    dh = ds = 0
    sym = symmetry(seq)
    if method == BRESLAUER:
        ds = 108
        sums = _pair_sums(seq, _H_BR, _S_BR)
    else:
        if sym:
            ds += 14
        # terminal penalties; a 1-char seq is both terminals
        # (oligotm.c:322-341)
        for ch in (seq[0], seq[-1]):
            if ch in "AT":
                ds += -41
                dh += -23
            elif ch in "CG":
                ds += 28
                dh += -1
        sums = _pair_sums(seq, _H_SL, _S_SL)
    if sums is None:
        return OLIGOTM_ERROR
    dh += sums[0]
    ds += sums[1]

    delta_h = dh * -100.0
    delta_s = ds * -0.1
    n = len(seq)
    if salt_correction == SALT_SCHILDKRAUT:
        corr = -273.15 + 16.6 * math.log10(k_mM / 1000.0)
        return delta_h / (delta_s + 1.987 * math.log(dna_nM / 4.0e9)) + corr
    if salt_correction == SALT_SANTALUCIA:
        delta_s = delta_s + 0.368 * (n - 1) * math.log(k_mM / 1000.0)
        denom_conc = 1.0e9 if sym else 4.0e9
        return delta_h / (delta_s + 1.987 * math.log(dna_nM / denom_conc)) \
            - 273.15
    # Owczarzy
    gc = sum(1 for ch in seq if ch in "CG") / n
    corr = (((4.29 * gc) - 3.95) * 1e-5 * math.log(k_mM / 1000.0)) \
        + (9.40e-6 * (math.log(k_mM / 1000.0) ** 2))
    denom_conc = 1.0e9 if sym else 4.0e9
    tm0 = delta_h / (delta_s + 1.9872 * math.log(dna_nM / denom_conc))
    return (1.0 / ((1.0 / tm0) + corr)) - 273.15


def oligodg(seq: str, method: str = SANTALUCIA) -> float:
    if method not in (BRESLAUER, SANTALUCIA):
        return OLIGOTM_ERROR
    if not seq:
        return OLIGOTM_ERROR
    if any(ch not in "ACGTN" for ch in seq):
        return OLIGOTM_ERROR
    dg = 0
    table = _G_BR if method == BRESLAUER else _G_SL
    if method == SANTALUCIA:
        dg = -1960  # initiation
        if seq[0] in "AT":
            dg += -50
    for a, b in zip(seq, seq[1:]):
        dg += table[a + b]
    if method == SANTALUCIA:
        if seq[-1] in "AT":
            dg += -50
        # the reference evaluates symmetry() on the last character only
        # (a length-1 string), so the -430 symmetry term never fires
        # (oligotm.c:503-509) — replicated by omission.
    return dg / 1000.0


def end_oligodg(seq: str, length: int, method: str = SANTALUCIA) -> float:
    if method not in (BRESLAUER, SANTALUCIA):
        return OLIGOTM_ERROR
    return oligodg(seq if len(seq) < length else seq[len(seq) - length:],
                   method)


def long_seq_tm(seq: str, start: int, length: int, salt_mM: float,
                divalent: float = 0.0, dntp: float = 0.0) -> float:
    mono = divalent_to_monovalent(divalent, dntp)
    if mono == OLIGOTM_ERROR:
        return OLIGOTM_ERROR
    salt_mM = salt_mM + mono
    if start + length > len(seq) or start < 0 or length <= 0:
        return OLIGOTM_ERROR
    gc = sum(1 for ch in seq[start:start + length] if ch in "GC")
    return (81.5 + 16.6 * math.log10(salt_mM / 1000.0)
            + 41.0 * (gc / length) - 600.0 / length)


def seqtm(seq: str, dna_nM: float, salt_mM: float, divalent: float,
          dntp: float, nn_max_len: int, method: str = SANTALUCIA,
          salt_correction: str = SALT_SANTALUCIA) -> float:
    if method not in (BRESLAUER, SANTALUCIA):
        return OLIGOTM_ERROR
    if salt_correction not in (SALT_SCHILDKRAUT, SALT_SANTALUCIA,
                               SALT_OWCZARZY):
        return OLIGOTM_ERROR
    if len(seq) > nn_max_len:
        return long_seq_tm(seq, 0, len(seq), salt_mM, divalent, dntp)
    return oligotm(seq, dna_nM, salt_mM, divalent, dntp, method,
                   salt_correction)
