"""Six-frame DNA->protein translation as a host-precomputed flat AA space.

The reference streams translation char-by-char (``Translated<T>``,
char_io.t:337-482): frames 0..5 are emitted back-to-back in one flat AA
coordinate space, each frame restarting the base stream and skipping
``frame % 3`` leading chars; every ``getch()`` consumes THREE base chars
(including EOS sentinels — an EOS inside a codon emits an EOS amino acid and
still consumes the full triple, so downstream entries keep the global phase).
TPU-native equivalent: vectorized precomputation of the whole translated
array (plus per-position codon ids for the DNA-substitution-aware verify DP)
— the AA space then scans through the same MXU engines as any database.

Byte-level rules replicated from ``Translated::getch``:
- codon[2] missing (end of stream) or == EOS  -> emit EOS
- codon[0] == EOS                             -> emit EOS
- else trans_codon(frame, codon)              (ambiguity codes -> 'X')

Coordinate mapping (``getbasepos``, char_io.t:442-457):
``f`` = first frame with ``p < frame_end_pos[f]`` (last frame accepts
``p == fep[last] + 1``); base position ``(p - fep[f-1]) * 3 + f % 3``.

The port's copy of ``sequence_alignment_tools_tpu/io/translate.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .database import SeqDB
from ..utils.aa import AA_CODONS, CODON_TO_AA

# Translated's emitted alphabet (char_io.t:353-355)
AA_CHMAP = "ACDEFGHIKLMNPQRSTVWXY*"


def _codon_tables() -> tuple[np.ndarray, np.ndarray]:
    """TRANS [5,5,5] AA byte ('X' default) and CID [5,5,5] codon ids, indexed
    by maptable codes A=0 C=1 G=2 T=3 other=4 (util.cc trans_codon)."""
    trans = np.full((5, 5, 5), ord("X"), dtype=np.uint8)
    cid = np.full((5, 5, 5), -1, dtype=np.int8)
    mt = {"A": 0, "C": 1, "G": 2, "T": 3}
    for codon, aa in CODON_TO_AA.items():
        i = AA_CODONS[aa].index(codon)
        trans[mt[codon[0]], mt[codon[1]], mt[codon[2]]] = ord(aa)
        cid[mt[codon[0]], mt[codon[1]], mt[codon[2]]] = i
    return trans, cid


_MAPTABLE = np.full(256, 4, dtype=np.int8)
_RCMAPTABLE = np.full(256, 4, dtype=np.int8)
for _c, _v in zip(b"ACGT", range(4)):
    _MAPTABLE[_c] = _v
for _c, _v in zip(b"TGCA", range(4)):
    _RCMAPTABLE[_c] = _v


@dataclass
class TranslatedDB:
    """Flat translated AA coordinate space over a DNA SeqDB."""

    base: SeqDB
    aa_db: SeqDB  # AA code space the engines scan
    codon_ids: np.ndarray  # int8 [total], -1 for EOS/'X'
    frame_end_pos: np.ndarray  # int64 [6]
    n_frames: int  # 6 (-T A) or 3 (-T F)

    def getbasepos(self, p: int) -> tuple[int, int]:
        """AA flat end-position -> (base flat position, frame)
        (char_io.t:442-457)."""
        fep = self.frame_end_pos
        nf = self.n_frames
        f = -1
        for i in range(nf):
            if (p < fep[i] or fep[i] == 0
                    or (i == nf - 1 and p == fep[i] + 1)):
                f = i
                break
        assert f >= 0
        prev = 0 if f == 0 else int(fep[f - 1])
        return (p - prev) * 3 + f % 3, f

    def base_decode(self, start: int, length: int) -> str:
        """Raw base chars (``getbasech`` reads, char_io.t:389-390)."""
        return self.base.decode(start, start + length)


def translate_db(base: SeqDB, all_frames: bool = True,
                 mapindex: int = 0) -> TranslatedDB:
    """Precompute the full translated AA space of ``base``.

    all_frames: True = frames 0..5 (-T A), False = forward 0..2 (-T F).
    mapindex: amino-acid equivalence map applied to the emitted AA chars
    (``Mapped<Translated<..>>``, select.t:52-72; charmap util.cc:348-372)."""
    trans, cidtab = _codon_tables()
    eos = base.eos_char
    raw = np.frombuffer(base.table, dtype=np.uint8)[base.codes]
    n_frames = 6 if all_frames else 3
    parts = []
    cid_parts = []
    fep = np.zeros(6, dtype=np.int64)
    total = 0
    for f in range(n_frames):
        s = raw[f % 3 :]
        n_aa = (len(s) + 2) // 3
        pad = np.zeros(n_aa * 3 - len(s), dtype=np.uint8)
        sp = np.concatenate([s, pad])
        c0, c1, c2 = sp[0::3], sp[1::3], sp[2::3]
        if f < 3:
            m0, m1, m2 = _MAPTABLE[c0], _MAPTABLE[c1], _MAPTABLE[c2]
        else:
            m0, m1, m2 = _RCMAPTABLE[c2], _RCMAPTABLE[c1], _RCMAPTABLE[c0]
        aa = trans[m0, m1, m2]
        cids = cidtab[m0, m1, m2]
        is_eos = (c2 == eos) | (c2 == 0) | (c0 == eos)
        aa = np.where(is_eos, np.uint8(eos), aa)
        cids = np.where(is_eos, np.int8(-1), cids)
        parts.append(aa)
        cid_parts.append(cids)
        total += n_aa
        fep[f] = total
    aa_chars = np.concatenate(parts)
    codon_ids = np.concatenate(cid_parts)

    # Mapped<> remaps only getnch CODES; getch still returns the original
    # char (char_io.t:280-335) — so the engine scans mapped codes while
    # decode() serves the unmapped text
    code_chars = aa_chars
    if mapindex >= 2:
        remap = np.arange(256, dtype=np.uint8)
        remap[ord("I")] = ord("L")
        if mapindex == 3:
            remap[ord("K")] = ord("Q")
        code_chars = remap[aa_chars]

    table = AA_CHMAP.encode() + bytes([eos])
    aa_db = SeqDB(
        codes=np.empty(0, dtype=np.uint8),
        table=table,
        entry_starts=np.array([0], dtype=np.int64),
        entry_lengths=np.array([len(aa_chars)], dtype=np.int64),
        headers=[""],
        eos_char=eos,
        producer_alphabet=len(table),
    )
    aa_db.codes = aa_db.char_to_code[code_chars].astype(np.uint8)
    if mapindex >= 2:
        aa_db.decode_chars = aa_chars
        # Mapped<> also maps pattern chars through nch (char_io.t:292-296)
        aa_db.char_to_code[ord("I")] = aa_db.char_to_code[ord("L")]
        if mapindex == 3:
            aa_db.char_to_code[ord("K")] = aa_db.char_to_code[ord("Q")]
    return TranslatedDB(
        base=base, aa_db=aa_db, codon_ids=codon_ids,
        frame_end_pos=fep, n_frames=n_frames,
    )


def apply_charmap(db: SeqDB, mapindex: int) -> SeqDB:
    """Mapped<> over a plain (protein) database: remap text CODES (engine
    view) and route equivalent pattern chars to the same code, while
    decode() keeps serving the original characters (char_io.t:280-335)."""
    if mapindex < 2:
        return db
    pairs = [("I", "L"), ("i", "l")]
    if mapindex == 3:
        pairs += [("K", "Q"), ("k", "q")]
    code_remap = np.arange(db.alphabet_size, dtype=np.int16)
    for f, t in pairs:
        cf, ct = db.nch(f), db.nch(t)
        if cf >= 0 and ct >= 0:
            code_remap[cf] = ct
    raw_chars = np.frombuffer(db.table, dtype=np.uint8)[db.codes]
    out = SeqDB(
        codes=code_remap[db.codes].astype(np.uint8),
        table=db.table,
        entry_starts=db.entry_starts,
        entry_lengths=db.entry_lengths,
        headers=db.headers,
        eos_char=db.eos_char,
        producer_alphabet=db.producer_alphabet,
    )
    out.decode_chars = raw_chars
    for f, t in pairs:
        if out.char_to_code[ord(t)] >= 0:
            out.char_to_code[ord(f)] = out.char_to_code[ord(t)]
    return out
