"""Flat-coordinate sequence database (the TPU-native ``FastaFile``).

The whole multi-FASTA database is one flat ``uint8`` code array with EOS
sentinels — the reference's normalized ``.sqn`` representation
(``compress_seq.cc:442-475``, ``fasta_io.t:139-263``) promoted to the
*canonical in-memory form*: it uploads directly to HBM and shards by position.

Byte-compatible artifact support (``.seq``/``.hdr``/``.idb``/``.idx``/
``.tbl``/``.sqn``/``.tbz``/``.sqz``) lives in :mod:`.compress`; this module is
the in-memory model plus coordinate mapping:

- ``entry_starts[i]`` — flat index of entry *i*'s first sequence char
  (the ``.idb`` sortedvector keys, ``fasta_io.t:389-411``)
- ``get_header_data(p)`` / ``get_seq_pos(p)`` / ``is_subseq`` — binary search
  over ``entry_starts`` (``SortSeqFastaFile::set_header_item``,
  ``fasta_io.t:163-178``)

All positions follow the reference's convention: a hit's ``end`` is the flat
index one past its last character (``cp.pos()`` after ``getnch()``).

The port's copy of ``sequence_alignment_tools_tpu/io/database.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .fasta import iter_fasta

DEFAULT_EOS = ord("\n")


@dataclass
class SeqDB:
    """Normalized flat sequence database.

    Attributes:
      codes: flat uint8 array of alphabet codes (EOS sentinels included).
      table: bytes, code -> raw character (the ``.tbl`` contents).
      entry_starts: int64 [n_entries] flat index of each entry's first char.
      entry_lengths: int64 [n_entries].
      headers: deflines.
      eos_char: raw EOS byte value.
    """

    codes: np.ndarray
    table: bytes
    entry_starts: np.ndarray
    entry_lengths: np.ndarray
    headers: list[str]
    eos_char: int = DEFAULT_EOS
    # CharacterProducer::size() as the reference sees it: 256 for raw FASTA /
    # .seq streams, the .tbl size for normalized databases (char_io.h:50,
    # char_io.t:251-253).  Engine auto-selection keys off this
    # (select.cc:107-127), so it must reflect the *input representation*,
    # not our always-normalized in-memory form.
    producer_alphabet: int = 256

    char_to_code: np.ndarray = field(init=False)

    def __post_init__(self):
        c2c = np.full(256, -1, dtype=np.int16)
        for code, ch in enumerate(self.table):
            c2c[ch] = code
        self.char_to_code = c2c

    # -- basic properties ---------------------------------------------------

    @property
    def alphabet_size(self) -> int:
        return len(self.table)

    @property
    def eos_code(self) -> int:
        return int(self.char_to_code[self.eos_char])

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_entries(self) -> int:
        return len(self.headers)

    # -- char <-> code ------------------------------------------------------

    def nch(self, ch: str | int) -> int:
        """Raw char -> alphabet code, -1 if absent (CharacterProducer::nch)."""
        b = ord(ch) if isinstance(ch, str) else ch
        return int(self.char_to_code[b])

    def producer_nch(self, ch: str) -> int:
        """nch() as the reference's producer reports it: identity for raw
        streams (char_io.h:138), table code for normalized ones."""
        if self.producer_alphabet == 256:
            return ord(ch)
        return self.nch(ch)

    def ch(self, code: int) -> str:
        """Alphabet code -> raw char (CharacterProducer::ch)."""
        return chr(self.table[code])

    # set by load_db when a persisted suffix-tree/array artifact exists
    # next to the loaded representation (select.cc:184-209 trigger)
    has_suffix_tree: bool = False

    # which representation load_db picked ("sqn"/"sqz"/"seq"/"raw") — drives
    # the verbose database-selection message (select.t:29-188)
    source_kind: str = "raw"

    # Mapped<> databases (char_io.t:280-335): getnch() remaps codes but
    # getch() still returns the ORIGINAL character — when set, decode() reads
    # these chars instead of table[codes].
    decode_chars: np.ndarray | None = None

    def decode(self, start: int, end: int) -> str:
        """Raw characters for flat range [start, end)."""
        if self.decode_chars is not None:
            return self.decode_chars[start:end].tobytes().decode("latin-1")
        tbl = np.frombuffer(self.table, dtype=np.uint8)
        return tbl[self.codes[start:end]].tobytes().decode("latin-1")

    # -- coordinate mapping (fasta_io.t:154-263 semantics) ------------------

    def entry_of(self, p) -> np.ndarray | int:
        """Entry index for flat end-position ``p``: the last entry whose
        first-char position is <= p-1 (``set_header_item`` looks up pos-1
        over keys = entry first-char positions, fasta_io.t:163-178).  -1 when
        p-1 precedes every entry (the reference's NoHeaderData case)."""
        return np.searchsorted(
            self.entry_starts, np.asarray(p) - 1, side="right"
        ) - 1

    def get_seq_pos(self, p) -> np.ndarray | int:
        """Flat end-position -> offset within its entry; 0 on NoHeaderData
        (fasta_io.t:195-202)."""
        e = self.entry_of(p)
        return np.where(e >= 0, p - self.entry_starts[np.maximum(e, 0)], 0)

    def get_header_data(self, p) -> str:
        e = int(self.entry_of(p))
        return self.headers[e] if e >= 0 else ""

    def is_subseq(self, s: int, e: int) -> bool:
        """True iff start (a first-char flat index) and end-position e fall
        in the same entry (fasta_io.t:204-213 uses start+1 and end)."""
        e1 = int(self.entry_of(s + 1))
        e2 = int(self.entry_of(e))
        return e1 >= 0 and e1 == e2

    def fasta_pos(self, entry: int, rel: int) -> int:
        return int(self.entry_starts[entry]) + rel

    # -- construction -------------------------------------------------------

    @classmethod
    def from_entries(
        cls,
        entries: list[tuple[str, bytes]],
        eos_char: int = DEFAULT_EOS,
        eos_start: bool = True,
        eos_between: bool = True,
        uppercase: bool = True,
        dna_optimized_table: bool = True,
        mapindex: int = 0,
    ) -> "SeqDB":
        """Build the flat code space the way ``compress_seq`` does
        (EOS layout compress_seq.cc:442-475; table order :707-712:
        A,C,G,T first, then remaining observed bytes ascending)."""
        headers = [h for h, _ in entries]
        seqs = []
        for _, s in entries:
            if uppercase:
                s = s.upper()
            if mapindex:
                from ..utils.iupac import map_string

                s = map_string(mapindex, s.decode("latin-1")).encode("latin-1")
            seqs.append(np.frombuffer(s, dtype=np.uint8))

        eos = np.array([eos_char], dtype=np.uint8)
        parts: list[np.ndarray] = []
        starts = np.empty(len(seqs), dtype=np.int64)
        pos = 0
        if eos_start and eos_between:
            parts.append(eos)
            pos += 1
        for i, s in enumerate(seqs):
            starts[i] = pos
            parts.append(s)
            pos += len(s)
            if eos_between:
                parts.append(eos)
                pos += 1
        raw = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        return cls._from_raw(
            raw, starts, lengths, headers, eos_char, dna_optimized_table
        )

    @classmethod
    def _from_raw(
        cls, raw, starts, lengths, headers, eos_char, dna_optimized_table=True
    ) -> "SeqDB":
        """Finish construction from the flat raw-char layout: observed-char
        census -> table (DNA-optimized order) -> normalized codes."""
        obs = np.zeros(256, dtype=bool)
        obs[raw] = True
        order = np.arange(256)
        if dna_optimized_table:
            for i, ch in enumerate(b"ACGT"):
                order[i], order[ch] = ch, i
        table = bytes(int(b) for b in order if obs[b])

        db = cls(
            codes=np.empty(0, dtype=np.uint8),
            table=table,
            entry_starts=np.asarray(starts, dtype=np.int64),
            entry_lengths=np.asarray(lengths, dtype=np.int64),
            headers=headers,
            eos_char=eos_char,
        )
        # uint8 lookup (every raw char is in the census table): one take,
        # no int16 widen + astype round-trip — ~17x faster at genome scale
        c2c8 = np.zeros(256, dtype=np.uint8)
        c2c8[np.frombuffer(table, dtype=np.uint8)] = np.arange(
            len(table), dtype=np.uint8
        )
        db.codes = c2c8[raw]
        return db

    @classmethod
    def from_fasta(cls, path: str, **kw) -> "SeqDB":
        if not kw.get("mapindex"):
            # native one-sweep pass 1 (native/fasta_pack.cpp); the Python
            # iter_fasta path below is the portable fallback
            from .fasta import native_pass1

            res = native_pass1(
                path,
                filter_mode=0,
                uppercase=kw.get("uppercase", True),
                eos_between=kw.get("eos_between", True),
                eos_start=kw.get("eos_start", True),
                eos_char=kw.get("eos_char", DEFAULT_EOS),
            )
            if res is not None:
                raw, starts, lengths, headers = res
                return cls._from_raw(
                    raw, starts, lengths, headers,
                    kw.get("eos_char", DEFAULT_EOS),
                    kw.get("dna_optimized_table", True),
                )
        return cls.from_entries(list(iter_fasta(path)), **kw)
