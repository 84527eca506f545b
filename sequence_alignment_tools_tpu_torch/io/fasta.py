"""FASTA parsing (host side).

Replaces the reference's streamed/indexed FASTA readers
(``fasta_io.t:448-751``) with a whole-file numpy parse: the TPU data model
wants the entire database as one flat packed array anyway, so there is no
char-at-a-time streaming layer.  Gzip input is supported like the reference's
``GZChars`` (``char_io.h:105-127``).

The port's copy of ``sequence_alignment_tools_tpu/io/fasta.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import ctypes
import gzip
import io as _io
from typing import Iterator

import numpy as np


def _open(path: str):
    if path == "-":
        import sys

        return sys.stdin.buffer
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f)
    return f


def iter_fasta(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (defline, sequence_bytes) per entry.  Whitespace inside sequence
    lines is stripped; deflines exclude the leading '>' and the newline."""
    header = None
    chunks: list[bytes] = []
    with _open(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if header is not None:
                    yield header, b"".join(chunks)
                header = line[1:].decode("latin-1")
                chunks = []
            elif header is not None:
                chunks.append(bytes(line.translate(None, b" \t")))
            elif line:
                # sequence data before any '>' — treat as an unnamed entry
                header = ""
                chunks = [bytes(line.translate(None, b" \t"))]
        if header is not None:
            yield header, b"".join(chunks)


def read_fasta(path: str) -> list[tuple[str, bytes]]:
    return list(iter_fasta(path))


def native_pass1(
    path: str,
    filter_mode: int,
    uppercase: bool,
    eos_between: bool,
    eos_start: bool,
    eos_char: int,
):
    """One-sweep native FASTA pass-1 (native/fasta_pack.cpp): returns
    (flat_raw_chars uint8, entry_starts i64, entry_lengths i64, headers)
    with EOS sentinels laid out like compress_seq pass 1
    (compress_seq.cc:442-475), or None when the native toolchain is
    unavailable (callers fall back to :func:`iter_fasta`).

    filter_mode 0 = iter_fasta semantics (drop ' '/'\\t'); 1 = compress_seq
    semantics (keep only bytes 33..126)."""
    from ..native import load_fasta_lib

    lib = load_fasta_lib()
    if lib is None:
        return None
    with _open(path) as f:
        data = f.read()
    buf = np.frombuffer(data, dtype=np.uint8)
    nmax = data.count(b">") + 2
    out_seq = np.empty(len(buf) + nmax + 2, dtype=np.uint8)
    starts = np.empty(nmax, np.int64)
    lengths = np.empty(nmax, np.int64)
    hs = np.empty(nmax, np.int64)
    he = np.empty(nmax, np.int64)
    meta = np.zeros(2, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.sat_fasta_pass1(
        buf.ctypes.data_as(u8p), len(buf),
        int(filter_mode), int(bool(uppercase)),
        int(bool(eos_between)), int(bool(eos_start)), int(eos_char),
        out_seq.ctypes.data_as(u8p),
        starts.ctypes.data_as(i64p), lengths.ctypes.data_as(i64p),
        hs.ctypes.data_as(i64p), he.ctypes.data_as(i64p),
        nmax, meta.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    seq_len, nent = int(meta[0]), int(meta[1])
    headers = [
        data[int(hs[i]) : int(he[i])].decode("latin-1") for i in range(nent)
    ]
    # views, not copies — out_seq over-allocates by at most nmax+2 bytes
    return out_seq[:seq_len], starts[:nent], lengths[:nent], headers


def write_fasta(path: str, entries: list[tuple[str, bytes]], width: int = 60) -> None:
    with open(path, "wb") as f:
        for header, seq in entries:
            f.write(b">" + header.encode("latin-1") + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + b"\n")
