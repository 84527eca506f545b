"""compress_seq-compatible artifact reader/writer.

Byte-for-byte compatible with the reference preprocessor's on-disk formats
(``compress_seq.cc:306-1007``) so databases preprocessed by either tool are
interchangeable:

- ``.seq``  flat raw characters with EOS sentinels (uppercased, whitespace
            stripped; chars outside 33..126 dropped — compress_seq.cc:544-575)
- ``.hdr``  deflines joined by ``\\n`` (compress_seq.cc:405-537)
- ``.idx``  ASCII index lines ``count headerpos seqpos rawfilepos``
- ``.idb``  binary sortedvector<int64,int64>: count, then (key, hdrpos) pairs;
            keys are each entry's first-char flat position, final sentinel
            key = total_len + 1 (reproducing the reference's extra ``seqpos++``
            at compress_seq.cc:600-607)
- ``.tbl``/``.sqn``  observed-char table (A,C,G,T first — compress_seq.cc:707-712)
            and byte-per-char normalized codes
- ``.tbz``/``.sqz``  same table + MSB-first bit-packed codes, padded to
            lcm(bits, 64)/8-byte units (char_io.t:59-102 unpacking)
- ``.grd``  guard file marking an in-progress build (compress_seq.cc:336-345)

Incremental rebuild follows the reference's make-style timestamp checks
(compress_seq.cc:321-373).

The port's copy of ``sequence_alignment_tools_tpu/io/compress.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np

from .database import SeqDB, DEFAULT_EOS
from .fasta import iter_fasta


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


# ---------------------------------------------------------------------------
# low-level artifact encoding


def write_idb(path: str, keys: np.ndarray, values: np.ndarray) -> None:
    """Binary sortedvector serialization (sortedvector.t bwrite): int64 count
    then interleaved (key, value) int64 pairs, little-endian."""
    n = len(keys)
    buf = np.empty(1 + 2 * n, dtype="<i8")
    buf[0] = n
    buf[1::2] = keys
    buf[2::2] = values
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def read_idb(path: str) -> tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, dtype="<i8")
    n = int(raw[0])
    return raw[1 : 1 + 2 * n : 2].copy(), raw[2 : 1 + 2 * n : 2].copy()


def pack_sqz(codes: np.ndarray, alphabet_size: int, eos_code: int = 0) -> bytes:
    """MSB-first bit-packing, padded to lcm(bits, 64)/8-byte units by
    repeating the EOS code (the reference writer keeps emitting eos_char after
    EOF until the unit fills — compress_seq.cc:806-820)."""
    bits = max(1, (alphabet_size - 1).bit_length())
    unit_bytes = _lcm(bits, 64) // 8
    codes_per_unit = unit_bytes * 8 // bits
    pad = (-len(codes)) % codes_per_unit
    if pad:
        codes = np.concatenate(
            [codes, np.full(pad, eos_code, dtype=np.uint8)]
        )
    shift = np.arange(bits - 1, -1, -1, dtype=np.uint8)
    bitarr = ((codes[:, None] >> shift) & 1).astype(np.uint8).ravel()
    packed = np.packbits(bitarr)  # MSB-first by default
    return packed.tobytes()


def unpack_sqz(data: bytes, alphabet_size: int, n_codes: int) -> np.ndarray:
    bits = max(1, (alphabet_size - 1).bit_length())
    bitarr = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    bitarr = bitarr[: n_codes * bits].reshape(n_codes, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (bitarr * weights).sum(axis=1).astype(np.uint8)


# ---------------------------------------------------------------------------
# the preprocessor


def _census_table(raw: np.ndarray, eos_char: int | None = None,
                  dna_optimized: bool = True,
                  add_revcomp: bool = False) -> bytes:
    """Observed-character census -> ``.tbl`` byte table: the single
    source for all three build paths (compress -T, compress normalize/
    bits, and load_db's raw-``.seq`` fallback).  Marks ``eos_char`` when
    given, applies the IUPAC revcomp closure when ``add_revcomp``
    (the reference's addrc census runs for normalize, compress AND
    tableonly alike — compress_seq.cc:566-569), and the dna-optimized
    ACGT-first order (compress_seq.cc:690-722)."""
    obs = np.zeros(256, dtype=bool)
    obs[raw] = True
    if eos_char is not None:
        obs[eos_char] = True
    if add_revcomp:
        from ..utils.iupac import REVCOMP_MAP

        obs[REVCOMP_MAP[np.flatnonzero(obs)]] = True
    order = np.arange(256)
    if dna_optimized:
        for i, ch in enumerate(b"ACGT"):
            order[i], order[ch] = ch, i
    return bytes(int(b) for b in order if obs[b])


def compress(
    fasta_path: str,
    eos: bool = True,
    init_eos: bool = True,
    eos_char: int = DEFAULT_EOS,
    uppercase: bool = True,
    normalize: bool = False,
    suffix_tree: bool = False,
    dna_optimized: bool = True,
    add_revcomp_chars: bool = False,
    compress_bits: bool = False,
    binindex: bool = True,
    cleanup: bool = True,
    force: bool = False,
    check_only: bool = False,
    tableonly: bool = False,
    guard: bool = False,
    verbose: bool = False,
) -> bool:
    """Build compress_seq artifacts next to ``fasta_path``.

    Returns True if (re)build work was needed.  ``check_only`` reports without
    writing (reference ``-c``, exit status semantics at compress_seq.cc:371-373).

    ``tableonly`` (reference ``-T``, compress_seq.cc:213-218,365,690): scan
    the FASTA for its observed-character census and write ONLY the ``.tbl``
    (dna-optimized order), no .seq/.hdr/index artifacts.  ``guard``
    (reference ``-G``, compress_seq.cc:267,336-345,676): explicit crash
    guard — this implementation always writes the transient ``.grd``
    marker (a strict superset of the reference's opt-in guard: artifact
    bytes are identical, and a stale marker from a crashed build forces a
    rebuild whether or not -G was given).
    """
    del guard  # always-on here (see docstring); flag accepted for parity
    base = fasta_path
    src_time = os.path.getmtime(fasta_path)

    def stale(ext: str) -> bool:
        p = base + ext
        return (not os.path.exists(p)) or os.path.getmtime(p) < src_time

    need_pass1 = force or stale(".hdr") or stale(".idb" if binindex else ".idx")
    have_seq_form = (
        os.path.exists(base + ".seq")
        or (normalize and os.path.exists(base + ".sqn"))
        or (compress_bits and os.path.exists(base + ".sqz"))
    )
    need_pass1 = need_pass1 or not have_seq_form
    need_norm = normalize and (force or stale(".sqn") or stale(".tbl"))
    need_comp = compress_bits and (force or stale(".sqz") or stale(".tbz"))
    if tableonly:
        need_pass1 = force or stale(".tbl")
        need_norm = need_comp = False
    had_grd = os.path.exists(base + ".grd")
    if had_grd:
        need_pass1 = True

    if not (need_pass1 or need_norm or need_comp):
        return False
    if check_only:
        return True

    # guard file marks an in-progress build (crash-safe idempotent rebuild)
    with open(base + ".grd", "w"):
        pass

    # pass 1: flat .seq + .hdr + index; census
    from_raw = _read_raw(fasta_path, eos, init_eos, eos_char, uppercase)
    raw, headers, entry_keys, hdr_offsets, raw_positions = from_raw

    if tableonly:
        # census + .tbl only (compress_seq.cc:690-722 with !normalize);
        # the census is the SAME one the normalize/compress paths use —
        # the reference applies addrc to -T too (compress_seq.cc:566-569)
        with open(base + ".tbl", "wb") as f:
            f.write(_census_table(raw, eos_char, dna_optimized,
                                  add_revcomp_chars))
        # a PRE-EXISTING marker was guarding a crashed FULL build whose
        # partial artifacts (.sqn etc. with fresh mtimes) this -T pass
        # did NOT rebuild — clearing it would make the next load trust
        # them; only remove the marker this run itself created
        if not had_grd:
            os.unlink(base + ".grd")
        return True

    with open(base + ".seq", "wb") as f:
        f.write(raw.tobytes())
    with open(base + ".hdr", "wb") as f:
        for h in headers:
            f.write(h.encode("latin-1") + b"\n")
    total_sentinel = len(raw) + (1 if eos else 0)  # reference's extra seqpos++
    hdr_size = sum(len(h) + 1 for h in headers)
    if binindex:
        keys = np.concatenate([entry_keys, [total_sentinel]])
        vals = np.concatenate([hdr_offsets, [hdr_size]])
        write_idb(base + ".idb", keys, vals)
    else:
        with open(base + ".idx", "w") as f:
            f.write(f"0 0 {1 if init_eos and eos else 0} 0\n")
            for i in range(len(headers)):
                end_key = (
                    entry_keys[i + 1] - 1 if i + 1 < len(headers) else total_sentinel
                )
                f.write(f"{i+1} {hdr_offsets[i] + len(headers[i]) + 1} "
                        f"{end_key} {raw_positions[i]}\n")

    if normalize or compress_bits:
        table = _census_table(raw, eos_char, dna_optimized,
                              add_revcomp_chars)
        c2c = np.full(256, 0, dtype=np.uint8)
        for code, ch in enumerate(table):
            c2c[ch] = code
        codes = c2c[raw]
        if normalize:
            with open(base + ".tbl", "wb") as f:
                f.write(table)
            with open(base + ".sqn", "wb") as f:
                f.write(codes.tobytes())
        if compress_bits:
            with open(base + ".tbz", "wb") as f:
                f.write(table)
            with open(base + ".sqz", "wb") as f:
                f.write(pack_sqz(codes, len(table), eos_code=int(c2c[eos_char])))
        if suffix_tree and normalize:
            # TPU-native persisted index: a suffix ARRAY over the
            # normalized codes (replaces the reference's mmap'd
            # rl_suffix_tree .st, compress_seq.cc:27-40)
            write_suffix_array(base + ".sqn.st", codes)
        if cleanup and (normalize or compress_bits):
            os.unlink(base + ".seq")

    os.unlink(base + ".grd")
    return True


def _read_raw(fasta_path, eos, init_eos, eos_char, uppercase):
    """Replicates compress_seq pass 1: char filter 33..126, uppercase, EOS
    layout, entry keys and header offsets (compress_seq.cc:438-630).
    Uses the native one-sweep packer (native/fasta_pack.cpp) when available;
    the Python loop below is the portable fallback and conformance oracle."""
    from .fasta import native_pass1

    res = native_pass1(
        fasta_path, filter_mode=1, uppercase=uppercase,
        eos_between=eos, eos_start=init_eos, eos_char=eos_char,
    )
    if res is not None:
        raw, starts, _lengths, headers = res
        hdr_offsets = np.zeros(len(headers), dtype=np.int64)
        off = 0
        for i, h in enumerate(headers):
            hdr_offsets[i] = off
            off += len(h) + 1
        return raw, headers, starts, hdr_offsets, [0] * len(headers)

    headers: list[str] = []
    parts: list[np.ndarray] = []
    entry_keys: list[int] = []
    hdr_offsets: list[int] = []
    raw_positions: list[int] = []  # raw-file pos of each entry end (for .idx)
    pos = 0
    hdrpos = 0
    eos_arr = np.array([eos_char], dtype=np.uint8)
    if init_eos and eos:
        parts.append(eos_arr)
        pos += 1
    for header, seq in iter_fasta(fasta_path):
        entry_keys.append(pos)
        hdr_offsets.append(hdrpos)
        headers.append(header)
        hdrpos += len(header) + 1
        arr = np.frombuffer(seq, dtype=np.uint8)
        arr = arr[(arr >= 33) & (arr <= 126)]
        if uppercase:
            low = (arr >= ord("a")) & (arr <= ord("z"))
            arr = np.where(low, arr - 32, arr).astype(np.uint8)
        parts.append(arr)
        pos += len(arr)
        if eos:
            parts.append(eos_arr)
            pos += 1
        raw_positions.append(0)
    raw = (
        np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
    )
    return (
        raw,
        headers,
        np.asarray(entry_keys, dtype=np.int64),
        np.asarray(hdr_offsets, dtype=np.int64),
        raw_positions,
    )


def build_suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of the code space: linear-time native SA-IS
    (native/sais.cpp) when the toolchain is available, NumPy prefix
    doubling (O(n log^2 n), fully vectorized) otherwise.  Both produce the
    identical array (a proper-prefix suffix sorts first)."""
    import ctypes

    n = len(codes)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    from ..native import load_sais_lib

    lib = load_sais_lib()
    if lib is not None:
        codes8 = np.ascontiguousarray(codes, dtype=np.uint8)
        out = np.empty(n, dtype=np.int64)
        rc = lib.sat_suffix_array(
            codes8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return out
    return _build_suffix_array_numpy(codes)


def _build_suffix_array_numpy(codes: np.ndarray) -> np.ndarray:
    """Prefix-doubling fallback (and the fuzz oracle for the native SA-IS)."""
    n = len(codes)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    k = 1
    while k < n:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        new_rank = np.empty(n, dtype=np.int64)
        prev = (rank[order[1:]] != rank[order[:-1]]) | (
            key2[order[1:]] != key2[order[:-1]]
        )
        new_rank[order] = np.concatenate([[0], np.cumsum(prev)])
        rank = new_rank
        sa = order
        if rank[order[-1]] == n - 1:
            break
        k *= 2
    return sa.astype(np.int64)


def write_suffix_array(path: str, codes: np.ndarray) -> None:
    """"SATSA1" magic + int64 n + int64 suffix array of the code space."""
    sa = build_suffix_array(codes)
    with open(path, "wb") as f:
        f.write(b"SATSA1")
        np.asarray([len(codes)], dtype="<i8").tofile(f)
        sa.tofile(f)


def read_suffix_array(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != b"SATSA1":
            raise ValueError("not a SATSA1 suffix array")
        n = int(np.fromfile(f, dtype="<i8", count=1)[0])
        return np.fromfile(f, dtype="<i8", count=n)


# ---------------------------------------------------------------------------
# loading preprocessed databases


def _stream_codes(path: str) -> bool:
    """Memory-map (rather than load) a code file: forced by
    ``SAT_STREAM_DB=1``, disabled by ``SAT_STREAM_DB=0``, else automatic
    past 256 MB — the reference's mmap streaming model (mapFile.h:6-55):
    O(patterns) host memory however big the database is.  Downstream,
    ``ConvScanner.scan`` detects the memmap and streams halo'd blocks
    through the pipelined scan instead of uploading the whole array."""
    spec = os.environ.get("SAT_STREAM_DB", "auto")
    if spec == "1":
        return True
    if spec == "0":
        return False
    return os.path.getsize(path) > (1 << 28)


def load_db(fasta_path: str, eos_char: int = DEFAULT_EOS) -> SeqDB:
    """Load a SeqDB preferring preprocessed artifacts like pick_fasta_file's
    auto mode (.sqn > .sqz > .seq > raw FASTA — select.t:22-188).  A
    persisted suffix tree next to the loaded representation flips the
    engine trigger (select.cc:184-209)."""
    base = fasta_path
    if os.path.exists(base + ".sqn") and os.path.exists(base + ".tbl"):
        table = open(base + ".tbl", "rb").read()
        if _stream_codes(base + ".sqn"):
            codes = np.memmap(base + ".sqn", dtype=np.uint8, mode="r")
        else:
            codes = np.fromfile(base + ".sqn", dtype=np.uint8)
        keys, vals = read_idb(base + ".idb")
        headers = _read_headers(base + ".hdr", vals)
        db = _mk_db(codes, table, keys[:-1], headers, eos_char,
                    producer_alphabet=len(table))
        db.has_suffix_tree = os.path.exists(base + ".sqn.st")
        db.source_kind = "sqn"
        return db
    if os.path.exists(base + ".sqz") and os.path.exists(base + ".tbz"):
        table = open(base + ".tbz", "rb").read()
        keys, vals = read_idb(base + ".idb")
        n = int(keys[-1]) - 1
        codes = unpack_sqz(open(base + ".sqz", "rb").read(), len(table), n)
        headers = _read_headers(base + ".hdr", vals)
        db = _mk_db(codes, table, keys[:-1], headers, eos_char,
                    producer_alphabet=len(table))
        db.source_kind = "sqz"
        return db
    if os.path.exists(base + ".seq") and os.path.exists(base + ".idb"):
        data = open(base + ".seq", "rb").read()
        raw = np.frombuffer(data, dtype=np.uint8)
        keys, vals = read_idb(base + ".idb")
        headers = _read_headers(base + ".hdr", vals)
        table = _census_table(raw)
        c2c = np.zeros(256, dtype=np.uint8)
        for code, ch in enumerate(table):
            c2c[ch] = code
        # bytes.translate is the fast byte-LUT map (~30 ms/16 MB incl.
        # the read); numpy fancy indexing measured 0.12-0.25 s — the
        # dominant term of the whole cold one-shot above-floor cost
        codes = np.frombuffer(data.translate(bytes(c2c)), np.uint8)
        db = _mk_db(codes, table, keys[:-1], headers, eos_char,
                    producer_alphabet=256)
        db.source_kind = "seq"
        return db
    if os.environ.get("SAT_AUTO_ARTIFACTS") == "1":
        # one-shot self-preprocessing: persist the reference-format
        # .seq/.hdr/.idb next to the FASTA on first touch so repeat
        # cold invocations mmap-load instead of re-parsing (the .seq
        # route is output-identical to raw — the -D x -B parity matrix
        # pins it).  Opt-in: writing files is a side effect.
        try:
            compress(fasta_path, eos_char=eos_char)
            return load_db(fasta_path, eos_char=eos_char)
        except OSError:
            pass
    return SeqDB.from_fasta(fasta_path, eos_char=eos_char)


def _read_headers(path: str, offsets: np.ndarray) -> list[str]:
    data = open(path, "rb").read()
    out = []
    offs = list(offsets[:-1]) + [len(data)]
    for i in range(len(offs) - 1):
        out.append(data[offs[i] : offs[i + 1]].rstrip(b"\n").decode("latin-1"))
    return out


def _mk_db(codes, table, entry_keys, headers, eos_char,
           producer_alphabet=256) -> SeqDB:
    starts = np.asarray(entry_keys, dtype=np.int64)
    n = len(codes)
    next_starts = np.concatenate([starts[1:], [n]])
    # entry length: chars between start and next start minus the EOS sentinel
    lengths = next_starts - starts - 1
    if len(lengths):
        eos_code = table.find(bytes([eos_char]))
        trailing_eos = 1 if (eos_code >= 0 and n and codes[-1] == eos_code) else 0
        lengths[-1] = n - starts[-1] - trailing_eos
    return SeqDB(
        codes=codes,
        table=table,
        entry_starts=starts,
        entry_lengths=lengths,
        headers=headers,
        eos_char=eos_char,
        producer_alphabet=producer_alphabet,
    )
