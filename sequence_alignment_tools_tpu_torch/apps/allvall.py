"""allvall family on the port's scanners.

Port of ``sequence_alignment_tools_tpu/apps/allvall.py``: all-vs-all
mersize-m near-duplicate search with chunked block decomposition and
run-length bitmap outputs (allvall.cc, allvall_merge.cc, allvall_dump.cc,
allvall_tobm.cc).  Each chunk of 2,048 mers (4,096 patterns under ``-r``)
scans the background through ``ConvScanner.scan`` (k = 0: the census
rung; ``-K``: the pattern-blocked poisoned filter) or
``SellersScanner.scan`` (``-k``: the Sellers kernel); the background is
uploaded once per run, not once per chunk (``conv_scan.device_form``).
The JAX app's ``block=`` and ``use_pallas=`` hints have no counterpart.

The match bitmap marks every db mer (by its end position) that has a <= k
mismatch/edit occurrence in the background database — the scanners do the
all-vs-all block (db-mer chunks as pattern sets over the background),
replacing the reference's seeded perfect-position-hash filtration with a
complete filter (the reference can miss matches its seed templates skip; -t/
-T are accepted and ignored).  Chunk decomposition follows the reference
protocol: a trailing ``.N`` on the background filename plus ``-C chunksize``
offsets its coordinates, and per-chunk bitmaps OR together with
``allvall_merge`` — the file-level map-reduce, the only multi-process
hook in the reference.

Bitmap serialization is byte-compatible (BEGIN/span-pos wrapper, ascii or
7-bit-varint run lengths — bitmap.h:22-75, :273-295)."""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.compress import load_db
from ..io.patterns import PatternSet
from ..ops.conv_scan import ConvScanner
from ..ops.sellers import SellersScanner
from ..ops.tables import build_tables
from ..utils.iupac import reverse_comp

# ---------------------------------------------------------------------------
# bitmap serialization (bitmap.h)


def encode_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 127
        x >>= 7
        if x == 0:
            out.append(b)
            return bytes(out)
        out.append(b | 128)


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    x = 0
    s = 0
    while True:
        b = data[pos]
        pos += 1
        x += (b & 127) << s
        if not (b & 128):
            return x, pos
        s += 7


def bitmap_runs(bits: np.ndarray) -> list[int]:
    """Alternating run lengths starting with a (possibly 0) false-run."""
    n = len(bits)
    if n == 0:
        return []
    change = np.flatnonzero(bits[1:] != bits[:-1]) + 1
    bounds = np.concatenate([[0], change, [n]])
    runs = list(np.diff(bounds).astype(int))
    if bits[0]:
        runs = [0] + runs
    return runs


def write_bitmap_block(f, bits: np.ndarray, ascii_out: bool) -> None:
    """One bare ``bitmap::write`` block (bitmap.h:273-295) — pairscan
    checkpoints put two of these between one BEGIN/END pair."""
    runs = bitmap_runs(bits)
    nset = int(bits.sum())
    nrun = len([r for r in runs if r > 0])
    f.write(b"ASCII RUN LENGTHS START\n" if ascii_out
            else b"BINARY RUN LENGTHS START\n")
    f.write(f"{len(bits)}\n".encode())
    f.write(f"{nset}\n".encode())
    f.write(f"{len(bits) - nset}\n".encode())
    f.write(f"{nrun}\n".encode())
    if ascii_out:
        f.write(f"{len(runs)}\n".encode())
        for r in runs:
            f.write(f"{r}\n".encode())
        f.write(b"ASCII RUN LENGTHS END\n")
    else:
        f.write(encode_varint(len(runs)))
        for r in runs:
            f.write(encode_varint(r))
        f.write(b"BINARY RUN LENGTHS END\n")


def write_bitmap(f, bits: np.ndarray, ascii_out: bool, span: int = 0,
                 pos: int = 0) -> None:
    f.write(b"BEGIN\n")
    f.write(f"{span} {pos}\n".encode())
    write_bitmap_block(f, bits, ascii_out)
    f.write(b"END\n")


def read_bitmap_block(data: bytes, pos: int) -> tuple[np.ndarray, int]:
    """Parse one bare ``bitmap::read`` block starting at byte ``pos``;
    returns (bits, next offset)."""
    marker_end = data.index(b"\n", pos)
    marker = data[pos:marker_end]
    ascii_in = marker == b"ASCII RUN LENGTHS START"
    pos = marker_end + 1

    def ascii_line():
        nonlocal pos
        e = data.index(b"\n", pos)
        v = int(data[pos:e])
        pos = e + 1
        return v

    size = ascii_line()
    _nset = ascii_line()
    _nunset = ascii_line()
    _nrun = ascii_line()
    if ascii_in:
        count = ascii_line()
        runs = [ascii_line() for _ in range(count)]
        end_marker = b"ASCII RUN LENGTHS END\n"
    else:
        count, pos = decode_varint(data, pos)
        runs = []
        for _ in range(count):
            r, pos = decode_varint(data, pos)
            runs.append(r)
        end_marker = b"BINARY RUN LENGTHS END\n"
    if data[pos:pos + len(end_marker)] == end_marker:
        pos += len(end_marker)
    bits = np.zeros(size, dtype=bool)
    at = 0
    val = False
    for r in runs:
        if val:
            bits[at : at + r] = True
        at += r
        val = not val
    return bits, pos


def read_bitmap(path) -> tuple[np.ndarray, int, int]:
    data = open(path, "rb").read() if path != "-" else \
        sys.stdin.buffer.read()
    lines_end = data.index(b"\n")
    assert data[:lines_end] == b"BEGIN"
    pos = lines_end + 1
    hdr_end = data.index(b"\n", pos)
    span_s, pos_s = data[pos:hdr_end].split()
    bits, _pos = read_bitmap_block(data, hdr_end + 1)
    return bits, int(span_s), int(pos_s)


# ---------------------------------------------------------------------------
# allvall core


USAGE = """Usage: allvall [options]

Options:
  -m <int>      Mersize of mers.
  -k <int>      Edit distance.      -K <int>  Hamming distance.
  -r            Consider reverse complement matches too.
  -X            Consider inexact matches only.
  -P            Consider matches at the same sequence position offset.
  -i <db> -b <bg> / -S   Input and background databases.
  -C <int[,int]> Database[,background] chunk sizes.
  -t/-T <tmpl>  Seed templates (accepted; this scan is a complete filter).
  -o <file>     Output bitmap (- = stdout).  -O <file> initial bitmap.
  -A            Ascii bitmap format.
  -e <int>      Exit status 2 if fewer than threshold bits unset.
  -v            Verbose.
  -h            This help.
"""


def allvall_main(argv=None) -> int:
    o = {"database": None, "background": None, "self": False, "mersize": 0,
         "k": 0, "indels": False, "rc": False, "inexonly": False,
         "posmatch": True, "dbchunk": 0, "bgchunk": 0, "out": "",
         "out0": "", "ascii": False, "exitthresh": -1, "verbose": 0}
    try:
        parsed, _ = getopt.getopt(
            sys.argv[1:] if argv is None else argv,
            "i:b:SC:O:o:Ihrvcm:k:K:l:e:Xt:T:HP3:5:M:D:AZ",
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        return 1
    for flag, val in parsed:
        if flag == "-m":
            o["mersize"] = int(val)
        elif flag == "-k":
            o["k"], o["indels"] = int(val), True
        elif flag == "-K":
            o["k"], o["indels"] = int(val), False
        elif flag == "-C":
            if "," in val:
                a, b = val.split(",", 1)
                o["dbchunk"], o["bgchunk"] = int(a), int(b)
            else:
                o["dbchunk"] = o["bgchunk"] = int(val)
        elif flag == "-i":
            o["database"] = val
        elif flag == "-b":
            o["background"] = val
        elif flag == "-S":
            o["self"] = True
        elif flag == "-r":
            o["rc"] = True
        elif flag == "-X":
            o["inexonly"] = True
        elif flag == "-P":
            o["posmatch"] = False
        elif flag == "-o":
            o["out"] = val
        elif flag == "-O":
            o["out0"] = val
        elif flag == "-A":
            o["ascii"] = True
        elif flag == "-e":
            o["exitthresh"] = int(val)
        elif flag == "-v":
            o["verbose"] += 1
        elif flag in ("-t", "-T", "-c", "-I", "-H", "-3", "-5", "-M", "-D",
                      "-Z", "-l"):
            pass
        elif flag == "-h":
            sys.stderr.write(USAGE)
            return 1
    if not o["database"] or (not o["background"] and not o["self"]):
        sys.stderr.write(USAGE)
        return 2
    if o["self"] and not o["background"]:
        o["background"] = o["database"]

    def block_of(path):
        p = path.rfind(".")
        if p < 0:
            return 0
        try:
            return int(path[p + 1 :])
        except ValueError:
            return 0

    dboffset = o["dbchunk"] * block_of(o["database"])
    bgoffset = o["bgchunk"] * block_of(o["background"])
    m = o["mersize"]
    k = o["k"]
    db = load_db(o["database"], eos_char=ord("$"))
    bg = db if o["background"] == o["database"] else \
        load_db(o["background"], eos_char=ord("$"))

    n = len(db.codes)
    bits = np.zeros(n + 1, dtype=bool)
    if o["out0"] or (o["out"] not in ("", "-")):
        import os

        prev = o["out0"] or o["out"]
        if os.path.exists(prev):
            old, _s, _p = read_bitmap(prev)
            bits[: len(old)] |= old[: len(bits)]
    bits[:m] = True
    if o["dbchunk"] > 0:
        bits[o["dbchunk"] + m :] = True

    # db mers: group identical mers, scan the background once per chunk
    raw = np.frombuffer(db.table, dtype=np.uint8)[db.codes]
    acgt = np.zeros(256, dtype=bool)
    for c in b"ACGT":
        acgt[c] = True
    mer_pos: dict[str, list[int]] = {}
    for mp in range(m, n + 1):
        if bits[mp]:
            continue
        window = raw[mp - m : mp]
        if not acgt[window].all():
            bits[mp] = True  # non-ACGT mers are marked invalid
            continue
        mer_pos.setdefault(window.tobytes().decode("latin-1"),
                           []).append(mp)

    mers = list(mer_pos.keys())
    CHUNK = 2048
    for c0 in range(0, len(mers), CHUNK):
        chunk = mers[c0 : c0 + CHUNK]
        pats = list(chunk)
        nf = len(pats)
        if o["rc"]:
            pats = pats + [reverse_comp(p) for p in chunk]
        ps = PatternSet(patterns=[""] + pats, esb=[0] * (len(pats) + 1),
                        eeb=[0] * (len(pats) + 1), n_forward=len(pats))
        tables = build_tables(ps, bg, wc=False, textn=False)
        if k > 0 and o["indels"]:
            scanner = SellersScanner(tables, k=k, indels=True)
        else:
            scanner = ConvScanner(tables, k=k, poison_eos=k > 0)
        matched: dict[int, list[tuple[int, bool]]] = {}
        for end, p0, _d in scanner.scan(bg.codes):
            idx = p0 % nf if p0 >= nf else p0
            matched.setdefault(idx, []).append((end + bgoffset, p0 >= nf))
        for idx, hits in matched.items():
            mer = chunk[idx]
            for mp in mer_pos[mer]:
                if bits[mp]:
                    continue
                mp_global = mp + dboffset
                for e, isrc in hits:
                    if (not isrc and o["posmatch"]
                            and abs(e - mp_global) <= m):
                        continue
                    if o["inexonly"] and not isrc and e == mp_global:
                        continue
                    bits[mp] = True
                    break

    if o["out"]:
        f = sys.stdout.buffer if o["out"] == "-" else open(o["out"], "wb")
        write_bitmap(f, bits, o["ascii"], span=0, pos=len(bg.codes))
        if o["out"] != "-":
            f.close()
    unset = int((~bits).sum())
    if o["exitthresh"] >= 0 and unset < o["exitthresh"]:
        return 2
    return 0


def merge_main(argv=None) -> int:
    """allvall_merge: OR bitmaps together (allvall_merge.cc; bitmap files
    are positional arguments)."""
    args = sys.argv[1:] if argv is None else argv
    try:
        parsed, rest = getopt.getopt(args, "i:o:Ahv")
    except getopt.GetoptError:
        return 1
    ins, out, ascii_out = list(rest), "-", False
    for flag, val in parsed:
        if flag == "-i":
            ins.append(val)
        elif flag == "-o":
            out = val
        elif flag == "-A":
            ascii_out = True
    if not ins:
        return 1
    acc = None
    for path in ins:
        bits, _s, _p = read_bitmap(path)
        acc = bits if acc is None else (acc | bits)
    f = sys.stdout.buffer if out == "-" else open(out, "wb")
    write_bitmap(f, acc, ascii_out)
    if out != "-":
        f.close()
    sys.stderr.write(f"Final unset: {int((~acc).sum())}\n")
    return 0


def dump_main(argv=None) -> int:
    """allvall_dump: print UNSET (unique) runs as annotated FASTA
    (allvall_dump.cc)."""
    args = sys.argv[1:] if argv is None else argv
    try:
        parsed, _ = getopt.getopt(args, "i:d:C:m:hv")
    except getopt.GetoptError:
        return 1
    o = {"database": None, "datfile": None, "chunksize": 0, "mersize": 0}
    for flag, val in parsed:
        if flag == "-i":
            o["database"] = val
        elif flag == "-d":
            o["datfile"] = val
        elif flag == "-C":
            o["chunksize"] = int(val)
        elif flag == "-m":
            o["mersize"] = int(val)
    if not o["database"] or not o["datfile"]:
        return 1
    path = o["database"]
    p = path.rfind(".")
    try:
        dbblock = int(path[p + 1 :]) if p >= 0 else 0
    except ValueError:
        dbblock = 0
    dboffset = o["chunksize"] * dbblock
    db = load_db(path, eos_char=ord("$"))
    bits, _s, _p = read_bitmap(o["datfile"])
    m = o["mersize"]
    # unset runs
    runs = []
    at = 0
    val = False
    for r in bitmap_runs(bits):
        if not val and r > 0:
            runs.append((at, r))
        at += r
        val = not val
    i = 0
    out = sys.stdout
    for pos, length in runs:
        if length == 0:
            continue
        start = pos + dboffset - m
        seq = db.decode(max(start, 0), max(start, 0) + length + m - 1)
        header = db.get_header_data(pos + dboffset)
        st = int(db.get_seq_pos(pos + dboffset)) - m
        ed = st + length + m - 1
        hindex = int(db.entry_of(pos + dboffset)) + 1
        out.write(
            f">{header} /run={dbblock}.{i} /pos={pos + dboffset} "
            f"/index={hindex} /start={st} /end={ed} /len={length + m - 1}\n"
        )
        out.write(seq + "\n")
        i += 1
    return 0


def tobm_main(argv=None) -> int:
    """allvall_tobm: convert an ascii bitmap to binary (allvall_tobm.cc)."""
    args = sys.argv[1:] if argv is None else argv
    try:
        parsed, _ = getopt.getopt(args, "i:o:Ah")
    except getopt.GetoptError:
        return 1
    src, out, ascii_out = None, "-", False
    for flag, val in parsed:
        if flag == "-i":
            src = val
        elif flag == "-o":
            out = val
        elif flag == "-A":
            ascii_out = True
    if not src:
        return 1
    bits, span, pos = read_bitmap(src)
    f = sys.stdout.buffer if out == "-" else open(out, "wb")
    write_bitmap(f, bits, ascii_out, span, pos)
    if out != "-":
        f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(allvall_main())
