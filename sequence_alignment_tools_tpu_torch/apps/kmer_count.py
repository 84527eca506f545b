"""kmer_count CLI — byte-compatible with the reference k-mer counter
(kmer_count.cc): per-entry top-count tables or an aggregated census, text or
binary output.

Counting is vectorized (rolling base-|Σ| codes + ``np.unique``) instead of
the reference's char-at-a-time staggered mer buffers — same counts, same
output order (count desc, hash desc within ties per entry; hash asc for
``-a``).

Deviation: the reference's ``-r`` (add reverse complement) walks backwards
off its mer buffer (``hashrc`` decrements from ``mer[0]``,
kmer_count.cc:202-212) and aborts on the assert; here ``-r`` implements the
intended reverse-complement census.

The port's copy of ``sequence_alignment_tools_tpu/apps/kmer_count.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import struct
import sys

import numpy as np

from ..io.compress import load_db

MAXINT = (1 << 31) - 1

USAGE = """Usage: kmer_count [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -k <mersize>           Mer size. Default: 1.
  -M <int>               Maximum mers reported per entry.
  -a                     Aggregate counts over all entries.
  -b                     Binary output (with -a).
  -r                     Also count reverse complement mers.
  -n                     Include N as a mer character.
  -N                     Treat all non-ACGT chars as N (implies -n).
  -o <output-file>       Output file. Defaults to standard out.
  -E <int>               End-of-sequence character. Default '\\n'.
  -B / -D (0|1|2|3|4)    I/O and indexing hints.
  -v                     Verbose output.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"database": None, "out": None, "eos_char": ord("\n"),
            "dbind": 0, "verbose": False, "k": 1, "m": MAXINT,
            "aggregate": False, "nmer": False, "nonacgtmer": False,
            "binary": False, "addrc": False}
    try:
        parsed, _ = getopt.getopt(argv, "i:o:E:hBD:wWvk:t:T:M:anNbr")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-k":
            opts["k"] = int(val)
        elif flag == "-M":
            opts["m"] = int(val)
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-r":
            opts["addrc"] = True
        elif flag == "-n":
            opts["nmer"] = True
        elif flag == "-N":
            opts["nonacgtmer"] = True
            opts["nmer"] = True
        elif flag == "-a":
            opts["aggregate"] = True
        elif flag == "-b":
            opts["binary"] = True
        elif flag in ("-B", "-w", "-W", "-t", "-T"):
            pass
        elif flag == "-h":
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["database"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def _mer_hashes(chars: np.ndarray, k: int, charmap: np.ndarray,
                nchar: int) -> np.ndarray:
    """Hashes of every k-window whose chars are all alphabet members."""
    codes = charmap[chars].astype(np.int64)
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.uint64)
    valid = codes >= 0
    h = np.zeros(n - k + 1, dtype=np.int64)
    ok = np.ones(n - k + 1, dtype=bool)
    for j in range(k):
        h = h * nchar + codes[j : j + n - k + 1]
        ok &= valid[j : j + n - k + 1]
    return h[ok].astype(np.uint64)


def _rc_hashes(hashes: np.ndarray, k: int, nchar: int) -> np.ndarray:
    """Reverse-complement hash of each mer hash (ACGT complement; N self)."""
    comp = np.array([3, 2, 1, 0] + ([4] if nchar == 5 else []),
                    dtype=np.uint64)
    h = hashes.copy()
    out = np.zeros_like(hashes)
    for _ in range(k):
        out = out * np.uint64(nchar) + comp[(h % np.uint64(nchar)).astype(int)]
        h //= np.uint64(nchar)
    return out


def _unhash(h: int, k: int, inv: str) -> str:
    out = []
    base = len(inv)
    for _ in range(k):
        out.append(inv[h % base])
        h //= base
    return "".join(reversed(out))


def run(opts, out, binary_out=None) -> None:
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    k = opts["k"]
    nchar = 5 if opts["nmer"] else 4
    inv = "ACGTN"[:nchar]
    charmap = np.full(256, -1, dtype=np.int64)
    for i, c in enumerate(inv):
        charmap[ord(c)] = i
    eos = opts["eos_char"]

    raw = np.frombuffer(db.table, dtype=np.uint8)[db.codes].copy()
    if opts["nonacgtmer"]:
        acgt = np.zeros(256, dtype=bool)
        for c in b"ACGT":
            acgt[c] = True
        acgt[eos] = True
        raw[~acgt[raw]] = ord("N")

    boundaries = np.flatnonzero(raw == eos)
    segments = []
    prev = 0
    for b in boundaries:
        segments.append((prev, int(b)))
        prev = int(b) + 1
    if prev < len(raw):
        segments.append((prev, len(raw)))

    if opts["aggregate"]:
        counts: dict[int, int] = {}
        for s, e in segments:
            hs = _mer_hashes(raw[s:e], k, charmap, nchar)
            if opts["addrc"]:
                hs = np.concatenate([hs, _rc_hashes(hs, k, nchar)])
            uh, uc = np.unique(hs, return_counts=True)
            for hh, cc in zip(uh, uc):
                counts[int(hh)] = counts.get(int(hh), 0) + int(cc)
        for hh in sorted(counts):
            cc = counts[hh]
            if cc > 0:
                if opts["binary"]:
                    (binary_out or sys.stdout.buffer).write(
                        struct.pack("<QI", hh, cc)
                    )
                else:
                    out.write(f"{_unhash(hh, k, inv)} {cc}\n")
    else:
        m = opts["m"]
        for s, e in segments:
            hs = _mer_hashes(raw[s:e], k, charmap, nchar)
            if opts["addrc"]:
                hs = np.concatenate([hs, _rc_hashes(hs, k, nchar)])
            if len(hs) == 0:
                continue
            uh, uc = np.unique(hs, return_counts=True)
            # multimap reverse iteration: count desc, hash desc within ties
            order = np.lexsort((uh, uc))[::-1]
            header = db.get_header_data(e)  # pos of the eos char + 1 - 1
            out.write(f">{header}\n")
            for n_out, oi in enumerate(order):
                if n_out >= m:
                    break
                out.write(f"{_unhash(int(uh[oi]), k, inv)} {int(uc[oi])}\n")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["out"]:
        mode = "wb" if (opts["binary"] and opts["aggregate"]) else "w"
        with open(opts["out"], mode) as f:
            if mode == "wb":
                run(opts, None, binary_out=f)
            else:
                run(opts, f)
    else:
        run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
