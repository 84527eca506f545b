"""kmer_annotate CLI — annotate raw FASTA entries with per-window mer-table
counts (reference ``kmer_annotate.cc:37-293``).

For every k-window of every entry it prints ``fwd_count + rc_count`` where the
counts come from a mer table produced by ``kmer_count -a`` (text ``mer count``
lines, or ``-b`` binary ``u64 hash / u32 count`` records,
``kmer_annotate.cc:225-259``).  Hashes are base-``nchar`` polynomial codes
over A,C,G,T(,N) (``kmer_annotate.cc:118-146``); the reverse-complement hash
reads the window back-to-front through the complement map.

Output per entry: ``defline\\t`` then each window count followed by a space,
then newline (``kmer_annotate.cc:266-287``).  Entries are parsed with the
reference's ``fasta_entry::read`` semantics (``fasta_io.cc:11-56``): ``#`` and
blank lines delimit records, the defline is the header line minus its first
character, and empty-sequence records are skipped.

The port's copy of ``sequence_alignment_tools_tpu/apps/kmer_annotate.py``,
kept byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import getopt
import struct
import sys

import numpy as np

USAGE = """Usage: kmer_annotate [options]

Options:
  -m <mer-table>         Input mer-table. Required.
  -s <seqdb>             Sequence database to annotate. Required.
  -o <output-file>       Output file. Defaults to standard out.
  -k <mer-size>          k-mer size.
  -n                     Include Ns in k-mers.
  -b                     Binary mer-table.
  -v                     Verbose (version & diagnostic) output.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"mertable": None, "seqdb": None, "out": None, "k": 1,
            "nmer": False, "binary": False, "verbose": False}
    try:
        parsed, _ = getopt.getopt(argv, "m:s:o:hvk:nb")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-m":
            opts["mertable"] = val
        elif flag == "-s":
            opts["seqdb"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-k":
            opts["k"] = int(val)
        elif flag == "-n":
            opts["nmer"] = True
        elif flag == "-b":
            opts["binary"] = True
        elif flag == "-v":
            opts["verbose"] = True
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["mertable"] or not opts["seqdb"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def _charmaps(nmer: bool):
    """charmap / rccharmap / base (kmer_annotate.cc:191-223)."""
    charmap = np.full(256, -1, dtype=np.int64)
    rcmap = np.full(256, -1, dtype=np.int64)
    alpha = b"ACGTN" if nmer else b"ACGT"
    comp = b"TGCAN" if nmer else b"TGCA"
    for i, (c, r) in enumerate(zip(alpha, comp)):
        charmap[c] = i
        rcmap[r] = i
    return charmap, rcmap, len(alpha)


def iter_fasta_entries(path: str):
    """(defline, sequence) pairs with fasta_io.cc:11-56 record semantics."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    i, n = 0, len(lines)
    # a trailing "" from split on final newline behaves like a blank line
    while i < n:
        while i < n and (lines[i] == "" or lines[i].startswith("#")):
            i += 1
        if i >= n:
            return
        defline = lines[i][1:]
        i += 1
        seq = []
        while i < n and lines[i] != "" and lines[i][0] not in ">#":
            seq.append(lines[i])
            i += 1
        yield defline, "".join(seq)


def load_mer_table(path: str, k: int, nchar: int, binary: bool,
                   charmap: np.ndarray) -> dict[int, int]:
    counts: dict[int, int] = {}
    if binary:
        rec = struct.Struct("<QI")
        with open(path, "rb") as f:
            data = f.read()
        # records are packed u64+u32 (kmer_annotate.cc:246-257)
        for off in range(0, len(data) - rec.size + 1, rec.size):
            h, c = rec.unpack_from(data, off)
            counts[h] = c
    else:
        with open(path, "r") as f:
            toks = f.read().split()
        for j in range(0, len(toks) - 1, 2):
            mer, c = toks[j], int(toks[j + 1])
            if c > 0:
                h = 0
                for ch in mer[:k].encode("latin-1"):
                    h = h * nchar + int(charmap[ch])
                counts[h] = c
    return counts


def run(opts, out) -> None:
    k = opts["k"]
    charmap, rcmap, nchar = _charmaps(opts["nmer"])
    counts = load_mer_table(opts["mertable"], k, nchar, opts["binary"],
                            charmap)
    keys = np.fromiter(sorted(counts), dtype=np.uint64,
                       count=len(counts))
    vals = np.fromiter((counts[int(h)] for h in keys), dtype=np.int64,
                       count=len(keys))
    powers = (nchar ** np.arange(k - 1, -1, -1)).astype(np.uint64)

    def lookup(h: np.ndarray) -> np.ndarray:
        if len(keys) == 0:
            return np.zeros(len(h), dtype=np.int64)
        idx = np.searchsorted(keys, h)
        idx = np.minimum(idx, len(keys) - 1)
        return np.where(keys[idx] == h, vals[idx], 0)

    for defline, seq in iter_fasta_entries(opts["seqdb"]):
        if seq == "":
            continue
        out.write(defline + "\t")
        chars = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
        if len(chars) >= k:
            win = np.lib.stride_tricks.sliding_window_view(chars, k)
            hf = (charmap[win].astype(np.uint64) * powers).sum(axis=1)
            # hashrc walks the window back-to-front (kmer_annotate.cc:133-146)
            hr = (rcmap[win].astype(np.uint64) * powers[::-1]).sum(axis=1)
            total = lookup(hf) + lookup(hr)
            out.write("".join(f"{int(c)} " for c in total))
        out.write("\n")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["out"]:
        with open(opts["out"], "w") as f:
            run(opts, f)
    else:
        run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
