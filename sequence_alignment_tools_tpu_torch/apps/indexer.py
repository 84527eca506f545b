"""Indexer / IndexerAA CLIs — RL-stack flat sequence + index builders
(reference ``Indexer.cc``, ``IndexerAA.cc``, ``rl_index.cc``).

``Indexer [-v] [-i index] [-f fwd] [-r revc] file.fasta`` scans the
FASTA once (``index_list::iload_fasta``, ``rl_index.cc:10-58``) building
per-entry records in a shared-terminal flat coordinate space: entry i
occupies ``[start, stop]`` with ``'$'`` terminals at both ends and
``stop_i == start_{i+1}`` (``rl_index.h:14-22``).  The index file is
``>defline\\ncstart cstop start stop`` per entry (``index_elt::fprint``);
``cstart`` is the file offset just after the defline newline, ``cstop``
just after the next ``'>'`` (or EOF).  ``-f`` writes the flat forward
file ``$seq$seq$…`` with the canonical DNA map (ACGTU→ACGT upper, other
chars→``N``, ``rl_charmap.h``); ``-r`` writes each entry reversed and
complemented in place.  ``IndexerAA`` maps through the amino-acid table
(stops ``.*@``→``@``, unknown→``X``) or, with ``-U``, plain uppercase
(unknown→``'!'``).

The port's copy of ``sequence_alignment_tools_tpu/apps/indexer.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys

import numpy as np

TERM = ord("$")
TERM2 = ord("%")
# C isspace (default locale) — Python's chr().isspace() also accepts
# unicode spaces like NEL (0x85), which would break byte parity
_SPACE = frozenset(b" \t\n\r\v\f")


def _canonical_map() -> np.ndarray:
    m = np.full(256, ord("N"), dtype=np.uint8)
    m[TERM] = TERM
    m[TERM2] = TERM2
    for a, b in (("a", "A"), ("A", "A"), ("t", "T"), ("T", "T"),
                 ("c", "C"), ("C", "C"), ("g", "G"), ("G", "G"),
                 ("u", "T"), ("U", "T")):
        m[ord(a)] = ord(b)
    return m


def _complement_map() -> np.ndarray:
    m = np.full(256, ord("N"), dtype=np.uint8)
    m[TERM] = TERM
    m[TERM2] = TERM2
    for a, b in (("a", "T"), ("A", "T"), ("t", "A"), ("T", "A"),
                 ("u", "A"), ("U", "A"), ("c", "G"), ("C", "G"),
                 ("g", "C"), ("G", "C")):
        m[ord(a)] = ord(b)
    return m


def _amino_map() -> np.ndarray:
    m = np.full(256, ord("X"), dtype=np.uint8)
    m[TERM] = TERM
    m[TERM2] = TERM2
    for ch in "ACDEFGHIKLMNPQRSTVWY":
        m[ord(ch)] = ord(ch)
        m[ord(ch.lower())] = ord(ch)
    for ch in ".*@":
        m[ord(ch)] = ord("@")
    return m


def _upper_map() -> np.ndarray:
    m = np.full(256, ord("!"), dtype=np.uint8)  # term3
    for i in range(ord("A"), ord("Z") + 1):
        m[i] = i
        m[ord(chr(i).lower())] = i
    return m


def index_fasta(path: str):
    """index_list::iload_fasta (rl_index.cc:10-58): entries of
    (defline, cstart, cstop, start, stop) in the shared-terminal flat
    space, plus the raw bytes for sequence extraction."""
    data = open(path, "rb").read()
    entries = []
    pos = 0  # flat coordinate
    i = 0
    n = len(data)
    cur = None  # [defline, cstart, start]
    count = 0
    while True:
        # scan for next '>' or EOF, counting non-space chars
        nonspace = 0
        while i < n and data[i] != ord(">"):
            if data[i] not in _SPACE:
                nonspace += 1
            i += 1
        pos += nonspace
        if cur is not None:
            cstop = i + 1 if i < n else n
            entries.append((cur[0], cur[1], cstop, cur[2], pos))
        if i >= n:
            break
        count += 1
        i += 1  # past '>'
        eol = data.find(b"\n", i)
        if eol < 0:
            break  # EOF inside defline: entry dropped (rl_index.cc:42)
        defline = data[i:eol].decode("latin-1")
        i = eol + 1
        cur = (defline, i, pos)
        pos += 1  # the leading terminal position
    return entries, data


def _extract(data: bytes, cstart: int, length: int) -> np.ndarray:
    """sequence::sload_fasta: length-1 non-space chars from cstart."""
    out = np.empty(length + 1, dtype=np.uint8)
    out[0] = TERM
    out[length] = TERM
    j = 1
    i = cstart
    while j < length and i < len(data):
        c = data[i]
        i += 1
        if c in _SPACE:
            continue
        if c == ord(">"):
            break
        out[j] = c
        j += 1
    return out


def _main(argv, amino: bool) -> int:
    oname = fname = rname = iname = None
    uc = False
    args = list(argv)
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-") and len(a) > 1:
            j = 1
            while j < len(a):
                ch = a[j]
                if ch == "v":
                    j += 1
                    continue
                if ch == "U" and amino:
                    uc = True
                    j += 1
                    continue
                if ch == "h":
                    sys.stderr.write(_usage(amino))
                    return 0
                if ch in ("i", "f") or (ch == "r" and not amino):
                    val = a[j + 1:] if j + 1 < len(a) else None
                    if val is None:
                        i += 1
                        val = args[i]
                    if ch == "i":
                        oname = val
                    elif ch == "f":
                        fname = val
                    else:
                        rname = val
                    break
                sys.stderr.write(f"unknown flag '-{ch}'\n")
                return 1
        else:
            if iname is None:
                iname = a
            else:
                sys.stderr.write(_usage(amino))
                return 1
        i += 1
    if iname is None:
        sys.stderr.write(_usage(amino))
        return 1

    entries, data = index_fasta(iname)
    out = open(oname, "w") if oname else sys.stdout
    for defline, cstart, cstop, start, stop in entries:
        out.write(f">{defline}\n{cstart} {cstop} {start} {stop}\n")
    if oname:
        out.close()

    if fname or rname:
        if amino:
            fmap = _upper_map() if uc else _amino_map()
        else:
            fmap = _canonical_map()
        cmap = _complement_map()
        total = entries[-1][4] + 1 if entries else 0
        fwd = np.zeros(total, dtype=np.uint8) if fname else None
        rev = np.zeros(total, dtype=np.uint8) if rname else None
        for defline, cstart, cstop, start, stop in entries:
            chars = _extract(data, cstart, stop - start)
            mapped = chars.copy()
            mapped[1:-1] = fmap[chars[1:-1]]
            if fwd is not None:
                fwd[start:stop + 1] = mapped
            if rev is not None:
                rc = chars.copy()
                rc[1:-1] = cmap[chars[1:-1]][::-1]
                rev[start:stop + 1] = rc
        if fname:
            fwd.tofile(fname)
        if rname:
            rev.tofile(rname)
    return 0


def _usage(amino: bool) -> str:
    if amino:
        return ("IndexerAA: [-v] [-U] [-i index file] [-f seq file] "
                "file.fasta\n\t-U assume unrestricted (any letter) amino "
                "acid files\n")
    return ("Indexer: [-v] [-i index file] [-f fwd file] [-r revc file] "
            "file.fasta\n")


def main(argv=None) -> int:
    return _main(sys.argv[1:] if argv is None else argv, amino=False)


def main_aa(argv=None) -> int:
    return _main(sys.argv[1:] if argv is None else argv, amino=True)


if __name__ == "__main__":
    raise SystemExit(main())
