"""Xspace / XspaceLo CLIs (reference ``Xspace.cc``, ``XspaceLo.cc``).

Both consume Indexer outputs (``-i`` index + ``-f`` forward flat file,
XspaceLo optionally ``-r`` the revcomp flat file) and print
context-branching mer classes — see :mod:`..models.xspace` for the
algorithm, ordering rules, and quirk notes.

The port's copy of ``sequence_alignment_tools_tpu/apps/xspace.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys

import numpy as np

from ..models.xspace import TERM, TERM2, XspaceAnalysis


def _load_index(path: str) -> list[tuple[int, int]]:
    """index_list::iload (rl_index.cc:68-101): (start, stop) pairs."""
    out = []
    with open(path, "r") as f:
        lines = f.read().split("\n")
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(">"):
            i += 1
            nums = lines[i].split()
            out.append((int(nums[2]), int(nums[3])))
        i += 1
    return out


def _maps(amino: bool, uc: bool, lo: bool):
    """MAP (Xspace.cc:189-209) / MAP1+MAP2 (XspaceLo.cc:204-240)."""
    m1 = np.full(256, 0, dtype=np.uint8)
    if amino:
        base = np.full(256, ord("X"), dtype=np.uint8)
        for ch in "ACDEFGHIKLMNPQRSTVWY":
            base[ord(ch)] = base[ord(ch.lower())] = ord(ch)
        for ch in ".*@":
            base[ord(ch)] = ord("@")
        base[TERM], base[TERM2] = TERM, TERM2
        bad = ord("X")
    elif uc:
        base = np.full(256, ord("!"), dtype=np.uint8)
        for i in range(ord("A"), ord("Z") + 1):
            base[i] = base[ord(chr(i).lower())] = i
        bad = ord("!")
    else:
        base = np.full(256, ord("N"), dtype=np.uint8)
        for a, b in (("a", "A"), ("t", "T"), ("c", "C"), ("g", "G"),
                     ("u", "T")):
            base[ord(a)] = base[ord(a.upper())] = ord(b)
        base[TERM], base[TERM2] = TERM, TERM2
        bad = ord("N")
    m1[:] = base
    m1[m1 == bad] = TERM
    if lo:
        m1[TERM] = TERM
        m1[TERM2] = TERM
        m2 = base.copy()
        m2[m2 == bad] = TERM2
        m2[TERM] = TERM2
        m2[TERM2] = TERM2
        return m1, m2
    return m1, None


def xspace_main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    opts = {"m": 10, "a": False, "A": False, "U": False,
            "o": None, "i": None, "f": None}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-") and len(a) > 1:
            ch = a[1]
            if ch in "vaAUh":
                for fl in a[1:]:
                    if fl in "aAU":
                        opts[fl] = True
            elif ch in "moif":
                val = a[2:] or args[i + 1]
                if not a[2:]:
                    i += 1
                opts[ch] = int(val) if ch == "m" else val
        i += 1
    if not opts["i"] or not opts["f"]:
        sys.stderr.write(
            "Xspace: [-v] [-h] [-m mer_size] [-a] [-A] [-U] -o output "
            "-i index_file -f fwd_file\n")
        return 1
    entries = _load_index(opts["i"])
    fwd = np.fromfile(opts["f"], dtype=np.uint8)
    m1, _ = _maps(opts["A"], opts["U"], lo=False)
    out = open(opts["o"], "w") if opts["o"] else sys.stdout
    mer = opts["m"]

    if opts["a"]:
        slen = 1 + sum(stop - start for start, stop in entries)
        S = m1[fwd[:slen]]
        out.write(f" 0.{chr(S[0])}\n")
        out.write(f" 1.{chr(S[1])} {slen}.{chr(S[1])}\n")
        pos = 1
        for start, stop in entries:
            pos += stop - start
            if pos < slen:
                out.write(f" {pos}.{chr(S[pos])}\n")
        an = XspaceAnalysis(S, mer)
        an.selfstream()
        an.emit(out)
        out.write("\n")
    else:
        for start, stop in entries:
            slen = 1 + stop - start
            S = m1[fwd[start:start + slen]]
            out.write(f" 0.{chr(S[0])}\n")
            out.write(f" 1.{chr(S[1])} {slen}.{chr(S[1])}\n")
            an = XspaceAnalysis(S, mer)
            an.selfstream()
            an.emit(out)
            out.write("\n")
    if opts["o"]:
        out.close()
    return 0


def xspacelo_main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    opts = {"k": 0, "A": False, "U": False, "p": False, "M": 4000,
            "o": None, "i": None, "f": None, "r": None}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-") and len(a) > 1:
            ch = a[1]
            if ch in "vpAUh":
                for fl in a[1:]:
                    if fl in "pAU":
                        opts[fl] = True
            elif ch in "kMoifr":
                val = a[2:] or args[i + 1]
                if not a[2:]:
                    i += 1
                opts[ch] = int(val) if ch in "kM" else val
        i += 1
    if not opts["i"] or not opts["f"] or not opts["o"] or not opts["k"]:
        sys.stderr.write(
            "XspaceLo: [-v] [-h] [-p] [-A|-U] [-M MB limit] -k mersize "
            "-o output -i index_file -f fwd_file [ -r revc_file ]\n")
        return 1
    entries = _load_index(opts["i"])
    fwd = np.fromfile(opts["f"], dtype=np.uint8)
    rev = np.fromfile(opts["r"], dtype=np.uint8) if opts["r"] else None
    m1, m2 = _maps(opts["A"], opts["U"], lo=True)
    mer = opts["k"]

    # plan: blocks of consecutive entries under the MB limit
    # (XspaceLo.cc form_Plan; Bytes(e) = 1 + 23*(len+1) tree estimate,
    # XspaceLo.cc:100-103)
    limit = min(opts["M"], 23 << 10) << 20
    blocks: list[list[tuple[int, int]]] = []
    cur: list[tuple[int, int]] = []
    cur_b = 0
    for start, stop in entries:
        b = 1 + (stop - start + 1) * 23
        if b + cur_b < limit:
            cur.append((start, stop))
            cur_b += b
        else:
            if not cur:
                sys.stderr.write("XspaceLo: unable to form a decent plan\n")
                return 106
            blocks.append(cur)
            cur = [(start, stop)]
            cur_b = b
    if cur:
        blocks.append(cur)
    if opts["p"]:
        return 0

    out = open(opts["o"], "w")
    slen_all = 1 + sum(stop - start for start, stop in entries)
    maxlen = max((stop - start for start, stop in entries), default=0)

    # per-entry preamble with the reference's reused maxlen+1 buffer
    buf = np.zeros(maxlen + 1, dtype=np.uint8)
    pos = 1
    for start, stop in entries:
        n = stop - start + 1
        buf[:n] = fwd[start:start + n]
        buf[:maxlen] = m1[buf[:maxlen]]
        if pos == 1:
            out.write(f" 0.{chr(buf[0])} {slen_all - 1}.{chr(buf[0])}\n")
            out.write(f" 1.{chr(buf[1])} {slen_all}.{chr(buf[1])}\n")
            out.write(f" {mer}.{chr(buf[mer])}\n")
            out.write(f" {mer + 1}.{chr(buf[mer + 1])}\n")
        else:
            out.write(f" {pos - 1}.{chr(buf[0])}\n")
            out.write(f" {pos}.{chr(buf[1])}\n")
            out.write(f" {pos + mer - 1}.{chr(buf[mer])}\n")
            out.write(f" {pos + mer}.{chr(buf[mer + 1])}\n")
        pos += stop - start

    for bi, block in enumerate(blocks):
        b0 = block[0][0]
        slen = 1 + sum(stop - start for start, stop in block)
        S = m1[fwd[b0:b0 + slen]]
        an = XspaceAnalysis(S, mer)
        an.selfstream()
        for bj, other in enumerate(blocks):
            for start, stop in other:
                if rev is not None:
                    an.stream(m2[rev[start:stop + 1]])
                if bj != bi:
                    an.stream(m2[fwd[start:stop + 1]])
        an.emit(out, offset=b0)
    out.write("\n")
    out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(xspace_main())
