"""WordGraph CLI — build a word-graph edge list from an Xspace/XspaceLo
x-space file + Indexer forward flat file (reference ``WordGraph.cc``).

Each x-space line becomes a *node*; each ``pos.ch`` item a *space*.
Line 0's last item supplies the terminal char.  Nodes take their mer
text from the forward file at their minimal space position (``getseq``,
``WordGraph.cc:258-268``; position 1 wraps to the end of the file) and
are collapsed to shared labels by mer equality under the AA code map
('A'-'Z' → 1..26, '$' → 27 — so '$' sorts AFTER the letters,
``WordGraph.cc:271-300``; the ``-A`` map is the effective default).
Spaces sort by (pos, line id, ch); only the first space at each
position survives; consecutive surviving spaces form edges unless a
terminal-containing mer gates them out (both ends must be clean by
default, one clean end suffices with ``-e``).  Edges sort with
std::sort under (label_i, label_j, ch_i) — tie order inside runs is the
introsort's, replicated via :mod:`..utils.introsort` — and print as
``e``-runs closed by an ``E`` line carrying the multiplicity, then a
``.`` terminator (``WordGraph.cc:604-641``).

Quirks: the reference unmaps the forward file after the first graph and
never clears its global vectors, so only single-graph inputs (Xspace
``-a`` / XspaceLo outputs) work; an empty edge set reads one element
out of bounds — both avoided here by construction (multi-graph inputs
process the first graph only; empty edge sets print just ``.``).

The port's copy of ``sequence_alignment_tools_tpu/apps/wordgraph_build.py``,
kept byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.introsort import introsort


def _aa_code(ch: int) -> int:
    """node::map AA code TRUNCATED to the 3-bit nodechca_t field
    (WordGraph.cc:245 ``largeword<unsigned char,100,3>``): 'I'≡'A',
    '$'(27)≡'C'(3), 'T'(20)≡4, etc.  Collapse, comparison order, and
    the (consequently dead) terminal gate all see these codes."""
    if ord("A") <= ch <= ord("Z"):
        return (ch - ord("A") + 1) & 7
    return 27 & 7  # '$'


def wordgraph_main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    opts = {"m": 0, "o": None, "f": None, "x": None,
            "keep_eos": False, "distinguish_eos": False}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-") and len(a) > 1:
            ch = a[1]
            if ch in "vAeEh":
                for fl in a[1:]:
                    if fl == "e":
                        opts["keep_eos"] = True
                    elif fl == "E":
                        opts["distinguish_eos"] = True
            elif ch in "mofx":
                val = a[2:] or args[i + 1]
                if not a[2:]:
                    i += 1
                opts[ch] = int(val) if ch == "m" else val
        i += 1
    if not opts["x"] or not opts["f"] or not opts["m"]:
        sys.stderr.write(
            "WordGraph: [-v] [-h] [-A] [-e] [-E] -x xspace_file "
            "-m mer_size -f fwd_file [ -o output ]\n")
        return 1

    m = opts["m"]
    fwd = np.fromfile(opts["f"], dtype=np.uint8)
    slen = len(fwd)

    # parse the first graph of the x-space file
    term = None
    nodes_spaces: list[list[tuple[int, str]]] = []  # per line
    spaces: list[tuple[int, int, str]] = []  # (pos, nodeidx, ch)
    with open(opts["x"], "r") as f:
        lid = 0
        for line in f:
            line = line.rstrip("\n")
            items = []
            rest = line
            while rest.startswith(" "):
                tok, _, rest2 = rest[1:].partition(" ")
                # items are "pos.ch"
                dot = tok.rindex(".")
                items.append((int(tok[:dot]), tok[dot + 1:] or " "))
                rest = " " + rest2 if rest2 else ""
            if not items:
                break
            if lid == 0:
                term = items[-1][1]
            else:
                for pos, ch in items:
                    spaces.append((pos, lid - 1, ch))
                nodes_spaces.append(items)
            lid += 1
    if term is None or not spaces:
        out = open(opts["o"], "w") if opts["o"] else sys.stdout
        if spaces:
            out.write(".\n")
        if opts["o"]:
            out.close()
        return 0

    # sort spaces by (pos, initial label = line id, ch)
    spaces.sort(key=lambda s: (s[0], s[1], s[2]))

    # node mers from the first (sorted-order) space position
    nnodes = len(nodes_spaces)
    mer: list[tuple | None] = [None] * nnodes
    for pos, nd, _ch in spaces:
        if mer[nd] is None:
            p = slen if pos == 1 else pos
            mer[nd] = tuple(_aa_code(int(c)) for c in fwd[p - m:p])
    for nd in range(nnodes):
        if mer[nd] is None:
            mer[nd] = ()

    # collapse equal mers to shared labels (stable sort order)
    order = sorted(range(nnodes), key=lambda i: mer[i])
    label = [0] * nnodes
    nxt = 1
    prev = None
    for idx in order:
        if prev is not None and mer[idx] == mer[prev]:
            label[idx] = label[prev]
        else:
            label[idx] = nxt
            nxt += 1
        prev = idx

    # contains_term maps the 3-bit codes back through map(v<=26)->letter,
    # so it can never produce '$' — the eos gate is dead code in the
    # reference's (always-on) AA mode
    has_term = [False] * nnodes

    # edges between consecutive distinct-position surviving spaces
    edges: list[tuple[int, int]] = []  # indices into spaces
    j = 0
    for i in range(1, len(spaces)):
        if spaces[j][0] == spaces[i][0]:
            continue
        ni, nj = spaces[i][1], spaces[j][1]
        if not opts["keep_eos"]:
            if not has_term[nj] and not has_term[ni]:
                edges.append((j, i))
        else:
            if not has_term[nj] or not has_term[ni]:
                edges.append((j, i))
        j = i

    def keyof(e):
        return (label[spaces[e[0]][1]], label[spaces[e[1]][1]],
                spaces[e[0]][2])

    introsort(edges, lambda a, b: keyof(a) < keyof(b))

    out = open(opts["o"], "w") if opts["o"] else sys.stdout
    same = 0
    for i in range(1, len(edges)):
        a, b = edges[i - 1], edges[i]
        if keyof(a) == keyof(b) and (not opts["distinguish_eos"]
                                     or spaces[a[0]][2] != term):
            out.write(f"e\t{label[spaces[a[0]][1]]}\t{label[spaces[a[1]][1]]}"
                      f"\t{spaces[a[0]][0]}\t{spaces[a[1]][0]}\n")
            same += 1
        else:
            out.write(f"E\t{label[spaces[a[0]][1]]}\t{label[spaces[a[1]][1]]}"
                      f"\t{spaces[a[0]][0]}\t{spaces[a[1]][0]}\t{same + 1}\n")
            same = 0
    if edges:
        a = edges[-1]
        out.write(f"E\t{label[spaces[a[0]][1]]}\t{label[spaces[a[1]][1]]}"
                  f"\t{spaces[a[0]][0]}\t{spaces[a[1]][0]}\t{same + 1}\n")
    out.write(".\n")
    if opts["o"]:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(wordgraph_main())
