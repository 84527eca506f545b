"""word-graph CLIs: word_graph_build (the WordGraph.cc builder),
walk_graph (Eulerian walk -> compressed sequence, walk_graph.cc),
cannon_csbh_graph (trivial-path compression / canonicalization,
cannon_csbh_graph.cc) and csbh_annotate (per-node count annotation,
csbh_annotate.cc).

The reference's graph programs have bit-rotted against their own word_graph
API and require the unvendored CS2 library; this subsystem rebuilds the
documented pipeline — build k-mer graph -> balance (min-cost flow for -O) ->
Eulerian walk — on models/word_graph + ops/netflo.

The port's copy of ``sequence_alignment_tools_tpu/apps/walk_graph.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..models.word_graph import WordGraph

BUILD_USAGE = """Usage: word_graph_build -i <fasta> -k <mersize> -g <graph-out> [-s <seq-out>]
Builds the k-mer adjacency word graph of the sequence database.
"""

WALK_USAGE = """Usage: walk_graph [options]

Options:
  -g <graph-file> Word graph file. Required.
  -s <seq-file>   Word graph sequence file (flat chars). Required.
  -k <mer-size>   Mersize of word graph. Default: 30.
  -E <int>        End-of-sequence character. Default: '$'.
  -o <out-file>   Output file. Default is standard out.
  -R              Permit redundant k-mers to be output.
  -N              Permit new k-mers to be output.
  -O              Find optimal redundant or new compression.
  -v              Verbose.
  -h              Help.
"""


def build_main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    try:
        parsed, _ = getopt.getopt(args, "i:k:g:s:hv")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + BUILD_USAGE)
        return 1
    o = {"db": None, "k": 30, "graph": None, "seq": None}
    for flag, val in parsed:
        if flag == "-i":
            o["db"] = val
        elif flag == "-k":
            o["k"] = int(val)
        elif flag == "-g":
            o["graph"] = val
        elif flag == "-s":
            o["seq"] = val
        else:
            sys.stderr.write(BUILD_USAGE)
            return 1
    if not o["db"] or not o["graph"]:
        sys.stderr.write(BUILD_USAGE)
        return 1
    db = load_db(o["db"], eos_char=ord("$"))
    g = WordGraph.build(db.codes, o["k"], db.eos_code, db.alphabet_size)
    with open(o["graph"], "w") as f:
        g.write(f)
    if o["seq"]:
        with open(o["seq"], "w") as f:
            f.write(db.decode(0, len(db.codes)))
    return 0


def walk_main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    try:
        parsed, _ = getopt.getopt(args, "g:s:k:eE:o:RNOvh")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + WALK_USAGE)
        return 1
    o = {"graph": None, "seq": None, "k": 30, "eos": ord("$"),
         "out": None, "redundant": False, "allownew": False,
         "optimize": False, "verbose": False}
    for flag, val in parsed:
        if flag == "-g":
            o["graph"] = val
        elif flag == "-s":
            o["seq"] = val
        elif flag == "-k":
            o["k"] = int(val)
        elif flag == "-E":
            o["eos"] = int(val, 0)
        elif flag == "-o":
            o["out"] = val
        elif flag == "-R":
            o["redundant"] = True
        elif flag == "-N":
            o["allownew"] = True
        elif flag == "-O":
            o["optimize"] = True
        elif flag in ("-e", "-v"):
            pass
        else:
            sys.stderr.write(WALK_USAGE)
            return 1
    if not o["graph"] or not o["seq"]:
        sys.stderr.write(WALK_USAGE)
        return 1
    g = WordGraph.read(o["graph"], mersize=o["k"])
    seq = open(o["seq"]).read()

    def decode(a, b):
        return seq[max(a, 0) : b]

    if o["verbose"]:
        sys.stderr.write(f"stats: {g.stats()}\n")
    g.balance(mode="redundant" if o["redundant"] else "new",
              optimize=o["optimize"])
    text = g.walk_seq(decode, eos=chr(o["eos"]))
    out = open(o["out"], "w") if o["out"] else sys.stdout
    out.write(text)
    if not text.endswith("\n"):
        out.write("\n")
    if o["out"]:
        out.close()
    return 0


def cannon_main(argv=None) -> int:
    """cannon_csbh_graph: canonicalize — compress trivial paths and rewrite
    the graph (variable-length node format)."""
    args = sys.argv[1:] if argv is None else argv
    try:
        parsed, _ = getopt.getopt(args, "g:k:o:hv")
    except getopt.GetoptError:
        return 1
    o = {"graph": None, "k": 0, "out": None}
    for flag, val in parsed:
        if flag == "-g":
            o["graph"] = val
        elif flag == "-k":
            o["k"] = int(val)
        elif flag == "-o":
            o["out"] = val
    if not o["graph"]:
        return 1
    g = WordGraph.read(o["graph"], mersize=o["k"])
    while g.compress_trivial_paths():
        pass
    out = open(o["out"], "w") if o["out"] else sys.stdout
    gv = WordGraph(mersize=0, nodes=g.nodes, edges=g.edges,
                   out_adj=g.out_adj, in_deg=g.in_deg, out_deg=g.out_deg)
    gv.write(out)
    if o["out"]:
        out.close()
    return 0


def annotate_main(argv=None) -> int:
    """csbh_annotate: per-position edge-count annotation (UCSC WIG-style
    output, csbh_annotate.cc)."""
    args = sys.argv[1:] if argv is None else argv
    try:
        parsed, _ = getopt.getopt(args, "g:k:o:n:hv")
    except getopt.GetoptError:
        return 1
    o = {"graph": None, "k": 0, "out": None, "name": "csbh"}
    for flag, val in parsed:
        if flag == "-g":
            o["graph"] = val
        elif flag == "-k":
            o["k"] = int(val)
        elif flag == "-o":
            o["out"] = val
        elif flag == "-n":
            o["name"] = val
    if not o["graph"]:
        return 1
    g = WordGraph.read(o["graph"], mersize=o["k"])
    out = open(o["out"], "w") if o["out"] else sys.stdout
    out.write(f'track type=wiggle_0 name="{o["name"]}"\n')
    for e in sorted(g.edges, key=lambda e: e.seq_end):
        if e.real:
            out.write(f"{e.seq_end - e.length}\t{e.seq_end}\t{e.count}\n")
    if o["out"]:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(walk_main())
