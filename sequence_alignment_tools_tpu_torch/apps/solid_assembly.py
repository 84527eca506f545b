"""solid_assembly CLI — word-graph read-guided assembly (reference
``solid_assembly.cc``).

Reads a word graph (``-g``) and the read FASTA it was built from
(``-i``), repeatedly peels widget edges guided by threading the reads
through the graph (``word_graph::peel_edges``), then writes the trivial
paths as the assembled sequence (``word_graph::writetrivialpaths``).

The graph file may be either the numeric edge-list format
(``from to fseqend tseqend count``, what ``word_graph::read`` parses)
or the ``E``/``e`` tab format that the WordGraph builder actually
emits — the reference feeds the latter to a parser expecting the
former and dies; both are accepted here (``e`` continuation lines fold
into their closing ``E`` line's multiplicity).

The port's copy of ``sequence_alignment_tools_tpu/apps/solid_assembly.py``,
kept byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import getopt
import sys

from ..io.database import SeqDB
from ..models.word_graph import Edge, WordGraph

USAGE = """Usage: solid_assembly [options]

Options:
  -g <graph-file> Word graph file. Required.
  -i <fasta-file> Fasta file. Required.
  -k <int>        Length of node sequence, if fixed
  -c <int>        Widget removal cycles
  -E <int>        End-of-sequence character. Default: '$'
  -o <out-file>   Sequence output file. Default: Output to stdout.
  -v              Verbose.
  -h              Help.
"""


def parse_args(argv):
    opts = {"graph": "", "fasta": "", "eos": ord("$"), "out": None,
            "verbose": False, "mersize": -1, "iterations": 10000}
    try:
        parsed, _ = getopt.getopt(argv, "g:i:E:o:k:c:vh")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-g":
            opts["graph"] = val
        elif flag == "-i":
            opts["fasta"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-E":
            opts["eos"] = int(val, 0)
        elif flag == "-k":
            opts["mersize"] = int(val)
        elif flag == "-c":
            opts["iterations"] = int(val)
        elif flag == "-v":
            opts["verbose"] = True
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["graph"] or not opts["fasta"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def read_graph(path: str, mersize: int) -> WordGraph:
    with open(path) as f:
        first = f.readline()
    if first[:1] in ("E", "e"):
        g = WordGraph(mersize=max(mersize, 0))
        for line in open(path):
            if not line.startswith("E"):
                continue  # 'e' lines are counted by their closing 'E'
            parts = line.split()
            frm, to, pi, pj, count = (int(x) for x in parts[1:6])
            g.add_node(frm, pi)
            g.add_node(to, pj)
            g.add_edge(Edge(frm=frm, to=to, seq_end=pj,
                            length=max(pj - pi, 1), count=count))
        return g
    return WordGraph.read(path, mersize=max(mersize, 0))


def run(opts, out) -> None:
    g = read_graph(opts["graph"], opts["mersize"])
    db = SeqDB.from_fasta(opts["fasta"], eos_char=opts["eos"])
    if opts["verbose"]:
        sys.stderr.write(f"graph: {g.stats()}\n")
    k = opts["mersize"] if opts["mersize"] > 0 else g.mersize
    for _ in range(opts["iterations"]):
        if not g.peel_edges(db, k):
            break
    g.mersize = k
    g.writetrivialpaths(out, db.decode, eos=chr(opts["eos"]))


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
