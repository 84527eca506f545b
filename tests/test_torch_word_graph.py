"""The port's word-graph stack against the JAX package's: the min-cost
flow (``ops/netflo.py``), the graph model (``models/word_graph.py``), the
WordGraph builder (``apps/wordgraph_build.py``), the four walk_graph
entry points (build_graph, walk_graph with ``-R`` / ``-N`` / ``-O``,
cannon_csbh_graph, csbh_annotate) and solid_assembly.

netflo: the brute-force cases of ``tests/test_netflo.py``, each solver's
cost equal to the exhaustive optimum and the two solvers' flows equal.
The model: the whole graph state (nodes, edges, degrees, adjacency)
after build, balance (both modes, greedy and optimal), trivial-path
compression and read-guided peeling, and the walk.  The CLIs: stdout,
exit status and every written file, on one synthesized read set (a
genome with a repeat, after ``tests/test_word_graph.py``); the port's
walk_graph, cannon_csbh_graph, csbh_annotate and solid_assembly read the
graph the JAX package's build_graph wrote, and its WordGraph reads the
JAX package's Indexer / Xspace files.
"""

import dataclasses
import itertools
import random

import numpy as np
import pytest

from sequence_alignment_tools_tpu.io.database import SeqDB as JaxSeqDB
from sequence_alignment_tools_tpu.models.word_graph import (
    WordGraph as JaxGraph,
)
from sequence_alignment_tools_tpu.ops.netflo import (
    min_cost_flow as jax_flow,
)
from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.models.word_graph import WordGraph
from sequence_alignment_tools_tpu_torch.ops.netflo import min_cost_flow
from test_torch_seq_tools import entry, run_both


def brute_min_cost(n, arcs, src, snk, want):
    """Exhaustive optimum over every integer flow within capacities
    (``tests/test_netflo.py``); None if infeasible."""
    best = None
    for assign in itertools.product(*[range(c + 1)
                                      for (_u, _v, c, _w, _t) in arcs]):
        net = [0] * n
        cost = 0
        for f, (u, v, _c, w, _t) in zip(assign, arcs):
            net[u] -= f
            net[v] += f
            cost += f * w
        ok = net[snk] == want and net[src] == -want and all(
            net[x] == 0 for x in range(n) if x not in (src, snk))
        if ok and (best is None or cost < best):
            best = cost
    return best


def solve(solver, n, arcs, src, snk, want):
    try:
        flows = solver(n, arcs, src, snk, want)
    except ValueError:
        return None, None
    return flows, sum(f * w for f, (_u, _v, _c, w, _t) in zip(flows, arcs))


@pytest.mark.parametrize("seed", range(30))
def test_min_cost_flow_vs_bruteforce(seed):
    rng = random.Random(seed)
    n = rng.randint(3, 5)
    src, snk = 0, n - 1
    arcs = []
    for i in range(rng.randint(3, 7)):
        u = rng.randrange(n)
        v = rng.randrange(n)
        while v == u:
            v = rng.randrange(n)
        arcs.append((u, v, rng.randint(0, 3), rng.randint(0, 9), i))
    want = rng.randint(1, 3)
    flows, cost = solve(min_cost_flow, n, arcs, src, snk, want)
    assert (flows, cost) == solve(jax_flow, n, arcs, src, snk, want)
    assert cost == brute_min_cost(n, arcs, src, snk, want)


def test_min_cost_flow_optimality_and_infeasible():
    arcs = [(0, 1, 5, 2, None), (0, 1, 5, 5, None), (1, 2, 10, 0, None)]
    assert min_cost_flow(3, arcs, 0, 2, 7) == jax_flow(3, arcs, 0, 2, 7) \
        == [5, 2, 7]
    for solver in (min_cost_flow, jax_flow):
        with pytest.raises(ValueError):
            solver(3, arcs, 0, 2, 100)
        with pytest.raises(ValueError):
            solver(3, [(0, 1, 1, 5, 0), (1, 2, 3, 1, 1)], 0, 2, 2)


def edge_rows(edges):
    return [dataclasses.astuple(e) for e in edges]


def state(g):
    return (g.mersize, dict(g.nodes), edge_rows(g.edges), dict(g.in_deg),
            dict(g.out_deg), {n: edge_rows(a) for n, a in g.out_adj.items()})


def codes_of(s, alpha="ACGT$"):
    return np.array([alpha.index(c) for c in s], dtype=np.uint8)


def genome(seed, n, dup):
    rng = random.Random(seed)
    s = "".join(rng.choice("ACGT") for _ in range(n))
    return s[:200] + s[dup[0]:dup[1]] + s[200:]


@pytest.mark.parametrize("mode,optimize,k", [("new", False, 4),
                                             ("new", False, 8),
                                             ("redundant", False, 6),
                                             ("redundant", True, 6),
                                             ("new", True, 5)])
def test_word_graph_model_parity(mode, optimize, k):
    s = genome(3 + k, 800, (50, 90)) + genome(9, 300, (100, 160))
    flat = "$" + s + "$"
    codes = codes_of(flat)

    def decode(a, b):
        return flat[max(a, 0):b]

    want = JaxGraph.build(codes, k, eos_code=4, alpha=5)
    got = WordGraph.build(codes, k, eos_code=4, alpha=5)
    assert state(got) == state(want) and len(want.edges) > 500
    assert got.stats() == want.stats()
    added = got.balance(mode=mode, optimize=optimize)
    assert added == want.balance(mode=mode, optimize=optimize) and added > 0
    assert state(got) == state(want)
    assert got.walk_seq(decode, eos="$") == want.walk_seq(decode, eos="$")
    while True:
        n = got.compress_trivial_paths()
        assert n == want.compress_trivial_paths()
        if not n:
            break
    assert state(got) == state(want)


def test_word_graph_peel_and_write(tmp_path):
    """Read-guided widget peeling and writetrivialpaths, and the graph
    file of each model read back by the other."""
    rng = random.Random(7)
    A, R, B, C = ("".join(rng.choice("ACGT") for _ in range(n))
                  for n in (60, 20, 60, 60))
    g_seq = A + R + B + R + C
    fa = tmp_path / "reads.fasta"
    fa.write_text("".join(f">w{i}\n{g_seq[i:i + 50]}\n"
                          for i in range(0, len(g_seq) - 49, 10)))
    dbs = (JaxSeqDB.from_fasta(str(fa), eos_char=ord("$")),
           SeqDB.from_fasta(str(fa), eos_char=ord("$")))
    graphs = [cls.build(db.codes, 8, db.eos_code, db.alphabet_size)
              for cls, db in zip((JaxGraph, WordGraph), dbs)]
    paths = []
    for g, name in zip(graphs, ("jax.wg", "torch.wg")):
        with open(tmp_path / name, "w") as f:
            g.write(f)
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert state(WordGraph.read(str(paths[0]), mersize=8)) == \
        state(JaxGraph.read(str(paths[1]), mersize=8))
    for _ in range(20):
        n = graphs[1].peel_edges(dbs[1], 8)
        assert n == graphs[0].peel_edges(dbs[0], 8)
        assert state(graphs[1]) == state(graphs[0])
        if not n:
            break
    outs = []
    for g, db, name in zip(graphs, dbs, ("jax.txt", "torch.txt")):
        with open(tmp_path / name, "w") as f:
            g.writetrivialpaths(f, db.decode, eos="$")
        outs.append((tmp_path / name).read_text())
    assert outs[1] == outs[0] and g_seq in outs[0].split("$")


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    """Reads over a genome with a repeat (``tests/test_word_graph.py``),
    a genome FASTA with duplications, the JAX package's build_graph
    output for both, and its Indexer / Xspace files for WordGraph."""
    d = tmp_path_factory.mktemp("torch_wg")
    rng = random.Random(7)
    A, R, B, C = ("".join(rng.choice("ACGT") for _ in range(n))
                  for n in (60, 20, 60, 60))
    g_seq = A + R + B + R + C
    reads = d / "reads.fasta"
    reads.write_text("".join(f">w{i}\n{g_seq[i:i + 50]}\n"
                             for i in range(0, len(g_seq) - 49, 10)))
    gen = d / "genome.fasta"
    s = genome(9, 600, (100, 160))
    gen.write_text(f">g1 one\n{s[:400]}\n>g2 two\n{s[400:]}{s[50:120]}\n")
    files = {"reads": str(reads), "genome": str(gen), "g_seq": g_seq}
    for name, fa, k in (("reads", reads, "8"), ("genome", gen, "6")):
        wg, sq = d / f"{name}.wg", d / f"{name}.sq"
        assert entry("sequence_alignment_tools_tpu", "build_graph")(
            ["-i", str(fa), "-k", k, "-g", str(wg), "-s", str(sq)]) == 0
        files[name + "_wg"], files[name + "_sq"] = str(wg), str(sq)
    b = str(d / "ix")
    assert entry("sequence_alignment_tools_tpu", "Indexer")(
        ["-i", b + ".idx", "-f", b + ".fwd", "-r", b + ".rev",
         str(gen)]) == 0
    for m in ("6", "4"):
        assert entry("sequence_alignment_tools_tpu", "Xspace")(
            ["-m", m, "-a", "-i", b + ".idx", "-f", b + ".fwd", "-o",
             f"{b}.xs{m}"]) == 0
    assert entry("sequence_alignment_tools_tpu", "XspaceLo")(
        ["-k", "6", "-r", b + ".rev", "-i", b + ".idx", "-f", b + ".fwd",
         "-o", b + ".lo6"]) == 0
    files["ix"] = b
    return files


@pytest.mark.parametrize("name,k", [("reads", "8"), ("genome", "6"),
                                    ("genome", "11")])
def test_build_graph_parity(graph_files, tmp_path, monkeypatch, name, k):
    _rc, out, _e, files = run_both(
        "build_graph", ["-i", graph_files[name], "-k", k, "-g", "g.wg", "-s",
                        "g.sq"], tmp_path, monkeypatch)
    assert out == b"" and files["g.wg"].count(b"\n") > 50
    assert files["g.sq"].decode().count("$") >= 2


WALK_CONFIGS = [[], ["-R"], ["-N"], ["-O"], ["-R", "-O"], ["-N", "-O"]]


@pytest.mark.parametrize("name,k", [("reads", "8"), ("genome", "6")])
@pytest.mark.parametrize("cfg", WALK_CONFIGS,
                         ids=lambda c: " ".join(c) or "d")
def test_walk_graph_parity(graph_files, tmp_path, monkeypatch, cfg, name, k):
    """walk_graph (``-O``: the min-cost flow routes the redundant edges)
    on the JAX package's graph, to stdout and to ``-o``."""
    argv = ["-g", graph_files[name + "_wg"], "-s", graph_files[name + "_sq"],
            "-k", k] + cfg
    _rc, out, _e, _f = run_both("walk_graph", argv, tmp_path / "out",
                                monkeypatch)
    assert out.count(b"$") >= 2
    _rc, _o, _e, files = run_both("walk_graph", argv + ["-o", "walk.txt"],
                                  tmp_path / "file", monkeypatch)
    assert files["walk.txt"] == out


@pytest.mark.parametrize("tool,cfg", [("cannon_csbh_graph", ["-k", "8"]),
                                      ("cannon_csbh_graph", ["-k", "8", "-o",
                                                             "c.wg"]),
                                      ("csbh_annotate", ["-k", "8"]),
                                      ("csbh_annotate", ["-k", "8", "-n",
                                                         "reads", "-o",
                                                         "a.wig"])],
                         ids=["cannon", "cannon-file", "annotate",
                              "annotate-file"])
def test_graph_tools_parity(graph_files, tmp_path, monkeypatch, tool, cfg):
    _rc, out, _e, files = run_both(
        tool, ["-g", graph_files["reads_wg"]] + cfg, tmp_path, monkeypatch)
    text = files.get(cfg[-1], out)
    assert text.count(b"\n") > 5


@pytest.mark.parametrize("cfg", [["-k", "8"], ["-k", "8", "-c", "1"],
                                 ["-k", "8", "-o", "asm.out"]],
                         ids=["d", "one-cycle", "file"])
def test_solid_assembly_parity(graph_files, tmp_path, monkeypatch, cfg):
    """solid_assembly reassembles the genome through its repeat (the JAX
    package's graph, peeled by the reads)."""
    _rc, out, _e, files = run_both(
        "solid_assembly", ["-g", graph_files["reads_wg"], "-i",
                           graph_files["reads"]] + cfg, tmp_path, monkeypatch)
    contigs = files.get("asm.out", out).decode().split("$")
    if cfg[-1] != "1":
        assert graph_files["g_seq"] in contigs


def test_solid_assembly_ee_format(graph_files, tmp_path, monkeypatch):
    """The E/e edge list that WordGraph writes."""
    ee = tmp_path / "g.ee"
    ee.write_text("E\t1\t2\t10\t11\t1\ne\t2\t3\t11\t12\n"
                  "E\t2\t3\t11\t12\t2\n.\n")
    _rc, out, _e, _f = run_both(
        "solid_assembly", ["-g", str(ee), "-i", graph_files["reads"], "-k",
                           "4"], tmp_path / "run", monkeypatch)
    assert out.startswith(b"$")


@pytest.mark.parametrize("xs,cfg", [("xs6", ["-m", "6"]),
                                    ("xs6", ["-m", "6", "-e"]),
                                    ("xs4", ["-m", "4", "-E"]),
                                    ("lo6", ["-m", "6", "-A", "-o",
                                             "wg.ee"])],
                         ids=["m6", "keep-eos", "distinguish-eos", "lo-file"])
def test_wordgraph_parity(graph_files, tmp_path, monkeypatch, xs, cfg):
    b = graph_files["ix"]
    _rc, out, _e, files = run_both(
        "WordGraph", ["-x", f"{b}.{xs}", "-f", b + ".fwd"] + cfg, tmp_path,
        monkeypatch)
    text = files.get("wg.ee", out)
    assert text.endswith(b".\n") and text.count(b"E\t") > 10


def test_wordgraph_usage(tmp_path, monkeypatch):
    rc, _o, err, _f = run_both("WordGraph", ["-m", "4"], tmp_path,
                               monkeypatch)
    assert rc == 1 and err.startswith(b"WordGraph:")
