"""De Bruijn word graph (the reference's CSBH stack: word_graph.h/cc,
WordGraph.cc, walk_graph.cc).

Nodes are distinct k-mers of the sequence database; edges are observed
k-mer adjacencies (overlap k-1) carrying a representative sequence end
position and a multiplicity count.  Text serialization follows
``word_graph::read`` (word_graph.cc:57-140):

- fixed-mersize lines:  ``from to fseqend tseqend count``
- variable-length lines: ``from to fseqst fseqed tseqst tseqed count``

The walk side reproduces the reference pipeline's stages: trivial-path
compression (compressed sparse branching hypergraph), node balancing —
optionally via min-cost flow over the imbalance network (the reference
links NETFLO/CS2; ops/netflo.py is the solver here) — and an Eulerian walk
emitting the compressed sequence (``-R`` duplicates redundant k-mers, ``-N``
inserts new joiner k-mers).

The port's copy of ``sequence_alignment_tools_tpu/models/word_graph.py``,
kept byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Edge:
    frm: int
    to: int
    seq_end: int  # flat end position of the 'to' mer occurrence
    length: int   # chars contributed by 'to' when traversed (1 for k-overlap)
    count: int = 1
    real: bool = True
    mark: bool = False


@dataclass
class WordGraph:
    mersize: int = 0
    nodes: dict = field(default_factory=dict)  # id -> representative seq_end
    edges: list = field(default_factory=list)
    out_adj: dict = field(default_factory=dict)
    in_deg: dict = field(default_factory=dict)
    out_deg: dict = field(default_factory=dict)

    # -- construction -------------------------------------------------------

    def add_node(self, nid: int, seq_end: int) -> None:
        if nid not in self.nodes:
            self.nodes[nid] = seq_end
            self.out_adj[nid] = []
            self.in_deg[nid] = 0
            self.out_deg[nid] = 0

    def add_edge(self, e: Edge) -> None:
        self.edges.append(e)
        self.out_adj[e.frm].append(e)
        self.out_deg[e.frm] += e.count
        self.in_deg[e.to] += e.count

    @classmethod
    def build(cls, codes: np.ndarray, mersize: int, eos_code: int,
              alpha: int) -> "WordGraph":
        """Build the k-mer adjacency graph of a flat code array (EOS breaks
        runs) — node ids are base-|alpha| mer codes, edge counts aggregate
        multiplicity (the reference's WordGraph builder walks a suffix
        tree; the radix-code census is the vectorizable equivalent)."""
        g = cls(mersize=mersize)
        n = len(codes)
        k = mersize
        valid = codes != eos_code
        if n < k:
            return g
        # rolling ids of all k-windows + validity
        ids = np.zeros(n - k + 1, dtype=np.int64)
        ok = np.ones(n - k + 1, dtype=bool)
        for j in range(k):
            ids = ids * alpha + codes[j : j + n - k + 1]
            ok &= valid[j : j + n - k + 1]
        pair_counts: dict[tuple[int, int], Edge] = {}
        last_id = None
        for i in range(len(ids)):
            if not ok[i]:
                last_id = None
                continue
            nid = int(ids[i])
            g.add_node(nid, i + k)
            if last_id is not None:
                key = (last_id, nid)
                e = pair_counts.get(key)
                if e is None:
                    e = Edge(frm=last_id, to=nid, seq_end=i + k, length=1,
                             count=0)
                    pair_counts[key] = e
                e.count += 1
            last_id = nid
        for e in pair_counts.values():
            g.add_edge(e)
        return g

    # -- serialization (word_graph.cc:57-140) -------------------------------

    def write(self, f) -> None:
        for e in sorted(self.edges, key=lambda e: (e.frm, e.to)):
            if self.mersize > 0:
                f.write(f"{e.frm} {e.to} "
                        f"{self.nodes[e.frm]} {e.seq_end} {e.count}\n")
            else:
                f.write(f"{e.frm} {e.to} 0 {self.nodes[e.frm]} "
                        f"0 {e.seq_end} {e.count}\n")

    @classmethod
    def read(cls, path: str, mersize: int = 0) -> "WordGraph":
        g = cls(mersize=mersize)
        for line in open(path):
            parts = line.split()
            if not parts:
                continue
            if mersize > 0:
                frm, to, fse, tse, count = (int(x) for x in parts[:5])
            else:
                frm, to, _fs, fse, _ts, tse, count = (
                    int(x) for x in parts[:7]
                )
            g.add_node(frm, fse)
            g.add_node(to, tse)
            g.add_edge(Edge(frm=frm, to=to, seq_end=tse,
                            length=max(tse - fse, 1) if mersize <= 0 else 1,
                            count=count, real=count > 0))
        return g

    # -- analysis / transforms ---------------------------------------------

    def stats(self) -> dict:
        return {
            "nodes": len(self.nodes),
            "edges": len(self.edges),
            "total_count": sum(e.count for e in self.edges),
            "unbalanced": sum(
                1 for nid in self.nodes
                if self.in_deg[nid] != self.out_deg[nid]
            ),
        }

    def compress_trivial_paths(self) -> int:
        """Merge chains through nodes with in==out==1 (the CSBH compression,
        word_graph.cc trivial-path removal).  Returns merges performed."""
        merged = 0
        simple = {
            nid for nid in self.nodes
            if self.in_deg[nid] == 1 and self.out_deg[nid] == 1
            and len(self.out_adj[nid]) == 1
        }
        in_edge: dict[int, list[Edge]] = {nid: [] for nid in self.nodes}
        for e in self.edges:
            in_edge[e.to].append(e)
        for nid in list(simple):
            ins = in_edge[nid]
            outs = self.out_adj[nid]
            if len(ins) != 1 or len(outs) != 1:
                continue
            a, b = ins[0], outs[0]
            if a.frm == nid or b.to == nid or a.count != b.count:
                continue
            # splice a->nid->b into a->b
            a.to = b.to
            a.seq_end = b.seq_end
            a.length += b.length
            in_edge[b.to].remove(b)
            in_edge[b.to].append(a)
            self.edges.remove(b)
            self.out_adj[nid] = []
            merged += 1
        if merged:
            self._recompute_degrees()
        return merged

    def _recompute_degrees(self) -> None:
        for nid in self.nodes:
            self.in_deg[nid] = 0
            self.out_deg[nid] = 0
            self.out_adj[nid] = []
        for e in self.edges:
            self.out_adj[e.frm].append(e)
            self.out_deg[e.frm] += e.count
            self.in_deg[e.to] += e.count

    def balance(self, mode: str = "new", optimize: bool = False) -> int:
        """Make every node Eulerian-balanced by adding edges.

        mode 'new': add artificial joiner edges (walk emits new k-mers);
        mode 'redundant': duplicate existing real edges along paths from
        surplus-in nodes to surplus-out nodes (walk re-emits known k-mers).
        With ``optimize`` the pairing/routing minimizes added characters via
        min-cost flow (the reference's NETFLO/CS2 use); otherwise a greedy
        pairing is used.  Returns number of edge-units added."""
        excess_in = []  # nodes with in > out: need extra out capacity
        excess_out = []  # nodes with out > in
        for nid in self.nodes:
            d = self.in_deg[nid] - self.out_deg[nid]
            if d > 0:
                excess_in.append((nid, d))
            elif d < 0:
                excess_out.append((nid, -d))
        if not excess_in:
            return 0
        added = 0
        if mode == "redundant" and optimize:
            from ..ops.netflo import min_cost_flow

            added += self._balance_flow(excess_in, excess_out,
                                        min_cost_flow)
        elif mode == "redundant":
            added += self._balance_paths(excess_in, excess_out)
        else:
            # artificial joiners: pair arbitrary surplus nodes
            i = j = 0
            excess_in = [list(x) for x in excess_in]
            excess_out = [list(x) for x in excess_out]
            while i < len(excess_in) and j < len(excess_out):
                a, da = excess_in[i]
                b, db = excess_out[j]
                u = min(da, db)
                e = Edge(frm=a, to=b, seq_end=self.nodes[b],
                         length=self.mersize, count=u, real=False)
                self.add_edge(e)
                added += u
                excess_in[i][1] -= u
                excess_out[j][1] -= u
                if excess_in[i][1] == 0:
                    i += 1
                if excess_out[j][1] == 0:
                    j += 1
        return added

    def _balance_paths(self, excess_in, excess_out) -> int:
        """Greedy: BFS a real path from each surplus-in node to a
        surplus-out node and duplicate its edges."""
        from collections import deque

        need_out = {nid: d for nid, d in excess_out}
        added = 0
        for nid, d in excess_in:
            for _ in range(d):
                # BFS to the nearest node needing extra in-capacity
                prev: dict[int, Edge] = {}
                seen = {nid}
                q = deque([nid])
                target = None
                while q:
                    u = q.popleft()
                    if need_out.get(u, 0) > 0 and u != nid:
                        target = u
                        break
                    for e in self.out_adj[u]:
                        if e.real and e.to not in seen:
                            seen.add(e.to)
                            prev[e.to] = e
                            q.append(e.to)
                if target is None:
                    # fall back to an artificial joiner
                    b = next(iter(need_out)) if need_out else nid
                    self.add_edge(Edge(frm=nid, to=b,
                                       seq_end=self.nodes[b],
                                       length=self.mersize, count=1,
                                       real=False))
                    added += 1
                    if need_out.get(b, 0) > 0:
                        need_out[b] -= 1
                    continue
                # duplicate the path edges
                path = []
                u = target
                while u != nid:
                    e = prev[u]
                    path.append(e)
                    u = e.frm
                for e in path:
                    e.count += 1
                    self.out_deg[e.frm] += 1
                    self.in_deg[e.to] += 1
                    added += 1
                need_out[target] -= 1
                # degrees shift: nid gained an out-unit, target an in-unit
        self._recompute_degrees()
        return added

    def _balance_flow(self, excess_in, excess_out, min_cost_flow) -> int:
        """Optimal duplication: min-cost flow where each real edge can be
        duplicated at cost = its emitted length; imbalance that cannot route
        through real edges escapes through high-cost artificial arcs, which
        materialize as joiner edges (new k-mers) like the reference's
        restart edges."""
        ids = {nid: i for i, nid in enumerate(self.nodes)}
        n = len(ids)
        src, snk = n, n + 1
        big = self.mersize + 2 if self.mersize > 0 else 64
        arcs = []
        for e in self.edges:
            if e.real:
                arcs.append((ids[e.frm], ids[e.to], 10**9, e.length, e))
        for nid, d in excess_in:
            arcs.append((src, ids[nid], d, 0, None))
            arcs.append((ids[nid], snk, d, big, ("art", nid)))
        for nid, d in excess_out:
            arcs.append((ids[nid], snk, d, 0, None))
        total = sum(d for _, d in excess_in)
        flow = min_cost_flow(n + 2, arcs, src, snk, total)
        added = 0
        art: list[tuple[int, int]] = []
        out_used: dict[int, int] = {nid: 0 for nid, _ in excess_out}
        for (u, v, cap, cost, tag), f in zip(arcs, flow):
            if f <= 0:
                continue
            if isinstance(tag, Edge):
                tag.count += f
                added += f
            elif isinstance(tag, tuple) and tag[0] == "art":
                art.append((tag[1], f))
            elif v == snk and cost == 0:
                for nid, d in excess_out:
                    if ids[nid] == u:
                        out_used[nid] += f
        # artificial escapes become joiner edges to leftover surplus-out
        # nodes (or self-loops when none remain)
        leftover = [(nid, d - out_used.get(nid, 0)) for nid, d in excess_out]
        leftover = [[nid, d] for nid, d in leftover if d > 0]
        j = 0
        for nid, f in art:
            while f > 0:
                if j < len(leftover):
                    b, db = leftover[j]
                    u = min(f, db)
                    leftover[j][1] -= u
                    if leftover[j][1] == 0:
                        j += 1
                else:
                    b, u = nid, f
                self.add_edge(Edge(frm=nid, to=b, seq_end=self.nodes[b],
                                   length=self.mersize, count=u,
                                   real=False))
                added += u
                f -= u
        self._recompute_degrees()
        return added

    # -- Eulerian walk ------------------------------------------------------

    def eulerian_paths(self) -> list[list[Edge]]:
        """Decompose all edge units into Eulerian paths (Hierholzer),
        starting at surplus-out nodes first."""
        remaining = {id(e): e.count for e in self.edges}
        adj = {nid: list(self.out_adj[nid]) for nid in self.nodes}
        outn = dict(self.out_deg)
        inn = dict(self.in_deg)

        def take(u):
            lst = adj[u]
            while lst:
                e = lst[-1]
                if remaining[id(e)] > 0:
                    remaining[id(e)] -= 1
                    if remaining[id(e)] == 0:
                        lst.pop()
                    return e
                lst.pop()
            return None

        paths = []
        starts = [nid for nid in self.nodes if outn[nid] > inn[nid]]
        starts += [nid for nid in self.nodes if outn[nid] > 0]
        for s in starts:
            while True:
                e0 = take(s)
                if e0 is None:
                    break
                path = [e0]
                u = e0.to
                while True:
                    e = take(u)
                    if e is None:
                        break
                    path.append(e)
                    u = e.to
                # splice sub-tours (Hierholzer)
                i = 0
                while i < len(path):
                    u2 = path[i].to
                    e = take(u2)
                    if e is None:
                        i += 1
                        continue
                    tour = [e]
                    v = e.to
                    while v != u2:
                        e2 = take(v)
                        if e2 is None:
                            break
                        tour.append(e2)
                        v = e2.to
                    path[i + 1 : i + 1] = tour
                paths.append(path)
        return paths

    def walk_seq(self, decode, eos: str = "$") -> str:
        """Emit the compressed sequence: for each Eulerian path, the first
        node's mer then each edge's contributed chars (length chars ending
        at seq_end); artificial edges emit the full target mer after an
        EOS break (new k-mers)."""
        out = []
        k = self.mersize
        for path in self.eulerian_paths():
            if not path:
                continue
            start = path[0].frm
            out.append(decode(self.nodes[start] - k, self.nodes[start]))
            for e in path:
                if e.real:
                    out.append(decode(e.seq_end - e.length, e.seq_end))
                else:
                    out.append(eos)
                    out.append(decode(self.nodes[e.to] - k,
                                      self.nodes[e.to]))
            out.append(eos)
        return "".join(out)

    # -- solid_assembly support (word_graph.cc:438-456, 1207-1716) ----------

    def _in_edges(self) -> dict:
        ins: dict[int, list[Edge]] = {nid: [] for nid in self.nodes}
        for e in self.edges:
            ins[e.to].append(e)
        return ins

    def find_widgets(self) -> dict:
        """Widget map (word_graph.cc:1216-1282): one-node widgets are
        nodes with in>1 and out>1; two-node widgets run from a node with
        in>1,out==1 through a 1-in-1-out chain to a node with
        in==1,out>1 — degrees are STRUCTURAL edge counts (graph.h
        nin/nout are list sizes), not multiplicities.  A widget is
        rejected when any neighbour already belongs to another widget.
        Returns {start: end} (start==end for one-node widgets, end: None
        marks interior reservations)."""
        ins = self._in_edges()
        nin = {nid: len(ins[nid]) for nid in self.nodes}
        nout = {nid: len(self.out_adj[nid]) for nid in self.nodes}
        widget: dict[int, int | None] = {}
        for nid in self.nodes:
            if nin[nid] <= 1:
                continue
            if nout[nid] == 1 and self.out_adj[nid]:
                n = self.out_adj[nid][0].to
                while nin[n] == 1 and nout[n] == 1 \
                        and self.out_adj[n]:
                    n = self.out_adj[n][0].to
                if nin[n] == 1 and nout[n] > 1:
                    good = all(e.frm not in widget for e in ins[nid]) and \
                        all(e.to not in widget for e in self.out_adj[n])
                    if good:
                        widget[nid] = n
                        widget[n] = None
            elif nout[nid] > 1:
                good = all(e.frm not in widget for e in ins[nid]) and \
                    all(e.to not in widget for e in self.out_adj[nid])
                if good:
                    widget[nid] = nid
        return widget

    def peel_edges(self, db, mersize: int) -> int:
        """One round of read-guided widget peeling (the intent of
        word_graph::peel_edges, word_graph.cc:1207-1716 — the reference's
        own binary dies on its own WordGraph outputs: its graph reader
        expects numeric edge lines and its node sequence lookups walk
        out of the read file).  Reads are threaded through the graph;
        paths crossing a widget contribute marked bridge edges; widgets
        with bridge support are split into per-source clones and the
        superseded edges removed.  Returns the number of changed
        widgets."""
        for e in self.edges:
            e.mark = False
        k = mersize
        widget = self.find_widgets()
        if not any(v is not None for v in widget.values()):
            return 0

        mer_of: dict[str, list[int]] = {}
        for nid, se in self.nodes.items():
            mer_of.setdefault(db.decode(se - k, se), []).append(nid)

        # thread each read; record bridges over widgets
        ins = self._in_edges()
        for ent in range(db.n_entries):
            start = int(db.entry_starts[ent])
            buf = db.decode(start, start + int(db.entry_lengths[ent]))
            if len(buf) < k:
                continue
            for nid in mer_of.get(buf[:k], ()):
                path: list[Edge] = []
                p = k
                n = nid
                ok = True
                while p < len(buf):
                    nxt = None
                    for e in self.out_adj[n]:
                        if not e.mark and db.decode(
                                e.seq_end - e.length,
                                e.seq_end)[:1] == buf[p]:
                            nxt = e
                            break
                    if nxt is None:
                        ok = False
                        break
                    path.append(nxt)
                    p += nxt.length
                    n = nxt.to
                if not ok or not path:
                    continue
                # find widget crossings and add marked bridges
                prefix_len = 0
                i = 0
                while i < len(path):
                    while i < len(path) and widget.get(path[i].to) is None:
                        prefix_len += path[i].length
                        i += 1
                    if i >= len(path):
                        break
                    left = i
                    xnd1 = widget[path[i].to]
                    edge_len = path[i].length
                    i += 1
                    while i < len(path) and path[i].frm != xnd1:
                        edge_len += path[i].length
                        i += 1
                    if i >= len(path):
                        break
                    edge_len += path[i].length
                    f, t = path[left].frm, path[i].to
                    if not any(e.to == t and e.mark
                               for e in self.out_adj[f]):
                        br = Edge(frm=f, to=t,
                                  seq_end=start + k + prefix_len + edge_len,
                                  length=edge_len, count=1, mark=True)
                        self.add_edge(br)
                        ins[t].append(br)
                    i = left + 1

        # resolve supported widgets
        nchanges = 0
        new_label = max(self.nodes) + 1
        for xnd in sorted(widget):
            xnd1 = widget[xnd]
            if xnd1 is None:
                continue
            # bridges from in-sources of xnd to out-targets of xnd1
            targets = {e.to for e in self.out_adj[xnd1] if not e.mark}
            bridges = [e for src_e in ins[xnd]
                       for e in self.out_adj[src_e.frm]
                       if e.mark and e.to in targets]
            if not bridges:
                continue
            sources = sorted({e.frm for e in bridges})
            good = all(any(e.mark for e in self.out_adj[se.frm])
                       for se in ins[xnd] if not se.mark) and \
                all(any(e.mark for e in ins[oe.to])
                    for oe in self.out_adj[xnd1] if not oe.mark)
            clone_of: dict[int, tuple[int, int]] = {}
            first = True
            for src in sources:
                if first and good:
                    clone_of[src] = (xnd, xnd1)
                    first = False
                    continue
                # clone the xnd..xnd1 interior chain
                c0 = new_label
                self.add_node(c0, self.nodes[xnd])
                n0 = xnd
                cs = c0
                while n0 != xnd1:
                    e0 = self.out_adj[n0][0]
                    new_label += 1
                    c1 = new_label
                    self.add_node(c1, self.nodes[e0.to])
                    self.add_edge(Edge(frm=cs, to=c1, seq_end=e0.seq_end,
                                       length=e0.length, count=1))
                    n0 = e0.to
                    cs = c1
                clone_of[src] = (c0, cs)
                new_label += 1
            for src in sources:
                cs, ce = clone_of[src]
                my_bridges = [e for e in bridges if e.frm == src]
                if cs != xnd:
                    # reroute src -> cloneStart (copy of src->xnd)
                    for se in ins[xnd]:
                        if se.frm == src and not se.mark:
                            self.add_edge(Edge(
                                frm=src, to=cs, seq_end=se.seq_end,
                                length=se.length, count=se.count))
                            se.mark = True
                    # cloneEnd -> target for each bridged target
                    for br in my_bridges:
                        for oe in self.out_adj[xnd1]:
                            if oe.to == br.to and not oe.mark:
                                self.add_edge(Edge(
                                    frm=ce, to=br.to, seq_end=oe.seq_end,
                                    length=oe.length, count=oe.count))
                                oe.mark = True
            nchanges += 1
        # drop bridges and superseded originals
        self.edges = [e for e in self.edges if not e.mark]
        self._recompute_degrees()
        return nchanges

    def writetrivialpaths(self, out, decode, eos: str = "$") -> None:
        """word_graph::writetrivialpaths (word_graph.cc:438-456): for
        each edge whose source is not 1-in-1-out, emit the source mer,
        the edge chars, then the chars of the 1-in-1-out chain below."""
        out.write(eos)
        k = self.mersize
        ins = self._in_edges()
        nin = {nid: len(ins[nid]) for nid in self.nodes}
        nout = {nid: len(self.out_adj[nid]) for nid in self.nodes}
        for e in self.edges:
            if nin[e.frm] != 1 or nout[e.frm] != 1:
                out.write(decode(self.nodes[e.frm] - k, self.nodes[e.frm]))
                out.write(decode(e.seq_end - e.length, e.seq_end))
                n = e.to
                while nin[n] == 1 and nout[n] == 1 \
                        and self.out_adj[n]:
                    e1 = self.out_adj[n][0]
                    out.write(decode(e1.seq_end - e1.length, e1.seq_end))
                    n = e1.to
                out.write(eos)
