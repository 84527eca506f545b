"""Min-cost flow for word-graph balancing (the reference links the classic
NETFLO network-simplex port, netflo.h/cc, and Goldberg's CS2 for
walk_graph's optimal walks).  Successive shortest augmenting paths with
Johnson potentials — exact optimum, sized for graph-balancing instances
(thousands of nodes).

The port's copy of ``sequence_alignment_tools_tpu/ops/netflo.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import heapq


def min_cost_flow(n: int, arcs, src: int, snk: int, want: int):
    """arcs: iterable of (u, v, cap, cost, tag).  Returns the per-arc flow
    list (same order).  Sends up to ``want`` units; raises ValueError if the
    demand cannot be met."""
    # residual graph arrays
    head = []
    nxt = []
    first = [-1] * n
    cap = []
    cost = []

    def add(u, v, c, w):
        head.append(v)
        cap.append(c)
        cost.append(w)
        nxt.append(first[u])
        first[u] = len(head) - 1

    arc_ids = []
    for u, v, c, w, _tag in arcs:
        arc_ids.append(len(head))
        add(u, v, c, w)
        add(v, u, 0, -w)

    flow_sent = 0
    pot = [0] * n
    INF = float("inf")
    while flow_sent < want:
        dist = [INF] * n
        dist[src] = 0
        prev_arc = [-1] * n
        pq = [(0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist[u]:
                continue
            a = first[u]
            while a != -1:
                if cap[a] > 0:
                    v = head[a]
                    nd = d + cost[a] + pot[u] - pot[v]
                    if nd < dist[v]:
                        dist[v] = nd
                        prev_arc[v] = a
                        heapq.heappush(pq, (nd, v))
                a = nxt[a]
        if dist[snk] == INF:
            raise ValueError("demand cannot be satisfied")
        for i in range(n):
            if dist[i] < INF:
                pot[i] += dist[i]
        # bottleneck along the path
        push = want - flow_sent
        v = snk
        while v != src:
            a = prev_arc[v]
            push = min(push, cap[a])
            v = head[a ^ 1]
        v = snk
        while v != src:
            a = prev_arc[v]
            cap[a] -= push
            cap[a ^ 1] += push
            v = head[a ^ 1]
        flow_sent += push
    return [cap[a ^ 1] for a in arc_ids]
