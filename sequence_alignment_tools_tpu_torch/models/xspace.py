"""Xspace / XspaceLo — mer "x-space" (context-branching mer class)
analysis over Indexer flat files (reference ``Xspace.cc``,
``XspaceLo.cc``, ``xspacefsm.cc``, ``rl_suffix_tree.h``).

Both tools partition the depth-``m`` cut of a (generalized) suffix tree
of the ``$``-separated flat sequence into *mer classes* — groups of
suffixes sharing their first ``m`` characters, truncated at each
suffix's own segment terminal — and print the classes whose occurrence
contexts branch: the left characters or the ``m``-extension characters
are non-uniform, or a terminal appears among them
(``SufTree::interesting``, ``Xspace.cc:115-131``).

Instead of replaying the reference's McCreight-style construction, the
classes are derived vectorially from the flat array; the reference's
*tree order* is reproduced from its sibling-list invariants
(``rl_suffix_tree.h:685-980``): children are kept sorted by branch
character, except terminal leaves which are PREPENDED (newest first), so

* classes print in lexicographic key order, and
* leaves within a class print by recursive bucket order — at each
  depth, terminal suffixes first in descending position, then the
  non-terminal buckets by ascending character.

XspaceLo adds the streaming FSM (``xspacefsm.cc:119-340``): other
blocks' forward sequences and every block's reverse-complement stream
walk the tree; a stream occurrence of a class's m-prefix with a context
(left char ``m+1`` back, current char) that any tree occurrence fails
to match marks the class interesting.  Quirk: for a class whose top
node has length exactly ``m``, the walk branches into the child before
evaluating (``xspacefsm.cc:252-263`` keeps ``dep < mersize+1``
branching), so stream marks land on the child subclass matching the
stream's extension character — and are lost entirely when no child
matches.  Stream characters are mapped with terminals/mismatches as
``'%'`` (MAP2), which never matches in-block paths.

The port's copy of ``sequence_alignment_tools_tpu/models/xspace.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

TERM = ord("$")
TERM2 = ord("%")


class MerClass:
    __slots__ = ("key", "members", "lcp", "lefts", "exts")

    def __init__(self, key: bytes, members: list[int]):
        self.key = key
        self.members = members  # ascending suffix positions
        self.lcp = 0
        self.lefts: np.ndarray | None = None
        self.exts: np.ndarray | None = None


def _group_lcp(S: np.ndarray, members: list[int], m: int,
               seg_end: np.ndarray) -> int:
    """Length of the longest common prefix of the group's (truncated)
    suffixes; >= m by construction."""
    d = m
    first = members[0]
    while True:
        if seg_end[first] < first + d:
            return d  # first suffix ended (all members identical strings)
        c = S[first + d] if first + d < len(S) else -1
        for p in members[1:]:
            if p + d >= len(S) or S[p + d] != c or seg_end[p] < p + d:
                return d
        if c == TERM:
            return d + 1
        d += 1


class XspaceAnalysis:
    """Depth-m class analysis of one block of the flat array."""

    def __init__(self, S: np.ndarray, m: int):
        self.S = S
        self.m = m
        n = len(S)
        # seg_end[p] = position of the first terminal at or after p
        is_term = S == TERM
        idx = np.where(is_term, np.arange(n), n)
        self.seg_end = np.minimum.accumulate(idx[::-1])[::-1]
        # class-eligible suffixes: no terminal within the first m chars.
        # A key ending in '$' means identical-to-terminal suffixes, which
        # attach as bare terminal leaves with NO depth-m node — the
        # reference's process() never visits them.
        ok = self.seg_end >= np.arange(n) + m
        ok &= np.arange(n) + m <= n
        # m-gram keys via sliding windows
        self.classes: dict[bytes, MerClass] = {}
        order: list[bytes] = []
        if n >= m:
            win = np.lib.stride_tricks.sliding_window_view(S, m)
            for p in np.nonzero(ok[:n - m + 1])[0].tolist():
                key = win[p].tobytes()
                cl = self.classes.get(key)
                if cl is None:
                    cl = MerClass(key, [])
                    self.classes[key] = cl
                    order.append(key)
                cl.members.append(p)
        self.order = sorted(order)
        pad = np.concatenate([S, np.zeros(1, S.dtype)])
        for cl in self.classes.values():
            ms = np.asarray(cl.members)
            cl.lefts = S[ms - 1]  # p=0 is always the bare terminal suffix
            cl.exts = pad[ms + self.m]
        # marks
        self.nZ: set[bytes] = set()               # whole-class marks
        self.subZ: dict[bytes, set] = {}          # exact-m-node child marks
        self.leafZ: set[bytes] = set()            # singleton leaf marks
        self.tleafZ: set[tuple] = set()           # terminal-leaf bleed marks

    # -- self analysis ------------------------------------------------------

    def self_interesting(self, cl: MerClass) -> bool:
        """interesting() over the class's own occurrences
        (Xspace.cc:115-131): non-uniform left or ext, or any terminal."""
        lefts, exts = cl.lefts, cl.exts
        return bool(
            len(np.unique(lefts)) > 1 or len(np.unique(exts)) > 1
            or (lefts == TERM).any() or (exts == TERM).any()
        )

    def selfstream(self):
        for key in self.order:
            cl = self.classes[key]
            if len(cl.members) >= 2 and self.self_interesting(cl):
                self.nZ.add(key)

    # -- streaming (XspaceLo) ----------------------------------------------

    def _lcp(self, cl: MerClass) -> int:
        if cl.lcp == 0:
            cl.lcp = _group_lcp(self.S, cl.members, self.m, self.seg_end)
        return cl.lcp

    def _vs_interesting(self, lefts, exts, c0: int, c: int) -> bool:
        return bool((lefts != c0).any() or (exts != c).any()
                    or (lefts == TERM).any() or (exts == TERM).any())

    def stream(self, T: np.ndarray):
        """One mapped stream pass (xspacefsm.cc:119-340)."""
        m = self.m
        n = len(T)
        if n <= m:
            return
        win = np.lib.stride_tricks.sliding_window_view(T, m)
        for t in range(m, n):
            key = win[t - m].tobytes()
            cl = self.classes.get(key)
            if cl is None:
                continue
            c0 = int(T[t - m - 1]) if t - m - 1 >= 0 else TERM
            c = int(T[t])
            if len(cl.members) == 1:
                if key not in self.leafZ and \
                        self._vs_interesting(cl.lefts, cl.exts, c0, c):
                    self.leafZ.add(key)
                continue
            if key in self.nZ:
                continue
            if self._lcp(cl) > m:
                if self._vs_interesting(cl.lefts, cl.exts, c0, c):
                    self.nZ.add(key)
            else:
                # exact-m node: the walk branches into the first child in
                # sibling order whose branch char matches the stream's
                # extension char before evaluating.  Terminal leaves sit
                # first (newest-first) and "branch" on their past-terminal
                # bleed byte (str(leaf)[m] reads into the next segment).
                sub = self._match_child(cl, c)
                if sub is None:
                    continue
                marked = self.subZ.setdefault(key, set())
                if c in marked:
                    continue
                lefts = cl.lefts[sub]
                exts = cl.exts[sub]
                if self._vs_interesting(lefts, exts, c0, c):
                    marked.add(c)

    def _match_child(self, cl: MerClass, c: int):
        """Child bucket of an exact-m node matching stream char c.
        Terminal children (suffixes ending with '$' at offset m) branch
        on '$' and can never match a stream character."""
        m = self.m
        sub = [i for i, p in enumerate(cl.members)
               if self.seg_end[p] > p + m and cl.exts[i] == c]
        return sub or None

    # -- output -------------------------------------------------------------

    def _leaf_order(self, members: list[int], d: int) -> list[int]:
        """Tree sibling order: terminal leaves newest-first, then buckets
        by ascending branch character."""
        if len(members) <= 1:
            return members
        S, seg_end = self.S, self.seg_end
        terms = sorted((p for p in members if seg_end[p] <= p + d),
                       reverse=True)
        rest: dict[int, list[int]] = {}
        for p in members:
            if seg_end[p] <= p + d:
                continue
            rest.setdefault(int(S[p + d]) if p + d < len(S) else 0,
                            []).append(p)
        out = list(terms)
        for c in sorted(rest):
            out.extend(self._leaf_order(rest[c], d + 1))
        return out

    def emit(self, out, offset: int = 0):
        """output_nodes DFS (xspacefsm.cc:53-71 / Xspace process)."""
        m = self.m
        pad_len = len(self.S)
        for key in self.order:
            cl = self.classes[key]
            if len(cl.members) == 1:
                if key in self.leafZ:
                    self._print_line(out, cl.members, offset)
                continue
            if key in self.nZ:
                self._print_line(out, self._leaf_order(cl.members, m),
                                 offset)
            else:
                # marked children of an exact-m node, in sibling order:
                # terminal leaves (desc p) then buckets by ascending char
                tmarks = sorted((p for k, p in self.tleafZ if k == key),
                                reverse=True)
                for p in tmarks:
                    self._print_line(out, [p], offset)
                if key in self.subZ:
                    for c in sorted(self.subZ[key]):
                        sub = [p for i, p in enumerate(cl.members)
                               if cl.exts[i] == c
                               and self.seg_end[p] > p + m]
                        self._print_line(out, self._leaf_order(sub, m + 1),
                                         offset)

    def _print_line(self, out, members: list[int], offset: int):
        S = self.S
        parts = []
        for p in members:
            e = p + self.m
            ch = chr(int(S[e])) if e < len(S) else "\0"
            parts.append(f" {e + offset}.{ch}")
        out.write("".join(parts) + "\n")
