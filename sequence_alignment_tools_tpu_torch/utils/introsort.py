"""Faithful replica of libstdc++ std::sort (introsort).

The reference sorts candidate hits with ``std::sort`` under a *key-only*
comparator (``sortedvector::normalize``, sortedvector.t:502-504 with
``element::operator<`` comparing keys only, :38-44).  Ties are therefore
ordered by the sort's internal (unstable but deterministic) behavior, and
that order is visible in primer_match's output for k >= 2.  To reproduce the
reference byte-for-byte we replicate GCC's introsort exactly: median-of-3
quicksort with threshold 16, depth limit 2*floor(log2 n) falling back to
heapsort, and a final insertion-sort pass (bits/stl_algo.h, bits/stl_heap.h).

Verified against g++-compiled std::sort on random tie-heavy inputs in
tests/test_introsort.py.

The port's copy of ``sequence_alignment_tools_tpu/utils/introsort.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

_THRESHOLD = 16


def introsort(a: list, comp) -> None:
    """In-place std::sort(a.begin(), a.end(), comp) replica."""
    n = len(a)
    if n == 0:
        return
    depth = 2 * (n.bit_length() - 1)
    _introsort_loop(a, 0, n, depth, comp)
    _final_insertion_sort(a, 0, n, comp)


def _introsort_loop(a, first, last, depth, comp):
    while last - first > _THRESHOLD:
        if depth == 0:
            _heap_sort(a, first, last, comp)
            return
        depth -= 1
        cut = _unguarded_partition_pivot(a, first, last, comp)
        _introsort_loop(a, cut, last, depth, comp)
        last = cut


def _move_median_to_first(a, result, x, y, z, comp):
    if comp(a[x], a[y]):
        if comp(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif comp(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif comp(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif comp(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition_pivot(a, first, last, comp):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
    return _unguarded_partition(a, first + 1, last, first, comp)


def _unguarded_partition(a, first, last, pivot, comp):
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _final_insertion_sort(a, first, last, comp):
    if last - first > _THRESHOLD:
        _insertion_sort(a, first, first + _THRESHOLD, comp)
        _unguarded_insertion_sort(a, first + _THRESHOLD, last, comp)
    else:
        _insertion_sort(a, first, last, comp)


def _insertion_sort(a, first, last, comp):
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, comp)


def _unguarded_insertion_sort(a, first, last, comp):
    for i in range(first, last):
        _unguarded_linear_insert(a, i, comp)


def _unguarded_linear_insert(a, last, comp):
    val = a[last]
    nxt = last - 1
    while comp(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


# -- heapsort fallback (bits/stl_heap.h semantics) ---------------------------


def _heap_sort(a, first, last, comp):
    _make_heap(a, first, last, comp)
    _sort_heap(a, first, last, comp)


def _push_heap(a, first, hole, top, value, comp):
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, comp):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length % 2 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, comp)


def _make_heap(a, first, last, comp):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, comp)
        if parent == 0:
            return
        parent -= 1


def _sort_heap(a, first, last, comp):
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, comp)
