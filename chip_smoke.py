#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version, then drives the port's main paths (exact, k = 1,
k = 2 and ``-K 2`` primer_match, both strands; the 50,000-pattern exact
batch and its k = 1 halves run; pcr_match; peptides over the six-frame
translation; every other tool that reaches a scanner, through the CLI;
the same paths over a device mesh) at full size and checks their output:

1. card: name and power limit, kernel build time;
2. kernel against plain: ``scan_occupancy`` on the card equals
   ``scan_occupancy_ref`` on the card bit for bit (2^24 positions, the
   bench primer set at k = 0 and 1 and ``-K 2`` poisoned, an odd length,
   150 and 2048 patterns (k = 0 and 1), 33- and 140-base patterns, the
   15-code IUPAC alphabet (k = 0 and 1), a 41-code alphabet, and random
   accept sets that take the per-code mask rows);
3. main path: ``ConvScanner.scan`` over a resident 2^28-position
   database equals the native host shift-and's hit list; the filter at
   2^28 against plain; yardsticks on their own lines: the filter on the
   k = 1 seeds and ``-K 2`` at 2^28 (against plain), an older commit's
   filter timed beside it when ``PARENT_DIR`` holds its source, and the
   census kernel (``scan_slots``) over the same 20 primers (an older
   commit's beside it likewise); then the same
   device route on a small scan (n < 2^20), on 140-base patterns and on
   degenerate primers over an IUPAC database, each launching the kernel;
4. serving: ``scan_stream`` over 16 blocks of 2^24 equals per-block scans,
   then a ``torch.profiler`` breakdown (device time per kernel) of the
   main path scan, the resident stream and the uploaded stream;
5. ``seed_gate`` against plain: the k > 0 seed enumeration and extension
   gate on the card equals ``seed_gate_ref`` on the card (sorted survivor
   sets) on a 2^22 block with planted 1- and 2-edit variants, some next to
   EOS and one primer split by EOS: halves k = 1, ``-K 1`` (band 0),
   k = 2 (node 11), bases (``-3 8``), an odd length, 2048 seeds and a
   forced overflow (cap 1); at 2^22 and 2^28 the kernel equal to plain,
   kernel and plain timed, the older commit's kernel beside it when
   ``PARENT_DIR`` holds its source;
6. the k = 1 main path: ``PrimerMatchModel(k=1, indels=True)`` (halves)
   over the resident 2^28 database, device route against the host route
   (native shift-and seeds), every exact and 1-edit plant found, both
   kernels launched; ``engine_hits_stream`` throughput, the host tail and
   a ``torch.profiler`` breakdown;
7. CLI: ``primer_match -r -c``, ``-r``, ``-k 1 -r -c``, ``-K 1 -r`` and
   ``-k 1 -r -3 8`` (bases) through the device route and the host route
   print the same bytes, and the device run launches the kernels;
8. the k-edit kernels against plain at 2^22 positions, on text dense with
   EOS and planted 1- and 2-edit variants: ``myers_pairs`` against
   ``myers_pairs_ref`` (the bench primers, packed two to a word, k = 1, 2,
   3; each timed, the older commit's Myers kernel beside it when
   ``PARENT_DIR`` holds its source) and ``sellers_scan`` against
   ``sellers_ref`` (100 patterns of 60 to
   100 bases at k = 1, 2, 4, without indels, and degenerate primers over
   an IUPAC database under ``-w``; patterns of about 3,200 and about
   7,400 bases, about 100 and 232 words, all but the first in device
   scratch), and allvall ``-r``'s chunk (2,048 query 20-mers and their
   reverse complements, P = 4,096, k = 1 with indels, over 2^20), both
   also at cap 1 (the overflow); past one launch and byte-sized k over
   2^15 positions: allvall's chunk widened to 35,000 mers (P = 70,000,
   two launches, k = 2; also against the native Sellers rows over
   pattern groups, on text without EOS) and two 300-base patterns at k =
   255 with and without indels (16 counter planes); the older commit's
   Sellers kernel timed beside the long-pattern shapes;
9. the k = 2 main path: ``PrimerMatchModel(k=2, indels=True)`` (the
   filter engine, Myers route) over the resident 2^28 database, engine
   hits equal to the host route's (the native Sellers rows), every exact,
   1- and 2-edit plant found; ``engine_hits_stream`` throughput with the
   host tail, the tail alone and a ``torch.profiler`` breakdown; the
   Myers kernel at 2^28 against plain (and beside the older commit's);
   then a whole-genome panel's shape (:func:`blocked_panel_phase`: 96
   Myers words in 3 groups over a blocked scan of the 2^28 copy, and
   that route timed against Sellers at 34, 64 and 96 patterns); then
   ``-K 2`` (the poisoned k-mismatch scan) against the host route;
10. the Sellers route: 24 primers of 32 to 40 bases with their reverse
    complements (P = 48, Lmax = 40), k = 2, over the first 2^26 positions
    with the primers planted; engine hits equal to the host route's (the
    native Sellers rows over pattern groups that fit the native machine);
    an older commit's Sellers kernel timed beside it when ``PARENT_DIR``
    holds its source, with and without indels; ``engine_hits_stream``
    throughput with the host tail, the tail alone and a ``torch.profiler``
    breakdown;
11. the slot kernels against plain: ``scan_slots`` against
    ``scan_slots_ref`` at 2^20 positions with 5,000 seeds of mixed lengths
    8 to 24 (duplicates, one seed planted across an EOS) and at cap 1 (the
    overflow); ``gate_slots`` against ``gate_slots_ref`` on that slot list
    at k = 1 and 2, with and without indels; ``gate_slots`` over
    ``scan_slots`` against the fused ``seed_gate`` on the 40-seed table
    (equal survivor sets); the pattern-blocked rung (2,500 degenerate
    primers) against the native shift-and over pattern groups;
12. the many-pattern path at full width: 50,000 literal 20-mers drawn
    from the resident 2^28 database; exact, ``scan_seed_arrays`` through
    the census kernel against the native host census over the first 2^26
    positions, then over 2^28; k = 1, ``engine_hits_arrays`` of the halves
    engine (100,000 half seeds: ``scan_slots``, ``gate_slots``, native
    extension) against the CPU route (native census, inline gate) over a
    2^24 prefix, then over 2^28, with a ``torch.profiler`` breakdown of
    both; an older commit's census kernel timed beside this one on both
    seed sets, and the older commit's ``gate_slots`` beside this one,
    when ``PARENT_DIR`` holds their sources; then
    (:func:`prefix_census_phase`) 34,255 peptides of 7 to 45 residues over
    206,000,000 residues with I read as L: the census keyed by prefixes
    against the pattern-blocked route, equal hits, both timed, and the
    kernel's row against ``scan_slots_ref`` at these shapes;
13. pcr_match: ``pairs_stream`` of 10 primer pairs over the resident 2^28
    database at k = 0, equal to ``pairs``;
14. peptide_scan's path: the six-frame translation of the 2^28 database
    (``translate_db``, timed on the host), 10 peptides of 9 residues read
    out of the forward frames at equal steps, k = 0, ``engine_hits``
    equal to the host route's, ``engine_hits_stream`` throughput counted
    in DNA bases (bench.py's ``bench_peptide``); then bench.py's
    wide-alphabet row (``bench_wide_wc``): 15 symbols over 16 M, 10
    IUPAC 14-mers with ``-w -r``, against the host route;
15. CLI: ``-k 2 -r -c``, ``-k 2 -r``, ``-K 2 -r`` and the long primers with
    ``-k 2 -r``; on a 600,000-base corpus the seed-table engines, ``-N 6
    -k 1 -r`` (hash: the census rung), ``-N 15 -K 2 -r`` (gs) and the long
    primers with ``-N 15 -k 2 -r`` (gs: the pattern-blocked rung);
    ``pcr_match -r -M 2000`` at k = 0 and ``-k 1``; on a normalized copy
    of the corpus ``peptide_scan -T A``, ``-T A -K 1`` and ``primer_match
    -T -r`` over 10 peptides of its translation; device bytes equal to
    host bytes;
16. the tools of the scanners' paths through the CLI, each device run
    (``SAT_HOST_SCAN=0``, under ``torch.profiler`` for the device's share
    of its wall) against a host run (:func:`host_route`): on the 2^24
    corpus ``exact_match -r``, ``-r -q``, ``-k`` and ``inexact_match -k 0
    -q`` (the filter), ``-k 1 -q``, ``-k 2 -q`` and the long primers at
    ``-k 2 -q`` (Sellers, against the native Sellers rows), and ``-k 1
    -r`` on a 250,000-base corpus (without ``-q`` each alignment spans
    the text up to its hit); ``tandem_match -r`` on the first entry with
    tandem arrays planted; ``allvall -m 20 -r`` at ``-K 1`` (the
    pattern-blocked filter) and ``-k 1`` (Sellers at P = 4,096) of a
    4,096-base query against the first entry, against the native machines
    over pattern groups; then of a 2^16-base query against the corpus
    (plants exact, with a substitution, a deletion, reverse complemented)
    at k = 0 (the census, against the CPU route), ``-K 1`` and ``-k 1``
    (timed: their marks must hold the plants and nest, k = 0 within ``-K
    1`` within ``-k 1``), then ``allvall_merge`` and ``allvall_dump`` on
    the bitmaps; ``merstream -m 20 -R -K 1 -b 50000 -r`` on a normalized
    2^18-base database (the census and the slot gate, against the CPU
    route);
17. nrdb over 2^18 synthetic proteins of 50 to 1,000 residues (5%
    duplicates, 5% contained), ``nrdb`` against the CPU route and ``nrdb
    -C`` timed (the duplicates and contained entries dropped, its
    sequences among nrdb's), the census launched, the device run split
    into load, scan, extension loop and output write; ``xmers -m 20 -R -k
    1 -b 50000`` at full batch width (100,000 patterns a batch; 2^18
    bases, cut from 2^20 to fit) against the CPU route, with phase 0,
    each batch's table build and gated scan timed, one upload of the
    database, no process left behind and the device memory back to its
    level before the run;
18. the 21 tool names that reach no scanner, each through ``python -m
    sequence_alignment_tools_tpu_torch <tool>`` in a process of its own on
    the CPU (up to 8 at once; the card is not used): extract_seq,
    kmer_count, kmer_annotate, polyrun and atac_seq on the phase-16
    corpus, chario on its first 2^16 bases; aacomp and aacomplookup,
    genome_simulation (twice, one seed), solid_simulation, pairscan
    ``-m 6``, the word-graph tools (build_graph, walk_graph ``-R -O``,
    cannon_csbh_graph, csbh_annotate, solid_assembly) and the RL stack
    (Indexer, IndexerAA, Xspace, XspaceLo, WordGraph) on small generated
    inputs; each exit status and one invariant a tool checked, each wall
    logged, no process loading jax, the JAX package or torch or
    initializing CUDA; walk_graph ``-O``'s min-cost flow against brute
    force on small graphs;
19. the mesh (``parallel/``): over ``make_mesh([cuda:0] * 4)`` the exact
    scan at 2^28, the k = 1 serving stream (the gated route per shard),
    ``-k 2`` on the Sellers configuration (``sellers.cu`` per shard) and
    the stream of 16 host blocks of 2^24 each equal their unsharded
    results, with each kernel launched at least once a shard, one upload
    a shard per database (none on a repeated run), and each wall beside
    the unsharded one; then two ranks (``--mesh-rank``, this script run
    as a worker, gloo on localhost, each on cuda:0) run the 2 x 2 node x
    GPU mesh at 2^24: ``sharded_scan_counts_2d`` and
    ``sharded_pallas_scan_hits_2d`` (also at cap 1) on both ranks equal
    the unsharded stream.  One card shows what sharding costs, not a
    speed-up;
20. the cold one-shot regime: bench.py's one-shot rows (its 16 M corpus
    and 10 primers, ``primer_match -r -c`` at k = 0, 1, 2,
    ``SAT_AUTO_ARTIFACTS=1``) through ``python -S sat_torch``, best of 2,
    with no torch imported and no CUDA initialized, bytes equal to the
    sited ``python -m`` run and to the host route in this process; the
    same rows with ``SAT_HOST_SCAN=0`` import torch mid-run, initialize
    CUDA and name their kernels (``scan_filter.cu``, ``seed_gate.cu``,
    ``myers.cu``) with the same bytes; then the floors (``python -S -c
    pass``, ``python -c pass``, ``sat_torch --help``, a site-less
    ``import torch`` and ``torch.cuda.init()``).

Every phase raises on a mismatch.  The line before the last is a JSON
object with each kernel's launches on its main path, error, times and
bound; the last line is ``{"ok": true, "device": {...}}``.  Needs a CUDA
device: without one it exits 1 and prints no result.
"""

import contextlib
import inspect
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20240601
# bench.py's headline primer set (its PATS), both strands: P = 20
PATS = [
    "AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
    "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "AAGAAAAGGGGGAAA",
    "TCATGAAGTAAAC", "TTGGCTGCTGCCCCCAG", "AGAAAAGGGGGAAA",
    "CTATTGATAAGGGAGTG",
]
TABLE = b"ACGT\n"
EOS = 4
MAIN_N = 1 << 28          # about one human chromosome, resident whole
BLOCK_N = 1 << 24         # the serving block and the kernel check size
ENTRY = 2_000_000         # bases per database entry, as bench.py's corpus
KEDIT_N = 1 << 22         # the k-edit kernel check size
BIG_N = 1 << 15           # the Sellers checks at P = 70,000 and k = 255
SELLERS_N = 1 << 26       # the Sellers-route configuration's database
XMERS_CLI_N = 1 << 18     # merstream through the CLI (phase 16)
# xmers at full batch width (phase 17): 2^20 bases took 244 s on the
# card and 231 s on the host route, past the 120 s the phase may take,
# so the database is halved twice (PERF.md section 4)
XMERS_FULL_N = 1 << 18
NRDB_ENTRIES = 1 << 18    # nrdb's proteins, Swiss-Prot's order (phase 17)
ALLVALL_QUERY_N = 1 << 16  # allvall's query against the 2^24 corpus
# 24 long primers (32 to 40 bases): the Myers kernel takes no field past
# 31 bases, so the filter engine takes the Sellers kernel for them
_LRNG = np.random.default_rng(SEED + 7)
LONG = ["".join("ACGT"[c] for c in _LRNG.integers(0, 4, size=ln))
        for ln in _LRNG.integers(32, 41, size=24)]
# the H100 SXM data sheet's peaks: HBM bytes/s, and the float32 rate
# outside the tensor cores, the sheet's entry nearest to the 32-bit
# integer work of these kernels
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f} s]", *a, flush=True)


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn()`` on the card (CUDA events), after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def timed(fn):
    """(result, milliseconds) of one call of ``fn()`` on the card (CUDA
    events, no warm-up)."""
    import torch

    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def bound(nbytes, ops):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``ops`` integer operations at its published peaks."""
    b_ms = nbytes / PEAK_BYTES * 1e3
    o_ms = ops / PEAK_OPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def edit(rng, s, kinds):
    """``s`` with one edit per entry of ``kinds`` ("sub", "del" or "ins")
    at random inner positions."""
    out = list(s)
    for kind in kinds:
        i = int(rng.integers(2, len(out) - 2))
        if kind == "sub":
            out[i] = "ACGT"[("ACGT".index(out[i]) + int(rng.integers(1, 4)))
                            % 4]
        elif kind == "del":
            del out[i]
        else:
            out.insert(i, "ACGT"[int(rng.integers(0, 4))])
    return "".join(out)


VARIANT_EDITS = (("sub",), ("del",), ("ins",), ("sub", "ins"))


def make_db(n, seed):
    """Random ACGT codes split into ENTRY-base entries by EOS (EOS first,
    as compress_seq lays a database out), primers and their reverse
    complements planted at known offsets, one ending at the array end.

    Inside the first 2^22 positions it also plants edit variants of each
    primer and its reverse complement (one substitution, deletion or
    insertion, and two edits), a variant on each side of the first entry
    boundary (next to EOS) and a primer split by the second boundary's
    EOS.  Returns (db, planted exact copies, variants), a variant being
    (start, primer strand, its text, number of edits)."""
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    eos_at = np.arange(0, n, ENTRY + 1)
    starts = eos_at + 1
    lengths = np.minimum(ENTRY, n - starts)
    planted = []
    for i, p in enumerate(PATS):
        for strand, s in enumerate((p, reverse_comp(p))):
            e = (2 * i + strand) % len(starts)
            at = int(starts[e]) + 1000 + 7919 * i
            planted.append((at, s))
    last = PATS[-1]
    planted.append((n - len(last), last))
    variants = []
    slot = 0
    for i, p in enumerate(PATS):
        for s in (p, reverse_comp(p)):
            for kinds in VARIANT_EDITS:
                at = int(starts[slot % 2]) + 100_000 + 23_017 * (slot // 2)
                variants.append((at, s, edit(rng, s, kinds), len(kinds)))
                slot += 1
    b1 = int(eos_at[1])
    v = edit(rng, PATS[0], ("sub",))
    variants.append((b1 - len(v), PATS[0], v, 1))
    v = edit(rng, reverse_comp(PATS[1]), ("del",))
    variants.append((b1 + 1, reverse_comp(PATS[1]), v, 1))
    split = (int(eos_at[2]) - 7, PATS[4], PATS[4], None)
    for at, s in planted:
        codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
    for at, _s, v, _e in variants + [split]:
        codes[at : at + len(v)] = [TABLE.index(c.encode()) for c in v]
    codes[eos_at] = EOS
    db = SeqDB(codes=codes, table=TABLE, entry_starts=starts,
               entry_lengths=lengths,
               headers=[f"chr{i} synthetic entry {i}" for i in
                        range(len(starts))])
    return db, planted, variants


def check_kernels(cases, dev):
    """Phase 2: kernel against plain on each case (name, codes, n, device
    tables[, the code read past n, EOS by default]); returns the largest
    absolute difference seen (0 when bit-identical)."""
    import torch

    from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
        scan_occupancy,
        scan_occupancy_ref,
    )

    worst = 0
    for name, codes_dev, n, dt, *eos in cases:
        eos = eos[0] if eos else EOS
        got = scan_occupancy(codes_dev, dt.weights16, dt.thresholds, n, eos)
        want = scan_occupancy_ref(codes_dev, dt.weights16, dt.thresholds, n,
                                  eos)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        worst = max(worst, err)
        log(f"kernel check {name}: n={n} P={dt.lengths.numel()} "
            f"occupied={int(want.sum())}/{want.numel()} max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError(f"scan_occupancy differs from plain: {name}")
    return worst


def random_pats(rng, count, lo, hi):
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
            for ln in rng.integers(lo, hi + 1, size=count)]


def iupac_db(n, seed):
    """An IUPAC database (15 codes: ACGT with 3% ambiguity codes) in two
    entries, and 8 degenerate primers drawn from it plus a heavy-wildcard
    one, for a -w scan."""
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB

    rng = np.random.default_rng(seed)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    base = rng.integers(0, 4, size=n)
    amb = rng.random(n) < 0.03
    base[amb] = rng.integers(4, 15, size=int(amb.sum()))
    seq = table[base].tobytes()
    db = SeqDB.from_entries([("w1", seq[: n // 2]), ("w2", seq[n // 2 :])])
    text = seq.decode()
    pats = [text[i : i + 14] for i in range(1000, n - 100, n // 8)]
    return db, pats + ["ACGRYTNNSWKT"]


def wide_db(n, seed):
    """A 41-code database (40 symbols: the amino acids, the other letters,
    digits and four marks; EOS) in two entries, and 12 patterns of 6 to 9
    symbols cut from it, every other one with a substitution."""
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYBJOUXZ0123456789*-+.",
                            np.uint8)
    seq = letters[rng.integers(0, len(letters), size=n)].tobytes()
    db = SeqDB.from_entries([("x1", seq[: n // 2]), ("x2", seq[n // 2 :])])
    text = seq.decode()
    pats = []
    for i, at in enumerate(rng.integers(0, n - 10, size=12)):
        p = list(text[at : at + 6 + i % 4])
        if i % 2:
            p[2] = chr(letters[int(rng.integers(0, len(letters)))])
        pats.append("".join(p))
    return db, pats


# An older commit's kernels, timed beside this checkout's when their
# sources (with the headers they include) have been unpacked into this
# git-ignored directory, e.g. 371464f's seed_gate and gate_slots:
#   mkdir -p build/parent_kernels && for f in seed_gate.cu gate_slots.cu \
#     gate.cuh scan_chunk.cuh slot_out.cuh; do git show \
#     371464f:sequence_alignment_tools_tpu_torch/ops/cuda/csrc/$f \
#     > build/parent_kernels/$f; done
# (fb4b3cd's myers.cu, e27d89a's sellers.cu, seed_slots.cu and 40b2571's
# scan_filter.cu, with their headers, are taken the same way)
PARENT_DIR = os.path.join("build", "parent_kernels")


def parent_kernels():
    """{name: fn} of the older commit's kernels built from ``PARENT_DIR``
    (empty for a plain checkout): ``scan_filter(codes, w, thr, n, eos)
    -> occ``, ``sellers(codes, n, st, eos, k, indels, cap) -> row`` (the
    byte-cell row DP with its own wrapper's segments),
    ``seed_slots(codes, n, mt, cap) -> row``, ``myers(codes, n, mt, eos,
    k, cap) -> row``, ``seed_gate(codes, n, dt, mb_count, mb_idx, gt,
    eos, indels, cap) -> row`` (371464f's bit-parallel form) and
    ``gate_slots(codes, n, slots, lengths, gt, indels, cap) -> row``
    (371464f's thread per slot), each present when its source is."""
    import ctypes

    import torch

    from sequence_alignment_tools_tpu_torch.ops.cuda.build import (
        NVCC_FLAGS,
        _nvcc,
    )

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    procs = {}
    for name in ("scan_filter", "sellers", "seed_slots", "myers", "seed_gate",
                 "gate_slots"):
        src = os.path.join(PARENT_DIR, name + ".cu")
        if os.path.exists(src):
            out = os.path.abspath(os.path.join(PARENT_DIR, f"lib{name}.so"))
            procs[name] = (out, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", out, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (out, proc) in procs.items():
        log_, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {name}.cu: {log_.decode()}")
        libs[name] = ctypes.CDLL(out)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    fns = {}
    if "scan_filter" in libs:
        ffn = libs["scan_filter"].sat_scan_occupancy
        ffn.restype = i32
        ffn.argtypes = [vp, i64, vp, vp, i32, i32, i32, i32, vp, i64, vp]

        def filt(codes, w, thr, n, eos):
            Lmax, alpha, P = w.shape
            nmb = -(-n // 32)
            occ = torch.empty(nmb, dtype=torch.bool, device=codes.device)
            rc = ffn(codes.data_ptr(), n, w.data_ptr(), thr.data_ptr(), Lmax,
                     alpha, P, eos, occ.data_ptr(), nmb, stream())
            if rc:
                raise RuntimeError(f"parent scan_filter: cudaError_t {rc}")
            return occ

        fns["scan_filter"] = filt
    if "sellers" in libs:
        slib = libs["sellers"]
        slib.sat_sellers_scratch.restype = i64
        slib.sat_sellers_scratch.argtypes = [i64, i32, i32, i32, i32]
        sfn = slib.sat_sellers_scan
        sfn.restype = i32
        sfn.argtypes = [vp, i64, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                        i32, i32, vp, i64, vp, i64, vp]

        def sel(codes, n, st, eos, k, indels, cap):
            halo = st.Lmax + k
            # its wrapper's segments: about 2^18 (segment, pattern)
            # threads, at least four halos and at most 8192 positions
            segc = int(min(max(n * st.P >> 18, 4 * halo, 64), 8192))
            nscr = slib.sat_sellers_scratch(n, st.P, st.Lmax, st.aw, segc)
            scratch = torch.empty(nscr, dtype=torch.uint8,
                                  device=codes.device)
            out = torch.zeros(1 + 3 * cap, dtype=torch.int32,
                              device=codes.device)
            rc = sfn(codes.data_ptr(), n, st.acc.data_ptr(),
                     st.lens.data_ptr(), st.P, st.Lmax, st.aw, st.alpha, eos,
                     k, int(indels), segc, halo, out.data_ptr(), cap,
                     scratch.data_ptr() if nscr else None, nscr, stream())
            if rc:
                raise RuntimeError(f"parent sellers: cudaError_t {rc}")
            return out

        fns["sellers"] = sel
    if "seed_slots" in libs:
        cfn = libs["seed_slots"].sat_seed_slots
        cfn.restype = i32
        cfn.argtypes = [vp, i64, i32, vp, i32, i32, vp, vp, vp, vp, vp, i64,
                        vp]

        def census(codes, n, mt, cap):
            out = torch.zeros(1 + 2 * cap, dtype=torch.int32,
                              device=codes.device)
            rc = cfn(codes.data_ptr(), n, mt.alpha, mt.cls.data_ptr(),
                     len(mt.lens), mt.Lmax, mt.keys.data_ptr(),
                     mt.head.data_ptr(), mt.enext.data_ptr(),
                     mt.epid.data_ptr(), out.data_ptr(), cap, stream())
            if rc:
                raise RuntimeError(f"parent seed_slots: cudaError_t {rc}")
            return out

        fns["seed_slots"] = census
    if "myers" in libs:
        mfn = libs["myers"].sat_myers_pairs
        mfn.restype = i32
        mfn.argtypes = [vp, i64, vp, ctypes.POINTER(ctypes.c_int32), i32,
                        i32, i32, i32, i32, vp, i64, vp]

        def myers(codes, n, mt, eos, k, cap):
            from sequence_alignment_tools_tpu_torch.ops.cuda.myers import (
                myers_segc,
            )

            if len(mt.groups) != 1:
                raise ValueError("parent myers takes one group of words")
            halo = mt.Lmax + k
            words = np.ascontiguousarray(mt.words_np, np.int32)
            out = torch.zeros(1 + 2 * cap, dtype=torch.int32,
                              device=codes.device)
            rc = mfn(codes.data_ptr(), n, mt.groups[0].data_ptr(),
                     words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                     mt.nw, eos, k, myers_segc(n, halo), halo,
                     out.data_ptr(), cap, stream())
            if rc:
                raise RuntimeError(f"parent myers: cudaError_t {rc}")
            return out

        fns["myers"] = myers
    if "seed_gate" in libs:
        gfn = libs["seed_gate"].sat_seed_gate
        gfn.restype = i32
        gfn.argtypes = [vp, i64, i32, vp, i32, vp, vp, i32, i32, vp, vp, i32,
                        vp, i32, vp, vp, i64, vp, vp, vp, i32, i32, i32, i32,
                        vp, i64, vp]

        def sgate(codes, n, dt, mb_count, mb_idx, gt, eos, indels, cap):
            from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel \
                import filter_tables

            ft = filter_tables(dt.weights16, dt.thresholds)
            out = torch.zeros(1 + 2 * cap, dtype=torch.int32,
                              device=codes.device)
            rc = gfn(codes.data_ptr(), n, eos, ft.bits.data_ptr(), ft.R,
                     ft.ent.data_ptr(), ft.pat.data_ptr(), ft.P, ft.J,
                     ft.cls_off.data_ptr(), ft.cls_rows.data_ptr(),
                     int(ft.direct), dt.lengths.data_ptr(),
                     dt.weights16.shape[0], mb_count.data_ptr(),
                     mb_idx.data_ptr(), mb_idx.numel(), gt.bits.data_ptr(),
                     gt.glen.data_ptr(), gt.gdir.data_ptr(), gt.Lg, gt.k,
                     gt.band, int(indels), out.data_ptr(), cap, stream())
            if rc:
                raise RuntimeError(f"parent seed_gate: cudaError_t {rc}")
            return out

        fns["seed_gate"] = sgate
    if "gate_slots" in libs:
        sfn2 = libs["gate_slots"].sat_gate_slots
        sfn2.restype = i32
        sfn2.argtypes = [vp, i64, vp, i64, vp, vp, vp, vp, i32, i32, i32,
                         i32, vp, i64, vp]

        def gslots(codes, n, slots, lengths, gt, indels, cap):
            out = torch.zeros(1 + 2 * cap, dtype=torch.int32,
                              device=codes.device)
            rc = sfn2(codes.data_ptr(), n, slots.data_ptr(),
                      (slots.numel() - 1) // 2, lengths.data_ptr(),
                      gt.bits.data_ptr(), gt.glen.data_ptr(),
                      gt.gdir.data_ptr(), gt.Lg, gt.k, gt.band, int(indels),
                      out.data_ptr(), cap, stream())
            if rc:
                raise RuntimeError(f"parent gate_slots: cudaError_t {rc}")
            return out

        fns["gate_slots"] = gslots
    return fns


def beside_parent(label, new, old, reps, smi):
    """Time ``new()`` and ``old()`` in turns (parent, new, new, parent;
    CUDA events, median of ``reps``), log the line and return (new ms,
    parent ms), the means of the two calls each."""
    p1 = cuda_ms(old, reps=reps)
    n1 = cuda_ms(new, reps=reps)
    n2 = cuda_ms(new, reps=reps)
    p2 = cuda_ms(old, reps=reps)
    log(f"{label} on {smi}: this kernel {n1:.4f}, {n2:.4f} ms; older "
        f"kernel {p1:.4f}, {p2:.4f} ms (CUDA events, median; parent, new, "
        f"new, parent)")
    return (n1 + n2) / 2, (p1 + p2) / 2


def device_route_vs_host(name, tables, codes, dev):
    """One scan through the port's device route (host rung off) against
    the native host shift-and; fails unless the filter kernel ran."""
    from sequence_alignment_tools_tpu_torch.ops.host_scan import HostShiftAnd
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner

    host = HostShiftAnd(tables, 0, False)
    if not host.available():
        raise RuntimeError(f"{name}: native shift-and unavailable")
    want = list(host.scan(codes))
    sc = ConvScanner(tables, k=0, device=dev)
    sc.use_host = False
    ran = Launches()
    got = list(sc.scan(codes))
    launches = ran["scan_occupancy"]
    if launches < 1:
        raise AssertionError(f"{name}: the device route never launched "
                             "scan_occupancy")
    if got != want or not want:
        raise AssertionError(f"{name}: device route differs from host "
                             f"shift-and ({len(got)} vs {len(want)} hits)")
    log(f"device route {name}: n={len(codes)} P={tables.P} "
        f"Lmax={tables.Lmax} alpha={tables.alpha}: {len(got)} hits == "
        f"host shift-and, scan_occupancy launches {launches}")


def device_rows(prof, reps=1):
    """A profile's rows with device time, as (ms per rep, launches per
    rep, key, ms each) largest first, and the device ms per rep of its
    kernels and copies (the aten:: rows repeat the device time of the
    kernels they launch)."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3 / reps, ev.count / reps, ev.key,
                         us / 1e3 / ev.count))
    rows.sort(reverse=True)
    dev_ms = sum(ms for ms, _, key, _ in rows
                 if not key.startswith("aten::")
                 and key != "Activity Buffer Request")
    return rows, dev_ms


def profile(label, fn, reps):
    """Print ``fn``'s device self time per kernel under torch.profiler
    (``reps`` calls), with the host wall time."""
    fn()
    _out, wall, prof, _t0 = device_busy(
        lambda: [fn() for _ in range(reps)])
    wall *= 1e3
    rows, dev_ms = device_rows(prof, reps)
    log(f"== profile {label}: {reps} reps, wall {wall / reps:.3f} ms/rep, "
        f"device time {dev_ms:.3f} ms/rep (kernels and copies, "
        f"{100 * dev_ms * reps / wall:.1f}% of wall)")
    # a count below 1 per rep means the profiler dropped launches of that
    # window: the time per launch it did record stands beside the sum
    for ms, count, key, each in rows[:14]:
        log(f"   {ms:10.4f} ms/rep  x{count:6.1f}  ({each:.4f} ms each)  "
            f"{key[:80]}")


def survivor_set(row, cap):
    """(true count, anchors, sids) of a ``[count, anchors (cap), sids
    (cap)]`` row, the kept pairs sorted by (anchor, sid)."""
    row = row.cpu().numpy().astype(np.int64)
    m = min(int(row[0]), cap)
    a, s = row[1 : 1 + m], row[1 + cap : 1 + cap + m]
    o = np.lexsort((s, a))
    return int(row[0]), a[o], s[o]


def gate_setup(db, pats, k, indels, dev, node=0, tplen=0, rev_comp=True):
    """(engine, seed DeviceTables, GateTables on the card) of the port's
    pigeonhole engine for ``pats`` over ``db``."""
    from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
    from sequence_alignment_tools_tpu_torch.models.primer_match import (
        PrimerMatchModel,
    )

    ps = build_pattern_set(pats, rev_comp=rev_comp, tplen=tplen)
    m = PrimerMatchModel(db, ps, k=k, indels=indels, node=node, device=dev)
    if m.engine == "halves":
        _o, sc, _b, dirs, ext, geomB = m._halves_ctx()
    else:
        _o, _s, sc, _b, dirs, ext, geomB = m._bases_ctx()
    gate = m._engine_gate(sc, dirs, ext, geomB, lambda p0: p0 + 1)
    return m.engine, sc._tables_dev(), sc._gate_dev(gate)


def check_seed_gate(cases):
    """Phase 6: ``seed_gate`` on the card against ``seed_gate_ref`` on the
    card, on the seed filter's candidate microblocks; the survivor sets
    must be equal (with a cap below the count: the true counts equal and
    the kept survivors among the plain ones).  Returns the largest
    difference seen: count difference plus survivors in one set only."""
    import torch

    from sequence_alignment_tools_tpu_torch.ops.compact import compact_mask
    from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
        scan_occupancy,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.seed_gate import (
        seed_gate,
        seed_gate_ref,
    )

    worst = 0
    full = 1 << 20
    for name, codes_dev, n, dt, gt, indels, cap_mb, cap in cases:
        occ = scan_occupancy(codes_dev, dt.weights16, dt.thresholds, n, EOS)
        mb_count, mb_idx = compact_mask(occ, cap_mb)
        got = seed_gate(codes_dev, n, dt, mb_count, mb_idx, gt, EOS, indels,
                        cap)
        want = seed_gate_ref(codes_dev, n, dt, mb_count, mb_idx, gt, EOS,
                             indels, full)
        torch.cuda.synchronize()
        gc, ga, gs = survivor_set(got, cap)
        wc, wa, ws = survivor_set(want, full)
        wset = set(zip(wa.tolist(), ws.tolist()))
        gset = set(zip(ga.tolist(), gs.tolist()))
        if cap >= wc:
            err = abs(gc - wc) + len(wset ^ gset)
        else:
            err = abs(gc - wc) + len(gset - wset)
        worst = max(worst, err)
        log(f"seed_gate check {name}: n={n} seeds={dt.lengths.numel()} "
            f"Lg={gt.Lg} band={gt.band} candidate microblocks="
            f"{int(mb_count)} (cap {cap_mb}) survivors={wc} (cap {cap}) "
            f"err={err}")
        if err or wc == 0:
            raise AssertionError(f"seed_gate differs from plain: {name}")
    return worst


def write_bench_corpus(path, entries=8, entry_len=ENTRY):
    """bench.py's 16 M-base corpus layout (8 entries of 2,000,000 random
    bases, 70-character lines, seed 42), with each primer planted once
    exact and its reverse complement once with one substitution (the long
    primers: two edits), at offsets scaled to ``entry_len``.  Returns the
    first entry's sequence."""
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    rng = np.random.default_rng(42)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    unit = entry_len // 200  # 10,000 bases at bench.py's entry length
    first = None
    with open(path, "w") as f:
        for e in range(entries):
            f.write(f">bench{e} synthetic benchmark entry {e}\n")
            seq = acgt[rng.integers(0, 4, size=entry_len)]
            for i in range(e, len(PATS), entries):
                for at, v in ((40 * unit + 9_973 * i * unit // 10_000,
                               PATS[i]),
                              (120 * unit + 9_973 * i * unit // 10_000,
                               edit(rng, reverse_comp(PATS[i]), ("sub",)))):
                    seq[at : at + len(v)] = np.frombuffer(v.encode(),
                                                          np.uint8)
            for i in range(e, len(LONG), entries):
                for at, v in ((60 * unit + 9_973 * i * unit // 10_000,
                               LONG[i]),
                              (160 * unit + 9_973 * i * unit // 10_000,
                               edit(rng, reverse_comp(LONG[i]),
                                    ("sub", "ins")))):
                    seq[at : at + len(v)] = np.frombuffer(v.encode(),
                                                          np.uint8)
            s = seq.tobytes().decode()
            first = first or s
            for i in range(0, entry_len, 70):
                f.write(s[i : i + 70] + "\n")
    return first


def row_set(row, cap, width):
    """(true count, set of kept tuples) of a ``[count, col 0 (cap), ...,
    col width-1 (cap)]`` row."""
    row = row.cpu().numpy().astype(np.int64)
    m = min(int(row[0]), cap)
    cols = [row[1 + i * cap : 1 + i * cap + m].tolist()
            for i in range(width)]
    return int(row[0]), set(zip(*cols))


def blocked_panel_phase(db, main_dev, smi, dev):
    """Phase 8c: a panel shaped like primer_grch38.k2_panel's (48 primers
    of 18 to 27 bases, both strands: 96 Myers words, 3 groups of 32) over
    a blocked scan of the resident 2^28 copy ``main_dev``, the block
    lowered to 2^26: one ``myers_pairs`` launch a group a block, the
    multi-group launch on a view past a seam equal to ``myers_pairs_ref``,
    the blocked pairs equal to one scan's; then that route (Myers, a
    launch per group) against the one it replaced for more than 32 words
    (Sellers, one launch) over the whole 2^28."""
    from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
    from sequence_alignment_tools_tpu_torch.ops.cuda.myers import (
        myers_pairs,
        myers_pairs_ref,
    )
    from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
    from sequence_alignment_tools_tpu_torch.utils import trace

    codes = db.codes
    pr = np.random.default_rng(SEED + 9)
    seams = range(1 << 26, MAIN_N, 1 << 26)
    # a site ending just past each seam (its block's halo holds its start)
    # and one ending just before it (in the next block's halo, so the
    # block before must keep it), then sites anywhere
    sites = [(at + d, int(pr.integers(18, 28))) for at in seams
             for d in (3, -2)]
    panel = []
    while len(panel) < 48:
        end, ln = sites.pop(0) if sites else (
            int(pr.integers(32, MAIN_N)), int(pr.integers(18, 28)))
        if (codes[end - ln : end] < 4).all():
            panel.append("".join("ACGT"[c] for c in codes[end - ln : end]))
    pt = build_tables(build_pattern_set(panel, rev_comp=True), db, wc=False,
                      textn=False)
    sc_one = SellersScanner(pt, k=2, indels=True, device=dev)
    sc_blk = SellersScanner(pt, k=2, indels=True, device=dev)
    sc_blk._KEDIT_BLOCK = 1 << 26
    if not sc_blk.myers_available(MAIN_N):
        raise AssertionError("the panel did not take the Myers route")
    mtp = sc_blk._myers_t()
    ngroups = len(mtp.groups)
    if ngroups != 3 or mtp.nw != 96:
        raise AssertionError(f"panel: {mtp.nw} words in {ngroups} groups")
    blocks = sc_blk._blocks(MAIN_N)
    ran = Launches()
    nb0 = trace.total("scan.blocks")
    ends_b, pids_b = sc_blk.scan_pairs(codes)
    if ran["myers_pairs"] != ngroups * len(blocks) \
            or trace.total("scan.blocks") - nb0 != len(blocks):
        raise AssertionError(f"blocked panel scan: {ran['myers_pairs']} "
                             f"launches over {len(blocks)} blocks")
    ends_1, pids_1 = sc_one.scan_pairs(codes)
    if not len(ends_1) or sorted(zip(ends_b.tolist(), pids_b.tolist())) \
            != sorted(zip(ends_1.tolist(), pids_1.tolist())):
        raise AssertionError(f"blocked panel scan differs from one scan: "
                             f"{len(ends_b)} vs {len(ends_1)} pairs")
    view, lo, hi = blocks[1]
    seam = main_dev[view:hi]
    cap_p = sc_blk._cap("myers", hi - view)
    ran = Launches()
    p_row = myers_pairs(seam, hi - view, mtp, EOS, 2, cap_p)
    if ran["myers_pairs"] != ngroups:
        raise AssertionError(f"myers_pairs: {ran['myers_pairs']} launches "
                             f"for {ngroups} groups")
    p_ref, p_plain = timed(lambda: myers_pairs_ref(seam, hi - view, mtp,
                                                   EOS, 2, cap_p))
    if row_set(p_row, cap_p, 2) != row_set(p_ref, cap_p, 2):
        raise AssertionError("myers_pairs differs from plain on the panel "
                             "past a seam")
    for at in seams:
        if not ((ends_b >= at - 2) & (ends_b <= at + 3)).any():
            raise AssertionError(f"no candidate at the seam {at}")
    log(f"panel of {len(panel)} primers ({mtp.nw} words, {ngroups} "
        f"groups), k=2, 2^28 in {len(blocks)} blocks of 2^26: "
        f"{len(ends_b)} pairs == one scan, sites at each seam found; "
        f"myers_pairs on the view "
        f"[{view}, {hi}) == plain ({int(p_row[0])} pairs, plain "
        f"{p_plain:.4f} ms), {ngroups} launches")
    # this route against Sellers over the whole 2^28
    for npat in (34, 64, 96):
        sub_t = build_tables(build_pattern_set(panel[: npat // 2],
                                               rev_comp=True), db,
                             wc=False, textn=False)
        scx = SellersScanner(sub_t, k=2, indels=True, device=dev)
        cap_x = max(scx._cap("myers", MAIN_N), 1 << 20)
        my_set = row_set(scx._dispatch("myers", main_dev, MAIN_N, cap_x),
                         cap_x, 2)
        sel_n, sel_set = row_set(scx._dispatch("sellers", main_dev, MAIN_N,
                                               cap_x), cap_x, 3)
        if my_set != (sel_n, {(p, q) for p, q, _d in sel_set}):
            raise AssertionError(f"Myers and Sellers differ at P={npat}")
        my_t = cuda_ms(lambda: scx._dispatch("myers", main_dev, MAIN_N,
                                             cap_x), reps=5)
        sel_t = cuda_ms(lambda: scx._dispatch("sellers", main_dev, MAIN_N,
                                              cap_x), reps=5)
        log(f"panel route at n=2^28, P={npat} ({scx._myers_t().nw} words), "
            f"k=2 on {smi}: Myers {my_t:.4f} ms "
            f"({len(scx._myers_t().groups)} launches), Sellers "
            f"{sel_t:.4f} ms (CUDA events, median; equal pairs)")


def check_kedit(cases):
    """Phase 8: each k-edit kernel on the card against its plain version
    on the card; the kept tuple sets must be equal (with a cap below the
    count: the true counts equal and the kept tuples among the plain
    ones).  Returns the largest difference seen per kernel: count
    difference plus tuples in one set only."""
    import torch

    from sequence_alignment_tools_tpu_torch.ops.cuda.myers import (
        myers_pairs,
        myers_pairs_ref,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.sellers import (
        sellers_ref,
        sellers_scan,
    )

    worst = {"myers_pairs": 0, "sellers_scan": 0}
    full = 1 << 21
    for name, kind, codes_dev, n, tabs, eos, k, indels, cap in cases:
        if kind == "myers_pairs":
            got = myers_pairs(codes_dev, n, tabs, eos, k, cap)
            want = myers_pairs_ref(codes_dev, n, tabs, eos, k, full)
            width = 2
        else:
            got = sellers_scan(codes_dev, n, tabs, eos, k, indels, cap)
            want = sellers_ref(codes_dev, n, tabs, eos, k, indels, full)
            width = 3
        torch.cuda.synchronize()
        gc, gset = row_set(got, cap, width)
        wc, wset = row_set(want, full, width)
        if cap >= wc:
            err = abs(gc - wc) + len(wset ^ gset)
        else:
            err = abs(gc - wc) + len(gset - wset)
        worst[kind] = max(worst[kind], err)
        log(f"{kind} check {name}: n={n} k={k} hits={wc} (cap {cap}) "
            f"err={err}")
        if err or wc == 0:
            raise AssertionError(f"{kind} differs from plain: {name}")
    return worst


def native_groups(tables, bits, scan):
    """``scan(sub, idx)`` over consecutive groups of the patterns of
    ``tables`` whose lengths sum to at most ``bits`` (each group fits one
    native machine; ``sub`` its tables, ``idx`` its pattern indices), on
    8 threads (the native calls release the GIL); the results in group
    order."""
    from concurrent.futures import ThreadPoolExecutor

    from sequence_alignment_tools_tpu_torch.ops.tables import PatternTables

    groups, cur, used = [], [], 0
    for p in range(tables.P):
        ln = int(tables.lengths[p])
        if cur and used + ln > bits:
            groups.append(np.asarray(cur))
            cur, used = [], 0
        cur.append(p)
        used += ln
    if cur:
        groups.append(np.asarray(cur))

    def one(idx):
        sub = PatternTables(match=tables.match[idx],
                            lengths=tables.lengths[idx],
                            pat_codes=tables.pat_codes[idx],
                            Lmax=tables.Lmax, alpha=tables.alpha,
                            eos_code=tables.eos_code,
                            code_chars=tables.code_chars)
        return scan(sub, idx)

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, groups))


def split_host_pairs(tables, k, codes):
    """The native Sellers rows (``HostSellers``) over groups of patterns
    that each fit the native machine (at most 24 x 64 pattern bits), the
    candidate sets merged: the host route for a pattern set too wide for
    one machine.  Returns (ends, pids, distances) like
    ``HostSellers.pairs``."""
    from sequence_alignment_tools_tpu_torch.ops.host_scan import HostSellers

    def one(sub, idx):
        hs = HostSellers(sub, k)
        if not hs.available():
            raise RuntimeError("native Sellers rows unavailable")
        e, pl, d = hs.pairs(np.asarray(codes))
        return e, idx[pl], d

    ends, pids, dists = zip(*native_groups(tables, 24 * 64, one))
    return (np.concatenate(ends), np.concatenate(pids).astype(np.int64),
            np.concatenate(dists))


@contextlib.contextmanager
def split_host_route():
    """The filter engine's host route through :func:`split_host_pairs`
    for the scans the CLI's host run makes."""
    from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner

    saved = (SellersScanner._host_eligible, SellersScanner.host_pairs)
    SellersScanner._host_eligible = lambda self, n: True
    SellersScanner.host_pairs = lambda self, codes: split_host_pairs(
        self.tables, self.k, codes)[:2]
    try:
        yield
    finally:
        SellersScanner._host_eligible, SellersScanner.host_pairs = saved


def plant_variants(codes, pats, starts, rng, offset):
    """Plant each of ``pats`` and its reverse complement exact, with one
    edit and with two edits, spread over the entries; returns the
    planted (start, primer strand, text, edits)."""
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    out = []
    slot = 0
    for p in pats:
        for s in (p, reverse_comp(p)):
            for kinds in ((), ("sub",), ("del",), ("sub", "ins")):
                v = edit(rng, s, kinds) if kinds else s
                e = slot % (len(starts) - 1)
                at = int(starts[e]) + offset + 13_331 * (slot // 8)
                codes[at : at + len(v)] = [TABLE.index(c.encode())
                                           for c in v]
                out.append((at, s, v, len(kinds)))
                slot += 1
    return out


def draw_patterns(codes, count, length):
    """``count`` literal ``length``-mers drawn from ``codes`` at equal
    steps, as bench.py's 50,000-pattern rows draw theirs: a window that
    holds an EOS gives way to the ``length`` characters after it."""
    step = (len(codes) - length) // count
    idx = (np.arange(count, dtype=np.int64) * step)[:, None] \
        + np.arange(2 * length)[None, :]
    win = codes[idx]
    table = np.frombuffer(TABLE, np.uint8)
    clean = (win[:, :length] < 4).all(axis=1)
    rows = np.where(clean[:, None], win[:, :length], win[:, length:])
    if not (rows < 4).all():
        raise AssertionError("a drawn pattern holds an EOS")
    return [r.tobytes().decode() for r in table[rows]]


def forward_peptides(tdb, count, length=9):
    """``count`` peptides of ``length`` residues read out of the forward
    frames of the translation ``tdb`` at equal steps, each the first
    window at or past its step that holds no stop, EOS or X."""
    aa = tdb.aa_db
    end = int(tdb.frame_end_pos[2])
    out = []
    for i in range(count):
        at = i * (end // count) + 1_000
        while True:
            p = aa.decode(at, at + length)
            if p.isalpha() and "X" not in p:
                break
            at += length
        out.append(p)
    return out


def wide_corpus_db():
    """bench.py's wide-alphabet corpus (make_wide_corpus): 4 entries of
    4,000,000 symbols, ACGT with 2% of the 11 IUPAC ambiguity codes, seed
    43."""
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB

    rng = np.random.default_rng(43)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    entries = []
    for e in range(4):
        base = rng.integers(0, 4, size=4_000_000)
        amb = rng.random(4_000_000) < 0.02
        base[amb] = rng.integers(4, 15, size=int(amb.sum()))
        entries.append((f"wide{e} wide-alphabet benchmark entry {e}",
                        table[base].tobytes()))
    return SeqDB.from_entries(entries)


def literal_pattern_set(pats):
    """Forward-only pattern set without constraints (bench.py:390-394)."""
    from sequence_alignment_tools_tpu_torch.io.patterns import PatternSet

    ps = PatternSet()
    ps.patterns = [""] + list(pats)
    ps.esb = [0] * (len(pats) + 1)
    ps.eeb = [0] * (len(pats) + 1)
    ps.n_forward = len(pats)
    return ps


def prefix_db(db, n):
    """The first ``n`` positions of ``db`` as a database of its own."""
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB

    keep = db.entry_starts < n
    starts = db.entry_starts[keep]
    return SeqDB(codes=db.codes[:n].copy(), table=TABLE, entry_starts=starts,
                 entry_lengths=np.minimum(db.entry_lengths[keep], n - starts),
                 headers=list(db.headers[: int(keep.sum())]))


def grouped_host_scan(tables, codes, k=0, poison=False):
    """The native shift-and (exact, or k mismatches with EOS poisoned as
    ``poison``) over groups of patterns that each fit its 4,096 state
    bits, merged to (window start, pattern) order: the host reference for
    a pattern set too wide for one machine.  Returns [(end, pattern,
    mismatches)]."""
    from sequence_alignment_tools_tpu_torch.ops.host_scan import HostShiftAnd

    def one(sub, idx):
        host = HostShiftAnd(sub, k, poison)
        if not host.available():
            raise RuntimeError("native shift-and unavailable")
        return [(e - int(sub.lengths[q]), int(idx[q]), e, m)
                for e, q, m in host.scan(codes)]

    out = sorted(h for part in native_groups(tables, 4096, one)
                 for h in part)
    return [(e, q, m) for _s, q, e, m in out]


def row_keys(row, cap):
    """(true count, sorted int64 keys ``column 0 << 20 | column 1``) of
    the kept entries of a ``[count, col (cap), col (cap)]`` row (seed ids
    stay below 2^20)."""
    count = int(row[0])
    m = min(count, cap)
    a = row[1 : 1 + m].cpu().numpy().astype(np.int64)
    b = row[1 + cap : 1 + cap + m].cpu().numpy().astype(np.int64)
    return count, np.sort((a << 20) | b)


def check_slots(name, got, want, cap, full):
    """Kernel row against plain row (``[count, col (cap), col (cap)]``):
    equal sets, or with a cap below the count equal true counts and the
    kept entries among the plain ones.  Returns the difference: count
    difference plus entries in one set only."""
    gc, gkeys = row_keys(got, cap)
    wc, wkeys = row_keys(want, full)
    if cap >= wc:
        # both are sorted and free of duplicates: equal sets are equal arrays
        err = abs(gc - wc) + (0 if np.array_equal(gkeys, wkeys) else len(
            np.setxor1d(gkeys, wkeys, assume_unique=True)))
    else:
        err = abs(gc - wc) + int((~np.isin(gkeys, wkeys)).sum())
    log(f"{name}: entries={wc} (cap {cap}) err={err}")
    if err or wc == 0:
        raise AssertionError(f"{name}: kernel differs from plain")
    return err


# ---------------------------------------------------------------------------
# phases 16 and 17: the tools of the scanners' paths through the CLI

KERNEL_NAMES = ("scan_occupancy", "seed_gate", "myers_pairs", "sellers_scan",
                "scan_slots", "gate_slots")


KERNEL_WRAPPERS = ("scan_occupancy", "seed_gate", "myers_pairs",
                   "sellers_scan", "scan_slots", "gate_slots")


class Launches:
    """The six kernels' launches (the ``launch.<wrapper>`` counters of
    the port's ``utils/trace``) since this was made: ``n["seed_gate"]``,
    or every one by ``n.all()``."""

    def __init__(self):
        from sequence_alignment_tools_tpu_torch.utils import trace

        self.trace = trace
        self.base = {k: trace.total("launch." + k) for k in KERNEL_WRAPPERS}

    def __getitem__(self, name):
        return self.trace.total("launch." + name) - self.base[name]

    def all(self):
        return {k: self[k] for k in KERNEL_WRAPPERS}


def run_tool(tool, argv, out=None):
    """The port's ``tool`` run in-process through its dispatcher's entry
    point: its standard output, or the bytes of its ``-o`` file ``out``
    (removed first: allvall resumes from an existing bitmap)."""
    import importlib

    from sequence_alignment_tools_tpu_torch.__main__ import _TOOLS

    mod_name, fn_name = _TOOLS[tool]
    fn = getattr(importlib.import_module(
        "sequence_alignment_tools_tpu_torch.apps." + mod_name), fn_name)
    if out and os.path.exists(out):
        os.unlink(out)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv))
    if rc:
        raise AssertionError(f"{tool} {argv}: exit status {rc}")
    if out:
        with open(out, "rb") as f:
            return f.read()
    return buf.getvalue().encode("latin-1")


def _conv_groups(self, codes):
    yield from grouped_host_scan(self.tables, codes, self.k, self.poison_eos)


def _sellers_groups(self, codes):
    ends, pids, dists = split_host_pairs(self.tables, self.k, codes)
    for i in np.lexsort((pids, ends)):
        yield int(ends[i]), int(pids[i]), int(dists[i])


@contextlib.contextmanager
def host_route(kind):
    """The reference route of a device run: ``cpu`` runs the tool on the
    CPU with the host machines on (native shift-and, native census with
    its inline gate, native extension); ``sellers`` pins the k-edit
    scanners to the native Sellers rows; ``groups`` runs it on the CPU
    with every ``ConvScanner.scan`` and ``SellersScanner.scan`` through
    the native machines over pattern groups (:func:`grouped_host_scan`,
    :func:`split_host_pairs`), for pattern sets too wide for one
    machine."""
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
    from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner

    saved = os.environ.pop("SAT_DEVICE", None)
    os.environ.pop("SAT_HOST_SCAN", None)
    scans = (ConvScanner.scan, SellersScanner.scan)
    if kind in ("cpu", "groups"):
        os.environ["SAT_DEVICE"] = "cpu"
    if kind == "sellers":
        SellersScanner.use_host = True
    elif kind == "groups":
        ConvScanner.scan, SellersScanner.scan = _conv_groups, _sellers_groups
    try:
        yield
    finally:
        SellersScanner.use_host = None
        ConvScanner.scan, SellersScanner.scan = scans
        os.environ.pop("SAT_DEVICE", None)
        if saved is not None:
            os.environ["SAT_DEVICE"] = saved


def device_vs_host(label, tool, argv, need, host, out=None):
    """One run of the port's CLI through its device route
    (``SAT_HOST_SCAN=0``, under :func:`device_busy`) against one through
    the reference route ``host`` of :func:`host_route`: the same bytes,
    and every kernel in ``need`` launched.  With ``host`` None the device
    run is only timed (its callers check its output otherwise).  Returns
    {out, launches, t0 (the device run's start), wall (s), device_ms,
    host_s}."""
    os.environ["SAT_HOST_SCAN"] = "0"
    ran = Launches()
    try:
        got, wall, prof, t_dev0 = device_busy(
            lambda: run_tool(tool, argv, out))
    finally:
        del os.environ["SAT_HOST_SCAN"]
    launches = ran.all()
    dev_ms = device_rows(prof)[1]
    missing = [name for name in need if launches[name] < 1]
    if missing:
        raise AssertionError(f"{label}: the device run launched no "
                             f"{missing}: {launches}")
    s_host = None
    if host is not None:
        t0 = time.perf_counter()
        with host_route(host):
            want = run_tool(tool, argv, out)
        s_host = time.perf_counter() - t0
        if got != want or not got:
            raise AssertionError(f"{label}: device and host outputs differ "
                                 f"({len(got)} against {len(want)} bytes)")
    elif not got:
        raise AssertionError(f"{label}: no output")
    lines = got.count(b"\n")
    ref = (f"device == host ({host} route), host run {s_host:.3f} s"
           if host is not None else "device run only (timing)")
    log(f"{label}: {len(got)} bytes, {lines} lines, {ref}; device run "
        f"{wall:.3f} s, device time {dev_ms:.3f} ms "
        f"({100 * dev_ms / 1e3 / wall:.2f}% of wall); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return {"out": got, "launches": launches, "t0": t_dev0, "wall": wall,
            "device_ms": dev_ms, "host_s": s_host}


@contextlib.contextmanager
def spans(*targets):
    """Host-clock seconds of every call of each ``(owner, method name)``,
    collected as {name: [seconds per call]} while the block runs."""
    took = {name: [] for _owner, name in targets}
    saved = []
    for owner, name in targets:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))

        def timed_call(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                took[_name].append(time.perf_counter() - t0)

        setattr(owner, name, timed_call)
    try:
        yield took
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def device_busy(fn):
    """(result, wall s, profile, start) of ``fn()`` under
    ``torch.profiler`` (:func:`device_rows` reads the device time off the
    profile), and the host clock at its start."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    # keep every event of the window (without it, torch may drop the
    # events of earlier cycles from key_averages)
    keep = ({"acc_events": True}
            if "acc_events" in inspect.signature(tprofile).parameters
            else {})
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA], **keep) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, prof, t0


def write_fasta(path, entries, width=60):
    """``entries`` [(header, sequence bytes)] as FASTA, ``width`` a line."""
    with open(path, "wb") as f:
        for head, seq in entries:
            f.write(b">" + head.encode() + b"\n")
            f.write(b"\n".join(seq[i:i + width]
                               for i in range(0, len(seq), width)))
            f.write(b"\n")


def random_dna(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()


def normalized_dna_db(path, n, seed):
    """A normalized database (``compress_seq -n true``) of ``n`` random
    bases in 4 entries, with 200 segments of 60 bases copied once more,
    exact or with one substitution (near-repeats for xmers' inexact
    phases)."""
    from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
        main as compress_seq,
    )

    rng = np.random.default_rng(seed)
    seq = bytearray(random_dna(rng, n))
    for i in range(200):
        src, dst = rng.integers(0, n - 60, 2)
        seg = bytearray(seq[src:src + 60])
        if i % 2:
            seg[30] = b"ACGT"[(b"ACGT".index(seg[30]) + 1) % 4]
        seq[dst:dst + 60] = seg
    q = n // 4
    write_fasta(path, [(f"x{e} synthetic entry {e}",
                        bytes(seq[e * q:(e + 1) * q])) for e in range(4)],
                width=70)
    if compress_seq(["-i", path, "-n", "true"]):
        raise RuntimeError("compress_seq failed")


def cli_tools_phase(tmp, fasta, pfile, lfile, entry0, smi):
    """Phase 16: exact_match, tandem_match, inexact_match, allvall (with
    allvall_merge and allvall_dump) and merstream through the port's CLI,
    device route against host route."""
    from sequence_alignment_tools_tpu_torch.apps.allvall import read_bitmap
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    runs = {}
    need_f = ["scan_occupancy"]
    for flags in (["-r"], ["-r", "-q"], ["-k"]):
        r = device_vs_host(
            f"CLI exact_match {' '.join(flags)}", "exact_match",
            ["-i", fasta, "-P", pfile] + flags, need_f, "cpu")
        runs["exact_match " + " ".join(flags)] = r
        if r["out"].count(b"\n") < len(PATS):
            raise AssertionError("exact_match missed planted primers")
    # tandem arrays planted in the corpus' first entry, forward and
    # reverse strand: microsatellites (short motifs, dense hits: the
    # census) and minisatellites (the filter)
    sets = ({"CAG": 12, "TTAG": 6, "GATA": 5},
            {"GGGCAGGATGAC": 4, "TGCACACGTGCATTCA": 3})
    seq = bytearray(entry0.encode())
    step = len(seq) // 12
    slot = 1
    for motifs in sets:
        for m, copies in motifs.items():
            for unit in (m, reverse_comp(m)):
                at = step * slot
                seq[at:at + len(unit) * copies] = (unit * copies).encode()
                slot += 1
    tfasta = os.path.join(tmp, "tandem.fasta")
    write_fasta(tfasta, [("tandem0 first bench entry, tandem arrays",
                          bytes(seq))], width=70)
    for motifs, need in zip(sets, (["scan_slots"], need_f)):
        label = f"tandem_match -p '{' '.join(motifs)}' -r -c 3 -l 9"
        r = device_vs_host(
            "CLI " + label, "tandem_match",
            ["-i", tfasta, "-p", " ".join(motifs), "-r", "-c", "3", "-l",
             "9"], need, "cpu")
        runs[label] = r
        if r["out"].count(b">") < 2 * len(motifs):
            raise AssertionError("tandem_match missed planted arrays")
    # without -q each candidate's alignment window starts at its pattern
    # id (the reference's quirk, inexact_match.cc:198-200), so its DP
    # spans the text up to the hit: that run takes a 250,000-base corpus,
    # and -k 1 -q runs the same scan over the whole corpus
    small = os.path.join(tmp, "inexact_small.fasta")
    write_bench_corpus(small, entries=1, entry_len=250_000)
    for flags, db_file, pf in ((["-k", "0", "-q"], fasta, pfile),
                               (["-k", "1", "-q"], fasta, pfile),
                               (["-k", "1", "-r"], small, pfile),
                               (["-k", "2", "-q"], fasta, pfile),
                               (["-k", "2", "-q"], fasta, lfile)):
        need, host = ((need_f, "cpu") if flags[1] == "0"
                      else (["sellers_scan"], "sellers"))
        label = (f"CLI inexact_match {' '.join(flags)}"
                 + (" (long primers)" if pf == lfile else "")
                 + (" (250,000-base corpus)" if db_file == small else ""))
        runs[label[4:]] = device_vs_host(
            label, "inexact_match", ["-i", db_file, "-P", pf] + flags, need,
            host)
    # allvall -m 20 -r at k = 0 (the census), -K 1 (the pattern-blocked
    # filter) and -k 1 (Sellers at P = 4,096).  First a 4,096-base query
    # (two chunks) against the corpus' first entry, each route against the
    # native machines over pattern groups; then a 2^16-base query against
    # the whole corpus, k = 0 against the CPU route and -K 1 / -k 1 timed
    # (no host machine takes them at that size in the phase's time), their
    # plants and nesting checked
    rng = np.random.default_rng(SEED + 16)
    bg1 = os.path.join(tmp, "entry0.fasta")
    write_fasta(bg1, [("entry0 first bench entry", entry0.encode())])
    rq = os.path.join(tmp, "query_ref.fasta")
    rplants = allvall_query(rq, rng, 4_096, 4, entry0)
    for flags, need in ((["-r", "-K", "1"], need_f),
                        (["-r", "-k", "1"], ["sellers_scan"])):
        bm = os.path.join(tmp, "allvall_ref.bm")
        label = f"CLI allvall -m 20 {' '.join(flags)} (4,096 x 2,000,000)"
        runs[label[4:]] = device_vs_host(
            label, "allvall", ["-i", rq, "-b", bg1, "-m", "20", "-o",
                               bm] + flags, need, "groups", out=bm)
        check_allvall_plants(read_bitmap(bm)[0], rplants, flags[1])
    n_bg = sum(len(line) - 1 for line in open(fasta)
               if not line.startswith(">"))
    qfasta = os.path.join(tmp, "query.fasta")
    qplants = allvall_query(qfasta, rng, ALLVALL_QUERY_N, 16, entry0)
    bits = {}
    for flags, need, host in ((["-r"], ["scan_slots"], "cpu"),
                              (["-r", "-K", "1"], need_f, None),
                              (["-r", "-k", "1"], ["sellers_scan"], None)):
        bm = os.path.join(tmp, f"allvall{len(bits)}.bm")
        label = f"CLI allvall -m 20 {' '.join(flags)}"
        runs[label[4:]] = device_vs_host(
            label, "allvall", ["-i", qfasta, "-b", fasta, "-m", "20", "-o",
                               bm] + flags, need, host, out=bm)
        bits[" ".join(flags)] = read_bitmap(bm)[0]
    b0, bK, bk = bits["-r"], bits["-r -K 1"], bits["-r -k 1"]
    for b, kind in ((b0, "0"), (bK, "-K"), (bk, "-k")):
        check_allvall_plants(b, qplants, kind)
    if (b0 & ~bK).any() or (bK & ~bk).any():
        raise AssertionError("allvall: k = 0 marks not within -K 1's, or "
                             "-K 1's not within -k 1's")
    marked = [int(b[21:].sum()) for b in (b0, bK, bk)]
    if marked[0] > 4_000:
        raise AssertionError(f"allvall: {marked[0]} exact marks for "
                             f"{len(qplants)} plants")
    merged = os.path.join(tmp, "merged.bm")
    with contextlib.redirect_stderr(io.StringIO()):
        run_tool("allvall_merge", ["-o", merged, "-A",
                                   os.path.join(tmp, "allvall0.bm"),
                                   os.path.join(tmp, "allvall1.bm")])
    if not (read_bitmap(merged)[0] == bK).all():
        raise AssertionError("allvall_merge: k = 0 | -K 1 != -K 1")
    dump = run_tool("allvall_dump", ["-i", qfasta, "-d", merged, "-m",
                                     "20"])
    if dump.count(b">") < len(qplants):
        raise AssertionError("allvall_dump: fewer unset runs than plants")
    log(f"allvall marks (query {ALLVALL_QUERY_N} against {n_bg}"
        f" bases, -r): k = 0 {marked[0]}, "
        f"-K 1 {marked[1]}, -k 1 {marked[2]} of {len(b0) - 21} mers; "
        f"merge == -K 1; dump {dump.count(b'>')} unset runs")
    # merstream over a normalized 2^18-base database: xmers' model with a
    # pattern, -K 1 in batches of 50,000 (the census and the slot gate;
    # phase 17 runs xmers itself at -k 1)
    xfasta = os.path.join(tmp, "xmers.fasta")
    normalized_dna_db(xfasta, XMERS_CLI_N, SEED + 17)
    xout = os.path.join(tmp, "xmers.txt")
    xflags = ["-m", "20", "-R", "-K", "1", "-b", "50000", "-r",
              "AC" + "." * 18]
    label = f"CLI merstream {' '.join(xflags)} (n={XMERS_CLI_N})"
    r = device_vs_host(label, "merstream", ["-i", xfasta, "-o", xout] + xflags,
                       ["scan_slots", "gate_slots"], "cpu", out=xout)
    runs[label[4:]] = r
    if r["out"].count(b":") < 10:
        raise AssertionError("merstream: no phase-2 counts")
    return runs


def allvall_query(path, rng, n, plants, entry0):
    """An ``n``-base random allvall query with ``plants`` 60-base segments
    of the corpus' first entry, in turn exact, with one substitution,
    with one deletion and reverse complemented, written to ``path``.
    Returns the plants as (start, length, kind)."""
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    q = bytearray(random_dna(rng, n))
    e0 = entry0.encode()
    out = []
    for i in range(plants):
        kind = ("exact", "sub", "del", "rc")[i % 4]
        src = len(e0) // 17 * (i + 1)
        seg = bytearray(e0[src:src + 60])
        if kind == "sub":
            seg[30] = b"ACGT"[(b"ACGT".index(seg[30]) + 1) % 4]
        elif kind == "del":
            del seg[30]
        elif kind == "rc":
            seg = bytearray(reverse_comp(seg.decode()).encode())
        at = 1_000 + (n - 2_000) // plants * i
        q[at:at + len(seg)] = seg
        out.append((at, len(seg), kind))
    write_fasta(path, [("query0 allvall query", bytes(q))])
    return out


def check_allvall_plants(bits, plants, k):
    """Every mer of a plant (one leading EOS; a mer ends at its last base
    + 1) is marked where its edit is within ``k`` (``0``, ``-K`` one
    mismatch, ``-k`` one edit); the rest of the query is random against
    the corpus."""
    for at, ln, kind in plants:
        if kind in ("exact", "rc"):
            ends = list(range(at + 21, at + ln + 2))
        else:  # the mers wholly on either side of the edit at base 30
            ends = list(range(at + 21, at + 32)) + list(range(
                at + ln - 8, at + ln + 2))
        if not bits[ends].all():
            raise AssertionError(f"allvall: a {kind} plant at {at} not "
                                 "marked")
        if kind == "sub" and k != "0" and not bits[at + 32:at + 52].all():
            raise AssertionError(f"allvall {k} 1 missed a 1-sub mer")
        if kind == "del" and k == "-k" and not bits[at + 32:at + 51].all():
            raise AssertionError("allvall -k 1 missed a 1-deletion mer")


def allvall_chunk(query, db, m=20, count=2048):
    """The pattern tables of allvall ``-r``'s first chunk over the query
    bases ``query``: its first ``count`` (2,048 in allvall) distinct mers
    of ``m`` ACGT bases in order of first appearance, then their reverse
    complements (P = 4,096), built against ``db`` as ``apps/allvall.py``
    builds them."""
    from sequence_alignment_tools_tpu_torch.io.patterns import PatternSet
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    mers = list(dict.fromkeys(query[i:i + m]
                              for i in range(len(query) - m + 1)))[:count]
    pats = mers + [reverse_comp(p) for p in mers]
    ps = PatternSet(patterns=[""] + pats, esb=[0] * (len(pats) + 1),
                    eeb=[0] * (len(pats) + 1), n_forward=len(pats))
    return build_tables(ps, db, wc=False, textn=False)


def swissprot_like(path, entries, seed):
    """A protein database of ``entries`` entries of 50 to 1,000 residues
    (gamma lengths, mean about 360), 5% exact duplicates of an earlier
    entry and 5% contained in one (a substring of at least 50 residues),
    normalized.  Returns (residues, duplicates, contained)."""
    from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
        main as compress_seq,
    )

    rng = np.random.default_rng(seed)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    # UniProt's residue frequencies, roughly: the common residues first
    freq = np.array([8.3, 1.4, 5.5, 6.8, 3.9, 7.1, 2.3, 5.9, 5.8, 9.7, 2.4,
                     4.1, 4.7, 3.9, 5.5, 6.6, 5.3, 6.9, 1.1, 2.9])
    lengths = np.clip(rng.gamma(2.0, 180.0, entries), 50, 1000).astype(
        np.int64)
    body = aa[rng.choice(20, int(lengths.sum()), p=freq / freq.sum())]
    starts = np.concatenate([[0], np.cumsum(lengths)])
    seqs = [body[starts[i]:starts[i + 1]].tobytes() for i in range(entries)]
    kind = rng.random(entries)
    dups = conts = 0
    for i in range(1, entries):
        j = int(rng.integers(0, i))
        if kind[i] < 0.05:
            seqs[i] = seqs[j]
            dups += 1
        elif kind[i] < 0.10 and len(seqs[j]) > 60:
            ln = int(rng.integers(50, len(seqs[j])))
            at = int(rng.integers(0, len(seqs[j]) - ln + 1))
            seqs[i] = seqs[j][at:at + ln]
            conts += 1
    write_fasta(path, [(f"sp|P{i:06d}|SYN{i} synthetic protein {i}", s)
                       for i, s in enumerate(seqs)])
    if compress_seq(["-i", path, "-n", "true"]):
        raise RuntimeError("compress_seq failed")
    return sum(map(len, seqs)), dups, conts


def prefix_census_phase(smi):
    """The census keyed by prefixes at Swiss-Prot's size: 206,000,000
    residues at Swiss-Prot's composition with I read as L (one code, as
    ``peptide_scan -M 2`` maps them) and an end of sequence about every
    361, and 34,255 peptides of 7 to 45 residues (7 plus a geometric
    length, mean about 15) drawn from it; longer than the register holds
    (14 codes at 21), so ``ConvScanner.scan`` takes the prefix census
    (one ``seed_slots.cu`` launch).  Against the pattern-blocked route
    (17 ``scan_filter.cu`` passes), both on the card in one session:
    equal hits, each route's wall with its tables built (first call) and
    after (median of 3), launches, the census kernel's row against
    ``scan_slots_ref`` on the card (at its full cap, and at cap 1), and
    the kernel alone (CUDA events)."""
    import torch

    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
        ConvScanner,
        device_form,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.slots import (
        scan_slots,
        scan_slots_ref,
    )
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
    from sequence_alignment_tools_tpu_torch.utils import trace

    rng = np.random.default_rng(SEED + 22)
    n = 206_000_000
    table = b"ACGT\n" + bytes(c for c in b"DEFHIKLMNPQRSVWY")
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    freq = np.array([8.3, 1.4, 5.5, 6.8, 3.9, 7.1, 2.3, 5.9, 5.8, 9.7, 2.4,
                     4.1, 4.7, 3.9, 5.5, 6.6, 5.3, 6.9, 1.1, 2.9])
    lut = np.zeros(256, np.uint8)
    for code, ch in enumerate(table):
        lut[ch] = code
    lut[ord("I")] = lut[ord("L")]
    codes = lut[aa[rng.choice(20, n, p=freq / freq.sum())]]
    codes[rng.integers(0, n, n // 361)] = 4
    db = SeqDB(codes=codes, table=table, entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["swissprot_like"])
    pats = []
    while len(pats) < 34_255:
        ln = min(7 + int(rng.geometric(1 / 9)) - 1, 45)
        at = int(rng.integers(0, n - 45))
        win = codes[at : at + ln]
        if (win != 4).all():
            pats.append(bytes(table[c] for c in win).decode())
    tables = build_tables(literal_pattern_set(pats), db, wc=False,
                          textn=False)
    sc = ConvScanner(tables, k=0, device="cuda")
    sc.use_host = False
    key = sc._census_key()
    if key is None or not sc.census_serves(codes):
        raise AssertionError("the peptide-shaped set left the prefix census")
    blocked = ConvScanner(tables, k=0, device="cuda")
    blocked.use_host = False
    device_form(codes, sc.device)
    walls = {}
    launches = {}
    out = {}
    for name, fn in (("prefix census", lambda: list(sc.scan(codes))),
                     ("pattern-blocked",
                      lambda: list(blocked._scan_pblocked(codes)))):
        ran = Launches()
        t0 = time.perf_counter()
        out[name] = fn()
        first = time.perf_counter() - t0
        launches[name] = {k: v for k, v in ran.all().items() if v}
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            reps.append(time.perf_counter() - t0)
        walls[name] = (first, statistics.median(reps))
    got, want = out["prefix census"], out["pattern-blocked"]
    if got != want or len(got) < len(pats):
        raise AssertionError(f"prefix census differs from the "
                             f"pattern-blocked route: {len(got)} vs "
                             f"{len(want)} hits")
    mt = sc._mer_dev()
    dev_codes = device_form(codes, sc.device)
    cap = sc._slot_cap
    # the kernel against its plain twin at these shapes: 21 codes, keys
    # of 14 codes (rolled codes near 2^61.5), 8 classes; then cap 1
    want_row = scan_slots_ref(dev_codes, n, mt, cap)
    check_slots(f"prefix census scan_slots check n={n}, {mt.P} entries, "
                f"classes {list(mt.lens)}", scan_slots(dev_codes, n, mt, cap),
                want_row, cap, cap)
    check_slots("prefix census scan_slots check cap 1 (overflow)",
                scan_slots(dev_codes, n, mt, 1), want_row, 1, cap)
    del want_row
    k_ms = cuda_ms(lambda: scan_slots(dev_codes, n, mt, cap))
    ins = trace.total("census.prefix_in")
    oks = trace.total("census.prefix_ok")
    log(f"prefix census at Swiss-Prot size (n={n}, {len(pats)} peptides, "
        f"Lmax {tables.Lmax}, key {key}, {len(mt.lens)} classes) on {smi}: "
        f"{len(got)} hits == pattern-blocked; walls (first call with "
        f"tables, then median of 3): prefix census "
        f"{walls['prefix census'][0]:.3f} / {walls['prefix census'][1]:.3f}"
        f" s, pattern-blocked {walls['pattern-blocked'][0]:.3f} / "
        f"{walls['pattern-blocked'][1]:.3f} s; launches {launches}; "
        f"seed_slots kernel {k_ms:.4f} ms (CUDA events, median); "
        f"census.prefix_ok / prefix_in {oks} / {ins}")
    del sc, blocked, dev_codes, mt
    torch.cuda.empty_cache()


def scale_phase(tmp, smi):
    """Phase 17: nrdb at Swiss-Prot scale and xmers at full batch width,
    device route against host route, with their phases timed."""
    import multiprocessing

    import torch

    from sequence_alignment_tools_tpu_torch.models.primer_match import (
        PrimerMatchModel,
    )
    from sequence_alignment_tools_tpu_torch.models.xmers import XmersModel
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
        ConvScanner,
        device_form,
    )

    report = {}
    # nrdb: 2^18 proteins, one 6-residue seed each
    pfasta = os.path.join(tmp, "proteins.fasta")
    t0 = time.perf_counter()
    n_res, dups, conts = swissprot_like(pfasta, NRDB_ENTRIES, SEED + 18)
    log(f"nrdb database: {NRDB_ENTRIES} entries, {n_res} residues, {dups} "
        f"duplicates and {conts} contained planted; written and normalized "
        f"in {time.perf_counter() - t0:.3f} s")
    nout = os.path.join(tmp, "nr.fasta")
    gen = PrimerMatchModel.engine_hits
    for flags in ([], ["-C"]):
        label = f"nrdb {' '.join(flags)}".strip()
        marks = []

        def engine_hits(self, _gen=gen, _marks=marks):
            m = {"call": time.perf_counter()}
            _marks.append(m)
            for hit in _gen(self):
                m.setdefault("first", time.perf_counter())
                yield hit
            m.setdefault("first", time.perf_counter())
            m["done"] = time.perf_counter()

        PrimerMatchModel.engine_hits = engine_hits
        try:
            # nrdb against the CPU route; nrdb -C (the same scan, more
            # entries dropped) is timed and its kept count checked
            r = device_vs_host(
                f"CLI {label} (n={n_res})", "nrdb",
                ["-i", pfasta, "-o", nout] + flags, ["scan_slots"],
                None if flags else "cpu", out=nout)
        finally:
            PrimerMatchModel.engine_hits = gen
        kept = r["out"].count(b">")
        # a duplicate is dropped; under -C a contained entry too, and the
        # sequences kept are among nrdb's
        seqs = {rec.split(b"\n", 1)[1] for rec in r["out"].split(b">")[1:]}
        if kept != NRDB_ENTRIES - dups - (conts if flags else 0) or (
                flags and not seqs <= plain_seqs):
            raise AssertionError(f"{label}: {kept} entries kept")
        plain_seqs = seqs
        m = marks[0]  # the device run's
        split = {"set-up": m["call"] - r["t0"],
                 "scan": m["first"] - m["call"],
                 "extension": m["done"] - m["first"],
                 "output": r["t0"] + r["wall"] - m["done"]}
        report[label] = dict(r, split=split, kept=kept, out=None)
        log(f"{label} on {smi}: {kept} of {NRDB_ENTRIES} entries kept; the "
            f"device run's split: load and seeds {split['set-up']:.3f} s, "
            f"scan to the first hit {split['scan']:.3f} s, extension loop "
            f"{split['extension']:.3f} s, output write "
            f"{split['output']:.3f} s")
    # xmers at full batch width: -b 50000 with -R, 100,000 patterns a batch
    xfasta = os.path.join(tmp, "xmers_full.fasta")
    normalized_dna_db(xfasta, XMERS_FULL_N, SEED + 19)
    xout = os.path.join(tmp, "xmers_full.txt")
    argv = ["-i", xfasta, "-o", xout, "-m", "20", "-R", "-k", "1", "-b",
            "50000"]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    up0 = device_form.uploads
    with spans((XmersModel, "run_phase0"),
               (XmersModel, "run_inexact_phases"),
               (PrimerMatchModel, "_halves_ctx"),
               (PrimerMatchModel, "_engine_gate"),
               (ConvScanner, "scan_gated"),
               (PrimerMatchModel, "_halves_emit_arrays")) as took:
        os.environ["SAT_HOST_SCAN"] = "0"
        ran = Launches()
        try:
            got, wall, prof, _t = device_busy(
                lambda: run_tool("xmers", argv, out=xout))
            dev_ms = device_rows(prof)[1]
        finally:
            del os.environ["SAT_HOST_SCAN"]
        launches = ran.all()
    uploads = device_form.uploads - up0
    import gc

    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    tails = multiprocessing.active_children()
    t0 = time.perf_counter()
    with host_route("cpu"):
        want = run_tool("xmers", argv, out=xout)
    s_host = time.perf_counter() - t0
    if got != want or got.count(b":") < 10:
        raise AssertionError("xmers at full width: device and host outputs "
                             "differ")
    if launches["scan_slots"] < 1 or launches["gate_slots"] < 1:
        raise AssertionError(f"xmers at full width: launches {launches}")
    if uploads != 1:
        raise AssertionError(f"xmers uploaded its database {uploads} times")
    if tails:
        raise AssertionError(f"xmers left processes behind: {tails}")
    if abs(mem1 - mem0) > 8 << 20:
        raise AssertionError(f"xmers kept device memory: {mem0} -> {mem1}")
    batches = len([t for t in took["_halves_ctx"] if t > 1e-3])
    ctx = [t for t in took["_halves_ctx"] if t > 1e-3]
    report["xmers"] = {
        "n": XMERS_FULL_N, "wall_s": wall, "device_ms": dev_ms,
        "phase0_s": sum(took["run_phase0"]),
        "inexact_phases_s": sum(took["run_inexact_phases"]),
        "table_build_s": ctx, "gate_build_s": sum(took["_engine_gate"]),
        "scan_gated_s": took["scan_gated"],
        "extension_s": sum(took["_halves_emit_arrays"]),
        "host_run_s": s_host, "launches": launches}
    log(f"xmers -m 20 -R -k 1 -b 50000 over n={XMERS_FULL_N} on {smi}: "
        f"{len(got)} bytes == host route ({s_host:.3f} s); device run "
        f"{wall:.3f} s (profiled), device time {dev_ms:.3f} ms "
        f"({100 * dev_ms / 1e3 / wall:.2f}% of wall); phase 0 "
        f"{report['xmers']['phase0_s']:.3f} s, phases 1 and 2 "
        f"{report['xmers']['inexact_phases_s']:.3f} s over {batches} "
        f"models: table builds "
        + ", ".join(f"{t:.3f}" for t in ctx)
        + f" s, gate tables {report['xmers']['gate_build_s']:.3f} s, "
        f"scan_gated (the census and the slot gate past 2,048 seeds, the "
        f"filter and seed_gate below) "
        + ", ".join(f"{t:.3f}" for t in took["scan_gated"])
        + f" s, extension {report['xmers']['extension_s']:.3f} s; "
        f"launches { {k: v for k, v in launches.items() if v} }; database "
        f"uploads {uploads}; tail processes left {len(tails)}; device "
        f"memory {mem0} -> {mem1} bytes")
    return report


# ---------------------------------------------------------------------------
# phase 18: the tools that reach no scanner, through ``python -m``

# each tool process loads this hook first (``sitecustomize`` on its
# PYTHONPATH) and reports at exit what it loaded and whether it touched
# the card
HOST_HOOK = '''import atexit, sys


def _report():
    torch = sys.modules.get("torch")
    sys.stderr.write("host-tool-process jax=%s jax_package=%s torch=%s "
                     "cuda_initialized=%s\\n" % (
        any(m == "jax" or m.startswith("jax.") for m in sys.modules),
        any(m == "sequence_alignment_tools_tpu"
            or m.startswith("sequence_alignment_tools_tpu.")
            for m in sys.modules),
        torch is not None,
        bool(torch is not None and torch.cuda.is_initialized())))


atexit.register(_report)
'''
HOST_CHARIO_N = 1 << 16   # chario walks its stream a character at a time
HOST_SMALL_N = 1 << 16    # the simulators' and pairscan's database
HOST_GENOME_N = 200_000   # genome_simulation: a Python LCG step a base
HOST_WORKERS = 8          # tool processes at once, one a CPU core


def fasta_entries(path):
    """[(header, sequence)] of a FASTA file."""
    out = []
    with open(path) as f:
        for block in f.read().split(">")[1:]:
            head, _, body = block.partition("\n")
            out.append((head, body.replace("\n", "")))
    return out


def colorspace(read):
    """SOLiD colour space: a ``G`` primer, then the XOR of neighbouring
    2-bit base codes."""
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    prev, out = "G", ["G"]
    for c in read:
        out.append(str(code[prev] ^ code[c]))
        prev = c
    return "".join(out)


def standard_translation(dna):
    """The standard genetic code, written out here (TCAG order)."""
    aa = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
    ix = {"T": 0, "C": 1, "A": 2, "G": 3}
    return "".join(aa[16 * ix[dna[i]] + 4 * ix[dna[i + 1]] + ix[dna[i + 2]]]
                   for i in range(0, len(dna) - 2, 3))


def kmers(text, k):
    return {part[i:i + k] for part in text.split("$")
            for i in range(len(part) - k + 1)}


def brute_min_cost(n, arcs, src, snk, want):
    """The exhaustive optimum of ``tests/test_netflo.py``."""
    import itertools

    best = None
    for assign in itertools.product(*[range(c + 1)
                                      for (_u, _v, c, _w, _t) in arcs]):
        net = [0] * n
        for f, (u, v, _c, _w, _t) in zip(assign, arcs):
            net[u] -= f
            net[v] += f
        if net[snk] == want and net[src] == -want and all(
                net[x] == 0 for x in range(n) if x not in (src, snk)):
            cost = sum(f * a[3] for f, a in zip(assign, arcs))
            best = cost if best is None else min(best, cost)
    return best


def check_min_cost_flow(cases=20):
    """walk_graph ``-O``'s solver: its cost equal to the exhaustive
    optimum on small random graphs (the cases of ``tests/test_netflo.py``),
    ValueError where the demand cannot be met."""
    import random

    from sequence_alignment_tools_tpu_torch.ops.netflo import min_cost_flow

    feasible = 0
    for seed in range(cases):
        rng = random.Random(seed)
        n = rng.randint(3, 5)
        arcs = []
        for i in range(rng.randint(3, 7)):
            u = rng.randrange(n)
            v = rng.randrange(n)
            while v == u:
                v = rng.randrange(n)
            arcs.append((u, v, rng.randint(0, 3), rng.randint(0, 9), i))
        want = rng.randint(1, 3)
        best = brute_min_cost(n, arcs, 0, n - 1, want)
        try:
            flows = min_cost_flow(n, arcs, 0, n - 1, want)
        except ValueError:
            flows = None
        got = None if flows is None else sum(
            f * a[3] for f, a in zip(flows, arcs))
        if got != best:
            raise AssertionError(f"min_cost_flow seed {seed}: cost {got}, "
                                 f"brute force {best}")
        feasible += best is not None
    return feasible


def host_tool_jobs(tmp, corpus, small, genome, reads, rlfa, prot):
    """The phase's 23 runs of the port's dispatcher (genome_simulation
    twice, ``--help`` once) as {label: (argv, labels it reads the output
    of, stdin text or a function of the finished runs giving it,
    invariant(run) -> its name)}."""
    p = {n: os.path.join(tmp, n) for n in (
        "pos.txt", "rec.txt", "chario.seq", "mers4.txt", "ka.txt", "aa.bin",
        "g1.sqn", "g2.sqn", "ps.bm", "g.wg", "g.sq", "c.wg", "ix", "pa",
        "xs", "lo", "wg.ee")}
    rng = np.random.default_rng(SEED + 18)
    ents = fasta_entries(corpus)
    seqs = [s for _h, s in ents]

    # extract_seq: 12 slices of each entry
    recs = [(e, int(rng.integers(0, len(s) - 600)),
             int(rng.integers(1, 500))) for e, s in enumerate(seqs)
            for _ in range(12)]
    with open(p["pos.txt"], "w") as f:
        f.writelines(f"{e} {a} {n}\n" for e, a, n in recs)
    want_ex = "".join(seqs[e][a:a + n] + "\n" for e, a, n in recs)
    # the reference's record loop runs once more on the last record at EOF
    want_ex += seqs[recs[-1][0]][recs[-1][1]:recs[-1][1] + recs[-1][2]] + "\n"

    def ex_ok(r):
        if r["out"].decode() != want_ex:
            raise AssertionError("extract_seq: output differs from the "
                                 "FASTA slices")
        return "output == the FASTA slices (and the last again at EOF)"

    # kmer_count -k 4 -a: the census sums to the valid windows
    def kc_ok(r):
        counts = [int(line.split()[1])
                  for line in open(p["mers4.txt"]).read().splitlines()]
        windows = 0
        for s in seqs:
            a = np.frombuffer(s.encode(), np.uint8)
            ok = np.isin(a, np.frombuffer(b"ACGT", np.uint8))
            if len(a) >= 4:
                windows += int(np.lib.stride_tricks.sliding_window_view(
                    ok, 4).all(axis=1).sum())
        if sum(counts) != windows or len(counts) != 256:
            raise AssertionError(f"kmer_count: {sum(counts)} counted over "
                                 f"{len(counts)} mers, {windows} windows")
        return f"sum of counts == {windows} valid windows (numpy)"

    # kmer_annotate: the first entry's window values against the table
    def ka_ok(r):
        table = {}
        for line in open(p["mers4.txt"]).read().splitlines():
            mer, c = line.split()
            table[mer] = int(c)
        with open(p["ka.txt"], "rb") as f:
            lines = f.read().split(b"\n")
        if len(lines) != len(seqs) + 1 or lines[-1]:
            raise AssertionError(f"kmer_annotate: {len(lines) - 1} lines "
                                 f"for {len(seqs)} entries")
        got = np.array(lines[0].split(b"\t", 1)[1].split(), dtype=np.int64)
        s = seqs[0]
        lut = np.zeros(256, np.int64)
        for i, c in enumerate(b"ACGT"):
            lut[c] = i
        a = lut[np.frombuffer(s.encode(), np.uint8)]
        h = np.lib.stride_tricks.sliding_window_view(a, 4) @ (
            4 ** np.arange(3, -1, -1))
        rc = np.lib.stride_tricks.sliding_window_view(3 - a, 4) @ (
            4 ** np.arange(4))
        vals = np.zeros(256, np.int64)
        for mer, c in table.items():
            vals[int(np.dot([lut[ord(x)] for x in mer],
                            4 ** np.arange(3, -1, -1)))] = c
        want = vals[h] + vals[rc]
        if len(got) != len(s) - 3 or not np.array_equal(got, want):
            raise AssertionError("kmer_annotate: the first entry's window "
                                 "values differ from the table's")
        return (f"{len(got)} window values of entry 0 == forward + reverse "
                "complement table counts (numpy)")

    # polyrun: every homopolymer of 10 or more, by numpy
    def pr_ok(r):
        want = set()
        for e, s in enumerate(seqs):
            a = np.frombuffer(s.encode(), np.uint8)
            cut = np.flatnonzero(a[1:] != a[:-1]) + 1
            st = np.concatenate([[0], cut])
            en = np.concatenate([cut, [len(a)]])
            for b0, b1 in zip(st, en):
                if b1 - b0 >= 10:
                    want.add((e + 1, int(b0), int(b1), chr(a[b0])))
        got = {(int(f), int(s), int(t), c) for f, s, t, c in
               (line.split() for line in r["out"].decode().splitlines())}
        if got != want or not want:
            raise AssertionError(f"polyrun: {len(got)} runs, numpy finds "
                                 f"{len(want)}")
        return f"the {len(want)} runs of 10 or more == numpy's"

    # atac_seq: 40 disjoint records, some reverse complemented
    starts = sorted(rng.choice(np.arange(0, len(seqs[0]) - 400, 400), 40,
                               replace=False))
    arecs = []
    with open(p["rec.txt"], "w") as f:
        for i, a in enumerate(starts):
            e = i % len(seqs)
            n = int(rng.integers(50, 300))
            rev = i % 3 == 0
            arecs.append((f"r{i}", e, int(a), n, rev))
            f.write(f"r{i} {e} {a} {n} {int(rev)} {int(rev)}\n")

    def at_ok(r):
        from sequence_alignment_tools_tpu_torch.utils.iupac import (
            reverse_comp,
        )

        blocks = r["out"].decode().split(">")[1:]
        got = {}
        for b in blocks:
            head, _, body = b.partition("\n")
            rid = head.split("/alignment={")[1].split("}")[0]
            got[rid] = body.replace("\n", "")
        for rid, e, a, n, rev in arecs:
            s = seqs[e][a:a + n]
            if got.get(rid) != (reverse_comp(s) if rev else s):
                raise AssertionError(f"atac_seq: record {rid} differs")
        if len(got) != len(arecs):
            raise AssertionError(f"atac_seq: {len(got)} of {len(arecs)}")
        return f"{len(arecs)} records == the slices (reverse complemented)"

    # chario: frame 0 under the standard code
    cbases = seqs[0][:HOST_CHARIO_N]
    with open(p["chario.seq"], "w") as f:
        f.write(cbases + "$")

    def ch_ok(r):
        head = r["out"].decode()[:50]
        if head != standard_translation(cbases[:150]):
            raise AssertionError("chario: frame 0 differs from the standard "
                                 "code")
        return "the first 50 characters == frame 0 under the standard code"

    # aacomp / aacomplookup
    def aa_index():
        data = open(p["aa.bin"], "rb").read()
        n = int(np.frombuffer(data[:8], "<u8")[0])
        recs = np.frombuffer(data[8:], np.dtype([("m", "<f4"), ("pad", "<u4"),
                                                 ("e", "<i8"), ("p", "<i8")]))
        return n, len(data), recs

    def ac_ok(r):
        n, size, recs = aa_index()
        m = recs["m"]
        if size != 8 + 24 * n or n < 1000 or (np.diff(m) < 0).any() \
                or m.min() < 100 or m.max() > 1000:
            raise AssertionError(f"aacomp: {n} records in {size} bytes")
        return f"{n} records, 24 bytes each, masses sorted in [100, 1000]"

    def lookup_stdin(runs):
        _n, _s, recs = aa_index()
        pick = recs[[len(recs) // 7, len(recs) // 2, len(recs) - 3]]
        return "".join(f"{float(x['m'])!r}\n" for x in pick)

    def al_ok(r):
        _n, _s, recs = aa_index()
        pick = recs[[len(recs) // 7, len(recs) // 2, len(recs) - 3]]
        hits = [tuple(map(int, line.split()))
                for line in r["out"].decode().splitlines()]
        for q, x in enumerate(pick):
            if (q, int(x["e"]), int(x["p"])) not in hits:
                raise AssertionError(f"aacomplookup: query {q} misses its "
                                     "own record")
        return f"each of 3 queries finds its own record ({len(hits)} hits)"

    # genome_simulation: one seed twice, glibc's drand48 draw for draw
    def gs_ok(r):
        import ctypes
        import ctypes.util

        a = open(p["g1.sqn"], "rb").read()
        b = open(p["g2.sqn"], "rb").read()
        libc = ctypes.CDLL(ctypes.util.find_library("c"))
        libc.drand48.restype = ctypes.c_double
        libc.srand48(ctypes.c_long(7))
        want = bytes(int(libc.drand48() * 4) for _ in range(1000))
        if a != b or len(a) != HOST_GENOME_N + 2 or a[0] != 4 \
                or a[-1] != 4 or a[1:1001] != want:
            raise AssertionError("genome_simulation: runs differ or leave "
                                 "glibc's drand48 sequence")
        return "two runs of seed 7 equal, the first 1,000 codes glibc's"

    # solid_simulation: error-free reads of the database, in colour space
    small_seq = "".join(s for _h, s in fasta_entries(small))

    def ss_ok(r):
        from sequence_alignment_tools_tpu_torch.utils.iupac import (
            reverse_comp,
        )

        lines = r["out"].decode().splitlines()
        for hdr, csq in zip(lines[::2], lines[1::2]):
            label, read = hdr[1:].split()
            if (read not in small_seq and reverse_comp(read) not in small_seq
                    or csq != colorspace(read)):
                raise AssertionError(f"solid_simulation: read {label}")
        if len(lines) != 400:
            raise AssertionError(f"solid_simulation: {len(lines)} lines")
        return "200 reads of the database (or reverse complements) in " \
               "colour space"

    # pairscan: the checkpoint reads back, again within first
    def ps_ok(r):
        from sequence_alignment_tools_tpu_torch.apps.allvall import (
            read_bitmap_block,
        )

        data = open(p["ps.bm"], "rb").read()
        if not data.startswith(b"BEGIN\n0 0\n") or not data.endswith(b"END\n"):
            raise AssertionError("pairscan: checkpoint framing")
        first, at = read_bitmap_block(data, 10)
        again, at = read_bitmap_block(data, at)
        if len(first) != 1 << 24 or (again & ~first).any() \
                or not again.any() or first.sum() > 8 * HOST_SMALL_N:
            raise AssertionError("pairscan: bitmaps")
        return (f"checkpoint reads back: {int(first.sum())} pairs seen, "
                f"{int(again.sum())} again, again within first")

    # the graph stack
    rtext = "$".join(s for _h, s in fasta_entries(reads))

    def bg_ok(r):
        edges = open(p["g.wg"]).read().splitlines()
        if len(edges) < 1000 or any(len(e.split()) != 5 for e in edges):
            raise AssertionError("build_graph: graph file")
        return f"{len(edges)} edges of 5 fields"

    def wk_ok(r):
        miss = kmers(rtext, 15) - kmers(r["out"].decode(), 15)
        if miss:
            raise AssertionError(f"walk_graph -R -O: {len(miss)} read "
                                 "15-mers missing from the walk")
        return "every read 15-mer is in the walk"

    def cn_ok(r):
        before = len(open(p["g.wg"]).read().splitlines())
        after = open(p["c.wg"]).read().splitlines()
        if not 0 < len(after) < before \
                or any(len(e.split()) != 7 for e in after):
            raise AssertionError("cannon_csbh_graph: compressed graph")
        return f"{before} edges compressed to {len(after)}"

    def an_ok(r):
        lines = r["out"].decode().splitlines()
        real = sum(int(e.split()[4]) > 0
                   for e in open(p["g.wg"]).read().splitlines())
        if not lines[0].startswith("track type=wiggle_0") \
                or len(lines) - 1 != real:
            raise AssertionError("csbh_annotate: track")
        return f"one track line per real edge ({real})"

    def sa_ok(r):
        contigs = r["out"].decode().split("$")
        if genome not in contigs:
            raise AssertionError("solid_assembly: the genome is not among "
                                 "the contigs")
        return f"the {len(genome)}-base genome is one of the contigs"

    # the RL stack
    rl = fasta_entries(rlfa)

    def ix_ok(r):
        fwd = open(p["ix"] + ".fwd", "rb").read()
        if len(fwd) != 1 + sum(len(s) + 1 for _h, s in rl) \
                or fwd.count(b"$") != len(rl) + 1:
            raise AssertionError("Indexer: forward file")
        return f"forward file of {len(fwd)} bytes, {len(rl) + 1} terminals"

    def ia_ok(r):
        seq = open(p["pa"] + ".seq", "rb").read()
        n = fasta_entries(prot)
        if len(seq) != 1 + sum(len(s) + 1 for _h, s in n):
            raise AssertionError("IndexerAA: sequence file")
        return f"amino file of {len(seq)} bytes"

    def xs_ok(r):
        lines = open(p["xs"]).read().splitlines()
        slen = len(open(p["ix"] + ".fwd", "rb").read())
        if lines[0] != " 0.$" or not lines[1].endswith(
                f" {slen}.{lines[1][-1]}") or len(lines) < 50:
            raise AssertionError("Xspace: x-space of the Indexer files")
        return f"reads the phase's Indexer files: {len(lines)} lines"

    def lo_ok(r):
        lines = open(p["lo"]).read().splitlines()
        slen = len(open(p["ix"] + ".fwd", "rb").read())
        if lines[0] != f" 0.$ {slen - 1}.$" or len(lines) < 50:
            raise AssertionError("XspaceLo: x-space of the Indexer files")
        return f"reads the phase's Indexer files: {len(lines)} lines"

    def wg_ok(r):
        lines = open(p["wg.ee"]).read().splitlines()
        run = 0
        for line in lines[:-1]:
            f = line.split("\t")
            if f[0] == "e":
                run += 1
            elif f[0] != "E" or int(f[5]) != run + 1:
                raise AssertionError("WordGraph: e-run counts")
            else:
                run = 0
        if lines[-1] != "." or len(lines) < 20:
            raise AssertionError("WordGraph: edge list")
        return f"{len(lines) - 1} edge lines, each E count == its e-run + 1"

    def help_ok(r):
        from sequence_alignment_tools_tpu_torch.__main__ import _TOOLS

        names = r["err"].decode().split("Tools:")[1].split("host-tool")[0]
        if names.split() != sorted(_TOOLS) or len(_TOOLS) != 37:
            raise AssertionError("the dispatcher's usage: tool names")
        return "the usage lists the dispatcher's 37 tool names"

    ix = p["ix"]
    jobs = {
        # the chains' heads first: the runs that others read
        "kmer_count": (["-i", corpus, "-k", "4", "-a", "-o", p["mers4.txt"]],
                       (), None, kc_ok),
        "Indexer": (["-i", ix + ".idx", "-f", ix + ".fwd", "-r", ix + ".rev",
                     rlfa], (), None, ix_ok),
        "build_graph": (["-i", reads, "-k", "15", "-g", p["g.wg"], "-s",
                         p["g.sq"]], (), None, bg_ok),
        "aacomp": (["-i", prot, "-M", "1000", "-o", p["aa.bin"]], (), None,
                   ac_ok),
        "genome_simulation": (["-l", str(HOST_GENOME_N), "-s", "7", "-o",
                               p["g1.sqn"]], (), None, None),
        "kmer_annotate": (["-m", p["mers4.txt"], "-s", corpus, "-k", "4",
                           "-o", p["ka.txt"]], ("kmer_count",), None, ka_ok),
        "Xspace": (["-m", "8", "-a", "-i", ix + ".idx", "-f", ix + ".fwd",
                    "-o", p["xs"]], ("Indexer",), None, xs_ok),
        "WordGraph": (["-x", p["xs"], "-m", "8", "-f", ix + ".fwd", "-o",
                       p["wg.ee"]], ("Xspace",), None, wg_ok),
        "walk_graph": (["-g", p["g.wg"], "-s", p["g.sq"], "-k", "15", "-R",
                        "-O"], ("build_graph",), None, wk_ok),
        "extract_seq": (["-i", corpus, "-A", p["pos.txt"]], (), None, ex_ok),
        "polyrun": (["-i", corpus, "-l", "10", "-A", r"%f %s %e %t\n"], (),
                    None, pr_ok),
        "atac_seq": (["-i", corpus, "-A", p["rec.txt"]], (), None, at_ok),
        "chario": (["-i", p["chario.seq"]], (), None, ch_ok),
        "pairscan": (["-i", small, "-o", p["ps.bm"], "-m", "6", "-d", "0",
                      "-D", "3"], (), None, ps_ok),
        "aacomplookup": (["-i", p["aa.bin"], "-t", "0.01"], ("aacomp",),
                         lookup_stdin, al_ok),
        "genome_simulation#2": (["-l", str(HOST_GENOME_N), "-s", "7", "-o",
                                 p["g2.sqn"]], ("genome_simulation",), None,
                                gs_ok),
        "solid_simulation": (["-i", small, "-m", "25", "-S", "200", "-R",
                              "-e", "0 0 0 0 0", "-s", "5"], (), None,
                             ss_ok),
        "cannon_csbh_graph": (["-g", p["g.wg"], "-k", "15", "-o", p["c.wg"]],
                              ("build_graph",), None, cn_ok),
        "csbh_annotate": (["-g", p["g.wg"], "-k", "15"], ("build_graph",),
                          None, an_ok),
        "solid_assembly": (["-g", p["g.wg"], "-i", reads, "-k", "15"],
                           ("build_graph",), None, sa_ok),
        "IndexerAA": (["-i", p["pa"] + ".idx", "-f", p["pa"] + ".seq", prot],
                      (), None, ia_ok),
        "XspaceLo": (["-k", "8", "-i", ix + ".idx", "-f", ix + ".fwd", "-r",
                      ix + ".rev", "-o", p["lo"]], ("Indexer",), None, lo_ok),
    }
    jobs = {label: ([label.split("#")[0]] + argv, *rest)
            for label, (argv, *rest) in jobs.items()}
    # the dispatcher alone, among the first runs: the interpreter and the
    # package import, the floor under every tool's wall
    return {"--help": (["--help"], (), None, help_ok), **jobs}


def run_host_tools(tmp, jobs, workers=HOST_WORKERS):
    """Each job as ``python -m sequence_alignment_tools_tpu_torch <argv>``
    in a process of its own, up to ``workers`` at once, a job once the
    runs it reads have ended; {label: {"rc", "out", "err", "wall_s"}}."""
    hook = os.path.join(tmp, "hook")
    os.makedirs(hook, exist_ok=True)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(HOST_HOOK)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [hook, repo] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    done, running, pending = {}, {}, list(jobs)
    try:
        while pending or running:
            for label in list(pending):
                argv, deps, stdin, _ok = jobs[label]
                if len(running) >= workers or not all(d in done
                                                      for d in deps):
                    continue
                pending.remove(label)
                if callable(stdin):
                    stdin = stdin(done)
                outf = open(os.path.join(tmp, f"{label}.stdout"), "w+b")
                errf = open(os.path.join(tmp, f"{label}.stderr"), "w+b")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "sequence_alignment_tools_tpu_torch"]
                    + argv, cwd=tmp, env=env,
                    stdin=subprocess.PIPE, stdout=outf, stderr=errf)
                proc.stdin.write((stdin or "").encode())
                proc.stdin.close()
                running[label] = (proc, outf, errf, time.perf_counter())
            for label, (proc, outf, errf, t0) in list(running.items()):
                if proc.poll() is None:
                    continue
                wall = time.perf_counter() - t0
                del running[label]
                outf.seek(0)
                errf.seek(0)
                done[label] = {"rc": proc.returncode, "out": outf.read(),
                               "err": errf.read(), "wall_s": wall}
                outf.close()
                errf.close()
            time.sleep(0.01)
    finally:
        for proc, outf, errf, _t0 in running.values():
            proc.kill()
            proc.wait()
            outf.close()
            errf.close()
    return done


def host_tools_phase(tmp, smi, entry_len=ENTRY):
    """Phase 18: the 21 tool names that reach no scanner, each through
    ``python -m sequence_alignment_tools_tpu_torch <tool>`` in a process
    of its own on this machine's CPU: exit status, one invariant a tool,
    no jax and nothing of the JAX package loaded, no CUDA context
    initialized.  The corpus tools read the phase-16 corpus (bench.py's
    layout, ``entry_len`` bases an entry, normalized as users normalize
    it); chario reads its first 2^16 bases, the simulators and pairscan a
    2^16-base database, the graph stack reads over a genome with a
    repeat, the RL stack a 6-entry DNA FASTA and 40 proteins."""
    from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
        main as compress_seq,
    )

    t0 = time.perf_counter()
    corpus = os.path.join(tmp, "corpus.fasta")
    first = write_bench_corpus(corpus, entry_len=entry_len)
    if compress_seq(["-i", corpus, "-n", "true"]):
        raise RuntimeError("compress_seq failed")
    rng = np.random.default_rng(SEED + 19)
    small = os.path.join(tmp, "small.fasta")
    q = HOST_SMALL_N // 4
    write_fasta(small, [(f"s{e} small entry {e}",
                         first[e * q:(e + 1) * q].encode())
                        for e in range(4)])
    if compress_seq(["-i", small, "-n", "true"]):
        raise RuntimeError("compress_seq failed")
    # solid_assembly's genome: a 40-base repeat between three 2,000-base
    # stretches, read by 100-base reads every 10 bases
    a, r, b, c = (random_dna(rng, n).decode() for n in (2000, 40, 2000,
                                                         2000))
    genome = a + r + b + r + c
    reads = os.path.join(tmp, "reads.fasta")
    write_fasta(reads, [(f"w{i}", genome[i:i + 100].encode())
                        for i in range(0, len(genome) - 99, 10)], width=100)
    rlfa = os.path.join(tmp, "rl.fasta")
    write_fasta(rlfa, [(f"r{e} rl entry {e}", bytes(
        np.frombuffer(b"ACGTACGTacgtN", np.uint8)[
            rng.integers(0, 13, 2000 + 300 * e)])) for e in range(6)],
        width=61)
    prot = os.path.join(tmp, "prot.fasta")
    aas = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    write_fasta(prot, [(f"q{e} protein {e}",
                        bytes(aas[rng.integers(0, 20, 300)]))
                       for e in range(40)])
    jobs = host_tool_jobs(tmp, corpus, small, genome, reads, rlfa, prot)
    s_inputs = time.perf_counter() - t0
    t1 = time.perf_counter()
    feasible = check_min_cost_flow()
    log(f"host tools: min_cost_flow == brute force on 20 small graphs "
        f"({feasible} feasible, the rest refused), "
        f"{time.perf_counter() - t1:.3f} s")
    t1 = time.perf_counter()
    runs = run_host_tools(tmp, jobs)
    s_runs = time.perf_counter() - t1
    for label, (argv, _deps, _stdin, ok) in jobs.items():
        run = runs[label]
        tail = run["err"].decode(errors="replace").splitlines()
        if run["rc"] not in ((0, 134) if label == "chario" else (0,)):
            raise AssertionError(f"{label}: exit status {run['rc']}: "
                                 + "\n".join(tail[-20:]))
        if tail[-1:] != ["host-tool-process jax=False jax_package=False "
                         "torch=False cuda_initialized=False"]:
            raise AssertionError(f"{label}: {tail[-1:]}")
        what = ok(run) if ok else "checked with its second run"
        log(f"host tool {' '.join(os.path.basename(x) for x in argv)}: "
            f"exit {run['rc']}, {len(run['out'])} bytes out, wall "
            f"{run['wall_s']:.3f} s; invariant: {what}")
    names = {argv[0] for argv, *_ in jobs.values()} - {"--help"}
    if len(names) != 21:
        raise AssertionError(f"host tools: {len(names)} names run")
    log(f"host tools on {smi}: 21 names in {len(jobs) - 1} processes and "
        f"--help in one (up to {HOST_WORKERS} at once), CPU only: none "
        f"loaded jax, the JAX package or torch, none initialized CUDA; "
        f"inputs "
        f"{s_inputs:.3f} s (corpus of {8 * entry_len} bases written and "
        f"normalized), runs {s_runs:.3f} s; cuts: chario to the first "
        f"{HOST_CHARIO_N} bases, genome_simulation to {HOST_GENOME_N} bases")


# ---------------------------------------------------------------------------
# phase 20: the cold one-shot regime (the site-less ``sat_torch`` launcher)

COLD_FLAGS = (["-r", "-c"], ["-r", "-c", "-k", "1"], ["-r", "-c", "-k", "2"])
# the device route's kernels, as its SAT_ROUTE_VERBOSE lines name them
COLD_KERNELS = {"": ("scan_filter.cu",),
                "1": ("scan_filter.cu", "seed_gate.cu"),
                "2": ("myers.cu",)}
BOOT_HOST = "sat-boot: torch_imported=False cuda_initialized=False"
BOOT_DEVICE = "sat-boot: torch_imported=True cuda_initialized=True"


def cold_runs(jobs):
    """[(stdout, stderr, wall seconds)] of fresh interpreters running the
    port's CLI, all started together: each job ``(argv, env, sited)`` is
    ``python -S sat_torch <argv>``, or with ``sited`` the sited ``python -m
    sequence_alignment_tools_tpu_torch <argv>``; raises on a non-zero
    exit."""
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for argv, env, sited in jobs:
        cmd = ([sys.executable, "-m", "sequence_alignment_tools_tpu_torch"]
               if sited else [sys.executable, "-S",
                              os.path.join(repo, "sat_torch")]) + argv
        procs.append((cmd, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=repo)))
    done = []
    for cmd, t0, proc in procs:
        out, err = proc.communicate(timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[1:])}: exit status "
                                 f"{proc.returncode}: {err[-1500:]!r}")
        done.append((out, err.decode(errors="replace"), wall))
    return done


def cold_run(argv, env, sited=False):
    return cold_runs([(argv, env, sited)])[0]


def boot_report(err):
    lines = [ln for ln in err.splitlines() if ln.startswith("sat-boot:")]
    return lines[-1] if lines else None


def floor_s(args, reps=2):
    """Best wall seconds of ``python <args>``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        subprocess.run([sys.executable] + args, check=True,
                       capture_output=True, timeout=120)
        best = min(best, time.perf_counter() - t0)
    return best


# a site-less interpreter given the launcher's site directories (argv[1]),
# which then imports torch and starts CUDA, timing both on its own clock
TORCH_FLOOR = """import sys, time
boot = {"__name__": "sat_torch_boot"}
exec(open(sys.argv[1]).read(), boot)
boot["_add_site_dirs"]()
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.cuda.init()
print(t1 - t0, time.perf_counter() - t1)
"""


def cold_phase(tmp, smi):
    """Phase 20: bench.py's one-shot rows through the site-less launcher
    on the card's machine.  bench.py's 16 M corpus and 10 primers,
    ``primer_match -r -c`` at k = 0, 1 and 2 under ``SAT_AUTO_ARTIFACTS=1``
    with ``SAT_MESH`` and ``SAT_DEVICE`` unset: a first run probes the GPU
    count (torch imported, no CUDA context), caches it and writes the
    artifacts; then the three with ``SAT_HOST_SCAN=0``, together, must
    import torch mid-run, initialize CUDA and run the CUDA kernels; then
    each row is the best of two ``python -S sat_torch`` runs, which must
    import no torch and initialize no CUDA, and every run prints the bytes
    of the sited ``python -m`` run and of the host route in this process.
    Then the floors: the interpreter with and without ``site``, the
    launcher's ``--help``, and one site-less interpreter that imports
    torch and starts CUDA.  Returns ({row: best wall seconds}, {floor:
    seconds})."""
    t_phase = time.perf_counter()
    corpus = os.path.join(tmp, "corpus.fasta")
    write_bench_corpus(corpus)
    pfile = os.path.join(tmp, "pats.txt")
    with open(pfile, "w") as f:
        f.write("\n".join(PATS) + "\n")
    cache = os.path.join(tmp, "cache")
    os.makedirs(cache)
    env = {k: v for k, v in os.environ.items()
           if k not in ("SAT_DEVICE", "SAT_HOST_SCAN", "SAT_MESH",
                        "SAT_ROUTE_VERBOSE")}
    env.update(SAT_AUTO_ARTIFACTS="1", SAT_BOOT_DEBUG="1", TMPDIR=cache)
    s_inputs = time.perf_counter() - t_phase
    base = ["primer_match", "-i", corpus, "-P", pfile]
    # the first run of the machine: auto mesh probes and caches the count
    _o, err, wall0 = cold_run(base + list(COLD_FLAGS[0]), env)
    if boot_report(err) != ("sat-boot: torch_imported=True "
                            "cuda_initialized=False"):
        raise AssertionError(f"cold probe run: {boot_report(err)}")
    log(f"cold one-shot: first run (GPU count probed and cached, "
        f"artifacts written) {wall0:.3f} s")
    dev_env = dict(env, SAT_HOST_SCAN="0", SAT_ROUTE_VERBOSE="1")
    dev_runs = cold_runs([(base + flags, dev_env, False)
                          for flags in COLD_FLAGS])
    walls = {}
    for flags, (dev_out, dev_err, s_dev) in zip(COLD_FLAGS, dev_runs):
        argv = base + flags
        k = flags[3] if len(flags) > 2 else ""
        row = "oneshot_" + ({"": "exact", "1": "k1", "2": "k2"}[k])
        missing = [cu for cu in COLD_KERNELS[k] if cu not in dev_err]
        if boot_report(dev_err) != BOOT_DEVICE or missing:
            raise AssertionError(f"{row} device route: "
                                 f"{boot_report(dev_err)}, no route line "
                                 f"names {missing}")
        outs, best = [], float("inf")
        for _ in range(2):
            out, err, wall = cold_run(argv, env)
            if boot_report(err) != BOOT_HOST:
                raise AssertionError(f"{row}: {boot_report(err)}")
            outs.append(out)
            best = min(best, wall)
        sited, _e, s_sited = cold_run(argv, env, sited=True)
        with host_route("cpu"):
            oracle = run_tool("primer_match", argv[1:])
        if not (outs[0] == outs[1] == sited == oracle == dev_out) \
                or outs[0].count(b"\n") < len(PATS):
            raise AssertionError(f"{row}: launcher, sited, host route and "
                                 "device route bytes differ")
        walls[row] = best
        log(f"cold one-shot {row} ({' '.join(flags)}) on {smi}: sat_torch "
            f"best of 2 {best:.3f} s (torch not imported, CUDA not "
            f"initialized); sited python -m {s_sited:.3f} s; device route "
            f"(SAT_HOST_SCAN=0, the three rows at once; torch imported "
            f"mid-run, {' + '.join(COLD_KERNELS[k])}) {s_dev:.3f} s; "
            f"{len(outs[0])} bytes, all equal")
    launcher = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "sat_torch")
    floors = {"python -S -c pass": floor_s(["-S", "-c", "pass"]),
              "python -c pass": floor_s(["-c", "pass"]),
              "python -S sat_torch --help": floor_s(["-S", launcher,
                                                     "--help"])}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-S", "-c", TORCH_FLOOR, launcher],
                       check=True, capture_output=True, text=True,
                       timeout=120)
    floors["python -S, import torch, torch.cuda.init()"] = \
        time.perf_counter() - t0
    t_import, t_cuda = (float(x) for x in r.stdout.split())
    floors["of which import torch"] = t_import
    floors["of which torch.cuda.init()"] = t_cuda
    log(f"cold one-shot floors on {smi} (best of 2, the torch process "
        f"once): " + ", ".join(f"{k} {v:.3f} s" for k, v in floors.items()))
    log(f"cold one-shot phase: inputs {s_inputs:.3f} s (16 M corpus "
        f"written), {len(COLD_FLAGS)} rows")
    return walls, floors


# ---------------------------------------------------------------------------
# phase 19: the mesh on the card (parallel/shard.py, parallel/multihost.py)

MESH_N = 4                # shards of the 1-D mesh, all on cuda:0
MESH_RANKS = 2            # processes of the 2 x 2 node x GPU mesh
MESH_RANK_TIMEOUT = 240   # seconds a rank may take, bring-up included


def wall_median(fn, reps):
    """(median host seconds of ``fn()`` after a warm-up call, its last
    result), each call ended by a device synchronize."""
    import torch

    out = fn()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs), out


def mesh_rank_worker(rank, port, tmp):
    """One rank of the 2 x 2 mesh (``chip_smoke.py --mesh-rank <rank>
    <port> <dir>``): joins the gloo group on localhost, drives two
    entries of cuda:0 over ``<dir>/codes.npy`` and writes its counts, hit
    stream, launches and wall to ``<dir>/rank<rank>.npz``."""
    import torch
    import torch.distributed as dist

    os.environ.update(SAT_COORDINATOR=f"localhost:{port}",
                      SAT_NUM_PROCESSES=str(MESH_RANKS),
                      SAT_PROCESS_ID=str(rank))
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
    from sequence_alignment_tools_tpu_torch.ops.tables import (
        build_tables,
        device_tables,
    )
    from sequence_alignment_tools_tpu_torch.parallel.multihost import (
        init_distributed,
        make_host_chip_mesh,
        shard_codes_2d,
        sharded_pallas_scan_hits_2d,
        sharded_scan_counts_2d,
    )

    got = init_distributed(timeout=MESH_RANK_TIMEOUT)
    dev = torch.device("cuda", 0)
    codes = np.load(os.path.join(tmp, "codes.npy"))
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
               entry_lengths=np.array([len(codes)]), headers=["block"])
    tables = build_tables(build_pattern_set(PATS, rev_comp=True), db,
                          wc=False, textn=False)
    mesh = make_host_chip_mesh(devices=[dev, dev])
    dt = device_tables(tables, 0, False, dev)
    rows, _ = shard_codes_2d(codes, mesh, tables.Lmax - 1, EOS)
    counts = sharded_scan_counts_2d(rows, dt.weights, dt.thresholds,
                                    dt.lengths, tables.alpha, mesh)
    sc = ConvScanner(tables, k=0, device=dev)
    list(sharded_pallas_scan_hits_2d(sc, codes, mesh))
    ran = Launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = list(sharded_pallas_scan_hits_2d(sc, codes, mesh))
    wall = time.perf_counter() - t0
    launches = ran["scan_occupancy"]
    sc1 = ConvScanner(tables, k=0, device=dev)
    sc1._cap_mb = sc1._hit_cap = 1
    hits1 = list(sharded_pallas_scan_hits_2d(sc1, codes, mesh))
    dist.destroy_process_group()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), got=np.array(got),
             counts=counts.numpy(), hits=np.array(hits, np.int64),
             hits1=np.array(hits1, np.int64), launches=launches, wall=wall)
    return 0


def mesh_ranks(smi, block, want):
    """The 2 x 2 mesh across two processes on cuda:0: both ranks' counts
    and hit streams against the unsharded stream ``want`` of ``block``.
    Raises on a mismatch, a rank's non-zero exit or a hang past its
    timeout; no rank outlives the call."""
    import socket

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "codes.npy"), block)
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SAT_MESH")}
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), str(port), tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for r in range(MESH_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MESH_RANK_TIMEOUT))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (_out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"mesh rank {r} exited {p.returncode}: "
                                   f"{err.decode(errors='replace')[-3000:]}")
        span = time.perf_counter() - t0
        want_arr = np.array(want, np.int64).reshape(-1, 3)
        want_counts = np.bincount(want_arr[:, 1], minlength=2 * len(PATS))
        res = {}
        for r in range(MESH_RANKS):
            d = np.load(os.path.join(tmp, f"rank{r}.npz"))
            if tuple(d["got"]) != (r, MESH_RANKS):
                raise AssertionError(f"rank {r}: init_distributed gave "
                                     f"{tuple(d['got'])}")
            if not np.array_equal(d["counts"], want_counts):
                raise AssertionError(f"rank {r}: sharded_scan_counts_2d "
                                     "differs from the unsharded hits")
            for key in ("hits", "hits1"):
                if not np.array_equal(d[key].reshape(-1, 3), want_arr):
                    raise AssertionError(f"rank {r}: {key} of "
                                         "sharded_pallas_scan_hits_2d "
                                         "differs from the unsharded stream")
            res[r] = (int(d["launches"]), float(d["wall"]))
            if res[r][0] < MESH_N // MESH_RANKS:
                raise AssertionError(f"rank {r} launched scan_occupancy "
                                     f"{res[r][0]} times")
    log(f"2 x 2 mesh across {MESH_RANKS} processes (gloo), each rank two "
        f"entries of cuda:0, n=2^24, P=20 on {smi}: both ranks' counts "
        f"== the unsharded hits per pattern, hit streams (and at cap 1) "
        f"== the unsharded stream ({len(want)} hits); per rank "
        f"scan_occupancy launches "
        f"{[res[r][0] for r in range(MESH_RANKS)]}, scan wall "
        f"{[round(res[r][1], 6) for r in range(MESH_RANKS)]} s; "
        f"{span:.1f} s with bring-up")
    return res


def mesh_phase(smi, dev, db, ps, got, s_main, got1, s_k1, sdb, psl, gotl,
               blocks, want_blocks, s_stream):
    """Phase 19: each path of the main configurations over
    ``make_mesh([cuda:0] * 4)`` equals its unsharded result, with its
    launches (one a shard), uploads (one a shard per database) and wall
    beside the unsharded wall; then the 2 x 2 mesh across two
    processes."""
    import torch

    from sequence_alignment_tools_tpu_torch.models.primer_match import (
        PrimerMatchModel,
    )
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
        ConvScanner,
        device_form,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
        scan_occupancy,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.seed_gate import (
        seed_gate,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.sellers import (
        sellers_scan,
    )
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
    from sequence_alignment_tools_tpu_torch.parallel import shard

    mesh = shard.make_mesh([dev] * MESH_N)
    codes = db.codes
    summary = {}

    def counted(label, fn, kernels, want, per_run):
        """Run ``fn`` once with the counts at 0: its result must equal
        ``want`` and each kernel launch at least once a shard (more on an
        overflow retry); returns (launches, uploads)."""
        uploads = device_form.uploads
        ran = Launches()
        out = fn()
        launches = {k.__name__: ran[k.__name__] for k in kernels}
        if out != want:
            raise AssertionError(f"mesh: {label} differs from unsharded")
        if any(v < MESH_N * per_run for v in launches.values()):
            raise AssertionError(f"mesh: {label} launches {launches}, "
                                 f"want {MESH_N * per_run} each at least")
        return launches, device_form.uploads - uploads

    # the exact main path at 2^28, P = 20
    sc = ConvScanner(build_tables(ps, db, wc=False, textn=False), k=0,
                     device=dev)
    sc.mesh = mesh
    launches, uploads = counted("exact scan, 2^28", lambda: list(
        sc.scan(codes)), [scan_occupancy], got, 1)
    wall, _ = wall_median(lambda: sum(1 for _ in sc.scan(codes)), 5)
    again = device_form.uploads
    list(sc.scan(codes))
    if uploads != MESH_N or device_form.uploads != again:
        raise AssertionError(f"mesh: exact scan uploaded {uploads}, then "
                             f"{device_form.uploads - again}")
    s0 = shard._shards_form(codes, mesh, sc.tables.Lmax - 1, EOS)[0]
    dt = sc._tables_dev()
    shard_ms = cuda_ms(lambda: scan_occupancy(
        s0.codes, dt.weights16, dt.thresholds, s0.n, EOS), reps=10)
    summary["exact 2^28"] = dict(launches=launches, uploads=uploads,
                                 wall_s=wall, unsharded_s=s_main,
                                 shard_kernel_ms=shard_ms)
    log(f"mesh exact scan, n=2^28 over {MESH_N} x cuda:0, P=20 on {smi}: "
        f"{len(got)} hits == unsharded; launches {launches}, uploads "
        f"{uploads} (then 0 per scan); {wall:.6f} s per scan against "
        f"{s_main:.6f} unsharded (host clock, median of 5); "
        f"scan_occupancy per 2^26 shard {shard_ms:.4f} ms (CUDA events)")

    # the k = 1 serving stream: the halves engine's gated route per shard
    m1 = PrimerMatchModel(db, ps, k=1, indels=True, device=dev, mesh=mesh)
    uploads0 = device_form.uploads
    launches, _u = counted("k=1 engine_hits, 2^28", lambda: list(
        m1.engine_hits()), [scan_occupancy, seed_gate], got1, 1)
    runs = list(m1.engine_hits_stream(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = list(m1.engine_hits_stream(5))
    s_k1m = (time.perf_counter() - t0) / 5
    uploads = device_form.uploads - uploads0
    if runs != [got1] * 5 or uploads != MESH_N:
        raise AssertionError(f"mesh: k=1 stream differs or uploaded "
                             f"{uploads}")
    summary["k=1 stream 2^28"] = dict(launches=launches, uploads=uploads,
                                      wall_s=s_k1m, unsharded_s=s_k1)
    log(f"mesh k=1 engine_hits_stream (halves, gated route per shard), "
        f"n=2^28 over {MESH_N} x cuda:0 on {smi}: {len(got1)} engine hits "
        f"== unsharded per run; launches per run {launches}, uploads "
        f"{uploads} for 7 runs; {s_k1m:.6f} s per run against "
        f"{s_k1:.6f} unsharded (host clock, 5 runs)")

    # -k 2 on the Sellers configuration: sellers.cu per shard
    ml = PrimerMatchModel(sdb, psl, k=2, indels=True, device=dev, mesh=mesh)
    mu = PrimerMatchModel(sdb, psl, k=2, indels=True, device=dev, mesh=None)
    mu.use_host = False
    launches, uploads = counted("Sellers route -k 2, 2^26", lambda: list(
        ml.engine_hits()), [sellers_scan], gotl, 1)
    wall, _ = wall_median(lambda: list(ml.engine_hits()), 3)
    wall_u, hits_u = wall_median(lambda: list(mu.engine_hits()), 3)
    if hits_u != gotl:
        raise AssertionError("mesh: the unsharded Sellers route changed")
    scl = ml._filter_ctx()[0]
    s0 = shard._shards_form(sdb.codes, mesh, 0, EOS,
                            scl.tables.Lmax + 2)[1]
    st = scl._sellers_t()
    cap = scl._cap("sellers", s0.n)
    shard_ms = cuda_ms(lambda: sellers_scan(s0.codes, s0.n, st, EOS, 2,
                                            True, cap), reps=5)
    summary["Sellers -k 2 2^26"] = dict(launches=launches, uploads=uploads,
                                        wall_s=wall, unsharded_s=wall_u,
                                        shard_kernel_ms=shard_ms)
    log(f"mesh Sellers route -k 2 (sellers.cu per shard), n=2^26, P=48 "
        f"over {MESH_N} x cuda:0 on {smi}: {len(gotl)} engine hits == "
        f"unsharded; launches {launches}, uploads {uploads}; engine_hits "
        f"{wall:.6f} s against {wall_u:.6f} unsharded (the pairs route, "
        f"host clock, median of 3); sellers_scan per shard (2^24 and a "
        f"left halo) {shard_ms:.4f} ms (CUDA events)")

    # the streamed path: 16 host blocks of 2^24, and one resident block
    sb = ConvScanner(sc.tables, k=0, device=dev)
    sb.mesh = mesh
    uploads0 = device_form.uploads
    ran = Launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_blocks = dict(sb.scan_stream(iter(blocks)))
    wall = time.perf_counter() - t0
    launches = ran["scan_occupancy"]
    uploads = device_form.uploads - uploads0
    if [got_blocks[i] for i in range(len(blocks))] != want_blocks:
        raise AssertionError("mesh: scan_stream differs from unsharded")
    if launches < MESH_N * len(blocks) or uploads != MESH_N * len(blocks):
        raise AssertionError(f"mesh: stream launches {launches}, uploads "
                             f"{uploads}")
    summary["stream 16 x 2^24"] = dict(
        launches={"scan_occupancy": launches}, uploads=uploads,
        wall_s=wall, unsharded_s=s_stream)
    log(f"mesh scan_stream, 16 x 2^24 host blocks over {MESH_N} x cuda:0 "
        f"on {smi}: == unsharded per block; launches {launches}, uploads "
        f"{uploads}; {wall:.6f} s against {s_stream:.6f} unsharded "
        f"(uploads included)")

    summary["2 x 2 ranks 2^24"] = mesh_ranks(smi, blocks[0].copy(),
                                            want_blocks[0])
    log("mesh summary: " + json.dumps(summary, default=str))
    del sc, sb, m1, ml, mu
    return summary


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.io.patterns import build_pattern_set
    from sequence_alignment_tools_tpu_torch.ops.host_scan import HostShiftAnd
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
        ConvScanner,
        device_form,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda import build
    from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
        filter_tables,
        scan_occupancy,
        scan_occupancy_ref,
    )
    from sequence_alignment_tools_tpu_torch.ops.tables import (
        DeviceTables,
        device_tables,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(sorted(libs))})")
    parents = parent_kernels()
    parent = parents.get("scan_filter")
    log("older kernels: " + (", ".join(sorted(parents)) + " built from "
                             + PARENT_DIR if parents else
                             "not unpacked here, no comparison"))
    # 2. kernel against plain at the serving block size
    db, planted, variants = make_db(MAIN_N, SEED)
    codes = db.codes
    ps = build_pattern_set(PATS, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    blk_dev = torch.from_numpy(codes[:BLOCK_N].copy()).to(dev)
    dt0 = device_tables(tables, 0, False, dev)
    dt1 = device_tables(tables, 1, True, dev)
    rng = np.random.default_rng(SEED + 1)

    def random_set(count, lo, hi):
        pats = random_pats(rng, count - len(PATS), lo, hi)
        t = build_tables(build_pattern_set(PATS + pats, rev_comp=False), db,
                         wc=False, textn=False)
        return device_tables(t, 0, False, dev)

    dt150 = random_set(150, 12, 20)
    dt2048 = random_set(2048, 14, 24)
    long_pats = random_pats(rng, 2, 140, 140)
    long_tables = build_tables(build_pattern_set(long_pats, rev_comp=True),
                               db, wc=False, textn=False)
    wdb, wpats = iupac_db(1 << 20, SEED + 2)
    wtables = build_tables(build_pattern_set(wpats, rev_comp=True), wdb,
                           wc=True, textn=False)
    wdev = torch.from_numpy(wdb.codes.copy()).to(dev)
    # the bit-parallel filter's other forms: counter planes (-K 2, k = 3,
    # k = 1 over 2048 patterns), IUPAC classes, a 41-code alphabet, and
    # per-code mask rows (random accept sets, more classes than codes)
    rng2 = np.random.default_rng(SEED + 9)
    xdb, xpats = wide_db(1 << 20, SEED + 8)
    xtables = build_tables(build_pattern_set(xpats, rev_comp=False), xdb,
                           wc=False, textn=False)
    xdev = torch.from_numpy(xdb.codes.copy()).to(dev)
    t33 = build_tables(build_pattern_set(random_pats(rng2, 6, 25, 33),
                                         rev_comp=True),
                       db, wc=False, textn=False)
    t2048 = build_tables(build_pattern_set(
        PATS + random_pats(rng2, 2038, 14, 24), rev_comp=False), db,
        wc=False, textn=False)
    w_rand = (rng2.random((10, xtables.alpha, 60)) < 0.3).astype(np.int16)
    w_rand[:, xdb.eos_code, :] = 0
    rand_dt = DeviceTables(
        weights=torch.from_numpy(w_rand.astype(np.float32)).to(dev),
        weights16=torch.from_numpy(w_rand).to(dev),
        thresholds=torch.full((60,), 9, dtype=torch.int32, device=dev),
        lengths=torch.full((60,), 10, dtype=torch.int32, device=dev))
    max_err = check_kernels([
        ("k=0", blk_dev, BLOCK_N, dt0),
        ("k=1 poison", blk_dev, BLOCK_N, dt1),
        ("odd n", blk_dev, BLOCK_N - 12345, dt0),
        ("P=150", blk_dev, BLOCK_N, dt150),
        ("P=2048 (pattern chunks)", blk_dev[: 1 << 20], 1 << 20, dt2048),
        ("Lmax=140", blk_dev[: 1 << 20], 1 << 20,
         device_tables(long_tables, 1, True, dev)),
        ("IUPAC alphabet", wdev, len(wdb.codes),
         device_tables(wtables, 0, False, dev)),
        ("-K 2 poison", blk_dev, BLOCK_N, device_tables(tables, 2, True, dev)),
        ("IUPAC alphabet, k=1 poison", wdev, len(wdb.codes),
         device_tables(wtables, 1, True, dev), wdb.eos_code),
        ("41-code alphabet", xdev, len(xdb.codes),
         device_tables(xtables, 0, False, dev), xdb.eos_code),
        ("41-code alphabet, k=1 poison", xdev, len(xdb.codes) - 7,
         device_tables(xtables, 1, True, dev), xdb.eos_code),
        ("Lmax=33, k=3 poison", blk_dev[: 1 << 22], 1 << 22,
         device_tables(t33, 3, True, dev)),
        ("P=2048, k=1 poison", blk_dev[: 1 << 20], 1 << 20,
         device_tables(t2048, 1, True, dev)),
        ("per-code mask rows (600 random accept sets)", xdev,
         len(xdb.codes), rand_dt, xdb.eos_code),
    ], dev)
    del xdev
    k_ms = cuda_ms(lambda: scan_occupancy(
        blk_dev, dt0.weights16, dt0.thresholds, BLOCK_N, EOS), reps=20)
    p_ms = cuda_ms(lambda: scan_occupancy_ref(
        blk_dev, dt0.weights16, dt0.thresholds, BLOCK_N, EOS), reps=10)
    log(f"scan_occupancy at n=2^24, P=20, k=0 on {smi}: kernel {k_ms:.4f} "
        f"ms, plain {p_ms:.4f} ms (CUDA events, median)")
    del blk_dev

    # 3. main path: the fused scan over a resident 2^28-position database
    host = HostShiftAnd(tables, 0, False)
    if not host.available():
        raise RuntimeError("native shift-and library unavailable: no "
                           "reference for the main path")
    t0 = time.perf_counter()
    want = list(host.scan(codes))
    log(f"host shift-and reference: {len(want)} hits in "
        f"{time.perf_counter() - t0:.3f} s")
    sc = ConvScanner(tables, k=0, device=dev)
    sc.use_host = False
    ran = Launches()
    got = list(sc.scan(codes))
    main_launches = ran["scan_occupancy"]
    if main_launches < 1:
        raise AssertionError("main path never launched scan_occupancy")
    if got != want:
        raise AssertionError(
            f"fused scan differs from host shift-and: {len(got)} vs "
            f"{len(want)} hits")
    ends = {(e, p) for e, p, _ in got}
    lengths = tables.lengths
    for at, s in planted:
        pid = next(p for p in range(tables.P) if ps.pattern(p + 1) == s)
        if (at + int(lengths[pid]), pid) not in ends:
            raise AssertionError(f"planted {s} at {at} not found")
    log(f"main path: {len(got)} hits == host shift-and, all "
        f"{len(planted)} plants found, scan_occupancy launches "
        f"{main_launches}")
    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_hits = sum(1 for _ in sc.scan(codes))
        secs.append(time.perf_counter() - t0)
        if n_hits != len(want):
            raise AssertionError("repeated scan changed its hit count")
    s_main = statistics.median(secs)
    log(f"main path scan, n=2^28 resident, P=20, k=0 on {smi}: "
        f"{s_main:.6f} s per scan, {MAIN_N / s_main / 1e9:.3f} Gbases/s "
        f"(host clock, median of 5)")
    main_dev = device_form(codes, sc.device)
    dt = sc._tables_dev()
    got_occ = scan_occupancy(main_dev, dt.weights16, dt.thresholds, MAIN_N,
                             EOS)
    want_occ = scan_occupancy_ref(main_dev, dt.weights16, dt.thresholds,
                                  MAIN_N, EOS)
    if not torch.equal(got_occ, want_occ):
        raise AssertionError("scan_occupancy differs from plain at 2^28")
    k28 = cuda_ms(lambda: scan_occupancy(
        main_dev, dt.weights16, dt.thresholds, MAIN_N, EOS), reps=10)
    p28 = cuda_ms(lambda: scan_occupancy_ref(
        main_dev, dt.weights16, dt.thresholds, MAIN_N, EOS), reps=1)
    log(f"scan_occupancy at n=2^28, P=20, k=0 on {smi}: kernel {k28:.4f} "
        f"ms, plain {p28:.4f} ms (CUDA events, median; equal)")

    # 3c. yardsticks: the filter on the k = 1 seeds and -K 2 at 2^28, the
    # parent commit's kernel on each shape (parent, new, new, parent),
    # and the census kernel over the same 20 literal primers
    from sequence_alignment_tools_tpu_torch.ops.cuda.slots import scan_slots

    _e, dt_seed, _g = gate_setup(db, PATS, 1, True, dev)
    dt_k2 = device_tables(tables, 2, True, dev)
    filter_ms = {}
    for label, cd, n, d, reps in (
            ("2^24, P=20, k=0", main_dev[:BLOCK_N], BLOCK_N, dt, 20),
            ("2^28, P=20, k=0", main_dev, MAIN_N, dt, 10),
            ("2^28, 40 half seeds (k=1 path)", main_dev, MAIN_N, dt_seed, 10),
            ("2^28, -K 2 poison, P=20", main_dev, MAIN_N, dt_k2, 10)):
        args = (cd, d.weights16, d.thresholds, n, EOS)
        occ_new = scan_occupancy(*args)
        if "half seeds" in label or "-K 2" in label:
            if not torch.equal(occ_new, scan_occupancy_ref(*args)):
                raise AssertionError(f"scan_occupancy differs from plain: "
                                     f"{label}")
        if parent is None:
            filter_ms[label] = (cuda_ms(lambda: scan_occupancy(*args),
                                        reps=reps), None)
            log(f"scan_occupancy at {label} on {smi}: kernel "
                f"{filter_ms[label][0]:.4f} ms (CUDA events, median)")
            continue
        if not torch.equal(parent(*args), occ_new):
            raise AssertionError(f"parent kernel differs: {label}")
        filter_ms[label] = beside_parent(
            f"scan_occupancy at {label} (equal occupancy)",
            lambda: scan_occupancy(*args), lambda: parent(*args), reps, smi)
    mt20 = sc._mer_dev()
    cap20 = sc._slot_cap_for(MAIN_N)
    ends_c, pids_c = sc._census_device(codes, MAIN_N, sort=True)
    if list(zip(ends_c.tolist(), pids_c.tolist())) != [
            (e, p) for e, p, _m in got]:
        raise AssertionError("census over the 20 primers differs from the "
                             "main path's hits")
    census_ms = cuda_ms(lambda: scan_slots(main_dev, MAIN_N, mt20, cap20),
                        reps=10)
    if "seed_slots" in parents:
        census_ms, _old = beside_parent(
            "census yardstick, scan_slots over the 20 literal primers",
            lambda: scan_slots(main_dev, MAIN_N, mt20, cap20),
            lambda: parents["seed_slots"](main_dev, MAIN_N, mt20, cap20), 10,
            smi)
    log(f"census yardstick: scan_slots over the 20 literal primers "
        f"({len(mt20.lens)} length classes), n=2^28 on {smi}: "
        f"{census_ms:.4f} ms (CUDA events, median), {len(ends_c)} hits == "
        f"the main path's; bit-parallel filter "
        f"{filter_ms['2^28, P=20, k=0'][0]:.4f} ms")
    del main_dev, got_occ, want_occ

    # 3b. the same device route on the shapes the TPU kernel gated off
    small = codes[: 1 << 16]
    device_route_vs_host("n=2^16", tables, small, dev)
    long_codes = codes[(1 << 20) : (1 << 20) + (1 << 18)].copy()
    for i, p in enumerate(long_pats):
        at = 5000 + 90_000 * i
        long_codes[at : at + len(p)] = [TABLE.index(c.encode()) for c in p]
    device_route_vs_host("Lmax=140", long_tables, long_codes, dev)
    device_route_vs_host("IUPAC -w", wtables, wdb.codes, dev)

    # 4. serving: scan_stream over 16 blocks of 2^24
    blocks = [codes[i * BLOCK_N : (i + 1) * BLOCK_N] for i in range(16)]
    want_blocks = [list(sc.scan(b)) for b in blocks]
    ran = Launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_blocks = dict(sc.scan_stream(iter(blocks)))
    s_stream = time.perf_counter() - t0
    stream_launches = ran["scan_occupancy"]
    if [got_blocks[i] for i in range(16)] != want_blocks:
        raise AssertionError("scan_stream differs from per-block scan")
    if stream_launches < 16:
        raise AssertionError("scan_stream did not launch per block")
    log(f"scan_stream, 16 x 2^24 host blocks (uploads included) on {smi}: "
        f"{s_stream:.6f} s, {16 * BLOCK_N / s_stream / 1e9:.3f} Gbases/s")
    resident = blocks[0]
    list(sc.scan_stream(resident for _ in range(4)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _i, hits in sc.scan_stream(resident for _ in range(64)):
        if hits != want_blocks[0]:
            raise AssertionError("resident scan_stream changed its hits")
    s_res = time.perf_counter() - t0
    log(f"scan_stream, 64 reps of one resident 2^24 block on {smi}: "
        f"{s_res / 64:.6f} s per block, "
        f"{64 * BLOCK_N / s_res / 1e9:.3f} Gbases/s")
    profile("main path scan, n=2^28 resident, P=20, k=0",
            lambda: list(sc.scan(codes)), 5)
    profile("scan_stream, resident 2^24 block x 64",
            lambda: list(sc.scan_stream(resident for _ in range(64))), 1)
    profile("scan_stream, 16 distinct 2^24 host blocks",
            lambda: list(sc.scan_stream(iter(blocks))), 1)

    # 5. seed_gate against plain: the k > 0 seed scan's second kernel
    from sequence_alignment_tools_tpu_torch.models.primer_match import (
        PrimerMatchModel,
    )
    from sequence_alignment_tools_tpu_torch.ops.compact import compact_mask
    from sequence_alignment_tools_tpu_torch.ops.cuda.seed_gate import (
        gated_hits,
        seed_gate,
        seed_gate_ref,
    )

    gate_n = 1 << 22
    gate_dev = torch.from_numpy(codes[:gate_n].copy()).to(dev)
    nmb22 = gate_n // 32
    cases = []
    setups = {}
    for name, k, indels, node, tplen in (
            ("halves k=1", 1, True, 0, 0), ("halves -K 1", 1, False, 0, 0),
            ("halves k=2 (node 11)", 2, True, 11, 0),
            ("bases k=1 (-3 8)", 1, True, 0, 8)):
        engine, dt_s, gt = gate_setup(db, PATS, k, indels, dev, node=node,
                                      tplen=tplen)
        if engine != name.split()[0]:
            raise AssertionError(f"{name}: engine {engine}")
        cases.append((name, gate_dev, gate_n, dt_s, gt, indels, nmb22,
                      1 << 16))
        setups[name] = (dt_s, gt)
    dt_h, gt_h = setups["halves k=1"]
    cases.append(("halves k=1, odd n", gate_dev, gate_n - 12345, dt_h,
                  gt_h, True, nmb22, 1 << 16))
    _e, dt_big, gt_big = gate_setup(
        db, random_pats(rng, 1024, 14, 24), 1, True, dev, rev_comp=False)
    cases.append(("2048 seeds (pattern chunks, gate bits via __ldg)",
                  gate_dev[: 1 << 20], 1 << 20, dt_big, gt_big, True,
                  1 << 15, 1 << 16))
    cases.append(("overflow (2048 microblocks, cap 1), halves k=2",
                  gate_dev, gate_n, *setups["halves k=2 (node 11)"], True,
                  2048, 1))
    gate_err = check_seed_gate(cases)

    def gate_inputs(codes_dev, n):
        occ = scan_occupancy(codes_dev, dt_h.weights16, dt_h.thresholds, n,
                             EOS)
        return compact_mask(occ, n // 32)

    from sequence_alignment_tools_tpu_torch.ops.gate import GateTables

    def same_survivors(a, b):
        return a[0] == b[0] and a[1].tolist() == b[1].tolist() and \
            a[2].tolist() == b[2].tolist()

    S_h = int(dt_h.lengths.numel())
    # a gate that passes every seed hit: the kernel then counts the hits
    open_gate = GateTables(np.zeros((S_h, 1, gt_h.alpha), bool),
                           np.zeros(S_h, np.int32), np.ones(S_h, np.int32),
                           np.zeros(S_h, np.int32), 1, 1).to(dev)
    timings = {}
    for label, codes_dev, n in (("2^22", gate_dev, gate_n),
                                ("2^28", device_form(codes, sc.device),
                                 MAIN_N)):
        mbc, mbi = gate_inputs(codes_dev, n)
        cap_g = 1 << 16

        def run_gate():
            return seed_gate(codes_dev, n, dt_h, mbc, mbi, gt_h, EOS, True,
                             cap_g)

        want_g = survivor_set(seed_gate_ref(codes_dev, n, dt_h, mbc, mbi,
                                            gt_h, EOS, True, cap_g), cap_g)
        if not same_survivors(survivor_set(run_gate(), cap_g), want_g):
            raise AssertionError(f"seed_gate differs from plain at {label}")
        g_ms = cuda_ms(run_gate, reps=10)
        if "seed_gate" in parents:
            old_g = survivor_set(parents["seed_gate"](
                codes_dev, n, dt_h, mbc, mbi, gt_h, EOS, True, cap_g), cap_g)
            if not same_survivors(old_g, want_g):
                raise AssertionError(f"parent seed_gate differs at {label}")
            g_ms, _old = beside_parent(
                f"seed_gate at n={label}, halves k=1 (40 seeds; equal "
                f"survivors)", run_gate,
                lambda: parents["seed_gate"](codes_dev, n, dt_h, mbc, mbi,
                                             gt_h, EOS, True, cap_g), 10,
                smi)
        r_ms = cuda_ms(lambda: seed_gate_ref(codes_dev, n, dt_h, mbc, mbi,
                                             gt_h, EOS, True, cap_g),
                       reps=3)
        row = gated_hits(codes_dev, n, dt_h, gt_h, EOS, True, n // 32,
                         cap_g)
        n_hits = int(seed_gate(codes_dev, n, dt_h, mbc, mbi, open_gate, EOS,
                               True, 1)[0])
        timings[label] = (g_ms, r_ms)
        gate_counts = (int(row[0]), int(row[1]), n_hits)
        log(f"seed_gate at n={label}, halves k=1 (40 seeds) on {smi}: "
            f"kernel {g_ms:.4f} ms, plain {r_ms:.4f} ms (CUDA events, "
            f"median); {int(row[0])} of {n // 32} microblocks are "
            f"candidates, {n_hits} seed hits, {int(row[1])} gate survivors")
    del gate_dev

    # 6. the k = 1 main path: halves engine over the resident 2^28 database
    ps1 = build_pattern_set(PATS, rev_comp=True)
    m_dev = PrimerMatchModel(db, ps1, k=1, indels=True, device=dev)
    m_dev.use_host = False
    if m_dev.engine != "halves":
        raise AssertionError(f"k=1 main path took engine {m_dev.engine}")
    m_host = PrimerMatchModel(db, ps1, k=1, indels=True, device=dev)
    m_host.use_host = True
    t0 = time.perf_counter()
    want1 = list(m_host.engine_hits())
    log(f"k=1 host route (native shift-and seeds, batched extension): "
        f"{len(want1)} engine hits in {time.perf_counter() - t0:.3f} s")
    ran = Launches()
    got1 = list(m_dev.engine_hits())
    k1_launches = {"scan_occupancy": ran["scan_occupancy"],
                   "seed_gate": ran["seed_gate"]}
    if min(k1_launches.values()) < 1:
        raise AssertionError(f"k=1 main path skipped a kernel: {k1_launches}")
    if got1 != want1 or not got1:
        raise AssertionError(f"k=1 device route differs from host route: "
                             f"{len(got1)} vs {len(want1)} engine hits")
    pid_of = {}
    for pid in range(ps1.n_total, 0, -1):
        pid_of[ps1.pattern(pid)] = pid
    ends_of = {}
    for end, pid, _v in got1:
        ends_of.setdefault(pid, []).append(end)
    covered = [(at, s, s) for at, s in planted] + [
        (at, s, v) for at, s, v, ne in variants if ne == 1]
    for at, s, v in covered:
        if not any(abs(e - (at + len(v))) <= 2
                   for e in ends_of.get(pid_of[s], ())):
            raise AssertionError(f"k=1: planted {v} ({s}) at {at} not found")
    log(f"k=1 main path: {len(got1)} engine hits == host route, all "
        f"{len(covered)} exact and 1-edit plants found, launches "
        f"{k1_launches}")
    list(m_dev.engine_hits_stream(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = list(m_dev.engine_hits_stream(5))
    s_k1 = time.perf_counter() - t0
    if runs != [got1] * 5:
        raise AssertionError("k=1 engine_hits_stream changed its hits")
    log(f"k=1 engine_hits_stream, n=2^28 resident, P=20 (40 half seeds) on "
        f"{smi}: {s_k1 / 5:.6f} s per run, {5 * MAIN_N / s_k1 / 1e9:.3f} "
        f"Gbases/s (host clock, 5 runs)")
    _o, sc1, _b, dirs, ext, geomB = m_dev._halves_ctx()
    ends, hids = m_dev._seed_candidates(sc1, dirs, ext, geomB,
                                        lambda p0: p0 + 1)
    t0 = time.perf_counter()
    for _ in range(5):
        m_dev._halves_emit_arrays(ends, hids)
    log(f"k=1 host tail (native extension + dedup) of {len(ends)} gate "
        f"survivors: {(time.perf_counter() - t0) / 5 * 1e3:.3f} ms per run")
    profile("k=1 main path, engine_hits, n=2^28 resident, P=20",
            lambda: list(m_dev.engine_hits()), 3)
    del m_host

    # 7. the k-edit kernels against plain on EOS-dense text
    from sequence_alignment_tools_tpu_torch.ops.cuda.myers import (
        myers_pairs,
        myers_pairs_ref,
        myers_tables,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.sellers import (
        sellers_ref,
        sellers_scan,
        sellers_tables,
    )

    kr = np.random.default_rng(SEED + 3)
    dense = codes[:KEDIT_N].copy()
    dense[kr.integers(0, KEDIT_N, size=KEDIT_N // 3000)] = EOS
    dense[3_000_000 : 3_004_000 : 11] = EOS  # entries shorter than a halo
    kdb = SeqDB(codes=dense, table=TABLE, entry_starts=np.array([0]),
                entry_lengths=np.array([KEDIT_N]), headers=["dense"])
    ktext = "".join("ACGT"[c] if c < 4 else "A" for c in dense[:400_000])
    sel_pats = [edit(kr, ktext[3_900 * i : 3_900 * i + int(ln)],
                     ("sub", "del")[: i % 3])
                for i, ln in enumerate(kr.integers(60, 101, size=50))]
    kdev = torch.from_numpy(dense).to(dev)
    mt_b = myers_tables(build_tables(build_pattern_set(PATS, rev_comp=True),
                                     kdb, wc=False, textn=False)).to(dev)
    st_l = sellers_tables(build_tables(
        build_pattern_set(sel_pats, rev_comp=True), kdb, wc=False,
        textn=False)).to(dev)
    st_w = sellers_tables(build_tables(
        build_pattern_set(wpats[:6] + ["ACGRYTNNSWKTACGTTGCAAC"],
                          rev_comp=True), wdb, wc=True, textn=False)).to(dev)
    weos = int(wdb.eos_code)
    kcases = [(f"bench primers k={k} ({mt_b.nw} packed words)",
               "myers_pairs", kdev, KEDIT_N, mt_b, EOS, k, True, 1 << 20)
              for k in (1, 2, 3)]
    kcases.append(("bench primers k=3, cap 1", "myers_pairs", kdev, KEDIT_N,
                   mt_b, EOS, 3, True, 1))
    kcases += [(f"P={st_l.P} Lmax={st_l.Lmax} k={k}", "sellers_scan", kdev,
                KEDIT_N, st_l, EOS, k, True, 1 << 20) for k in (1, 2, 4)]
    kcases += [
        (f"P={st_l.P} k=2 without indels", "sellers_scan", kdev, KEDIT_N,
         st_l, EOS, 2, False, 1 << 20),
        ("IUPAC -w, k=2", "sellers_scan", wdev, len(wdb.codes), st_w, weos,
         2, True, 1 << 20),
        (f"P={st_l.P} k=2, cap 1", "sellers_scan", kdev, KEDIT_N, st_l, EOS,
         2, True, 1)]
    # patterns of 2,800 to 3,200 bases (and reverse complements): about
    # 100 words each, all but the first in device scratch
    xl_n = 1 << 21
    xl_text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:xl_n])
    xl_pats = [edit(kr, xl_text[400_000 * i + 5 : 400_000 * i + 5 + ln],
                    ("sub", "del", "ins")[: i % 3])
               for i, ln in enumerate(kr.integers(2800, 3201, size=4))]
    st_xl = sellers_tables(build_tables(
        build_pattern_set(xl_pats, rev_comp=True), db, wc=False,
        textn=False)).to(dev)
    # and of 7,200 to 7,600 bases: about 232 words each
    xxl_pats = [edit(kr, xl_text[500_000 * i + 9 : 500_000 * i + 9 + ln],
                     ("sub", "ins")[: i % 2])
                for i, ln in enumerate(kr.integers(7200, 7601, size=2))]
    st_xxl = sellers_tables(build_tables(
        build_pattern_set(xxl_pats, rev_comp=True), db, wc=False,
        textn=False)).to(dev)
    xl_dev = torch.from_numpy(codes[:xl_n].copy()).to(dev)
    kcases += [
        (f"P={st_xl.P} Lmax={st_xl.Lmax} k=2",
         "sellers_scan", xl_dev, xl_n, st_xl, EOS, 2, True, 1 << 20),
        (f"P={st_xxl.P} Lmax={st_xxl.Lmax} k=2", "sellers_scan",
         xl_dev[: 1 << 20], 1 << 20, st_xxl, EOS, 2, True, 1 << 20)]
    # allvall -r's chunk at its path's shape: 2,048 query mers of 20
    # bases and their reverse complements (P = 4,096), k = 1 with indels;
    # the query random with text segments planted among its first mers,
    # exact, with a substitution and with a deletion
    aq = bytearray(random_dna(kr, 4_096))
    for i, kinds in enumerate(((), ("sub",), ("del",), ())):
        seg = ktext[50_000 + 80_000 * i : 50_060 + 80_000 * i]
        seg = edit(kr, seg, kinds) if kinds else seg
        aq[200 + 450 * i : 200 + 450 * i + len(seg)] = seg.encode()
    st_av = sellers_tables(allvall_chunk(aq.decode(), kdb)).to(dev)
    kcases.append((f"allvall -r chunk P={st_av.P} Lmax={st_av.Lmax} k=1",
                   "sellers_scan", kdev, 1 << 20, st_av, EOS, 1, True,
                   1 << 20))
    # past one launch's patterns and past byte-sized k: allvall -r's chunk
    # widened to 35,000 query mers and their reverse complements (P =
    # 70,000: two launches of sellers.cu), k = 2 with indels; and k = 255
    # over two 300-base patterns cut from the text with edits and their
    # reverse complements, with and without indels (16 counter planes);
    # each over the first 2^15 positions
    br = np.random.default_rng(SEED + 23)
    bq = bytearray(random_dna(br, 35_019))
    for i, kinds in enumerate(((), ("sub",), ("del",), ())):
        seg = ktext[7_000 + 6_000 * i : 7_060 + 6_000 * i]
        seg = edit(br, seg, kinds) if kinds else seg
        bq[1_000 + 8_000 * i : 1_000 + 8_000 * i + len(seg)] = seg.encode()
    t_big = allvall_chunk(bq.decode(), kdb, count=35_000)
    st_big = sellers_tables(t_big).to(dev)
    st_255 = sellers_tables(build_tables(build_pattern_set(
        [edit(br, ktext[9_000 + 11_000 * i : 9_300 + 11_000 * i],
              ("sub", "del", "ins")[: i + 1]) for i in range(2)],
        rev_comp=True), kdb, wc=False, textn=False)).to(dev)
    # the P = 70,000 case reads the main database's first entry (no EOS):
    # the native Sellers rows take Myers' column reset at an EOS, not the
    # row DP's (ROADMAP.md queue 3, standing), so they are its reference
    # only away from one; EOS-dense text is held against plain at k = 255
    big_dev = torch.from_numpy(codes[:BIG_N].copy()).to(dev)
    big_cases = [
        (f"P={st_big.P} (two launches) k=2", "sellers_scan", big_dev, BIG_N,
         st_big, EOS, 2, True, 1 << 20),
        (f"P={st_255.P} Lmax={st_255.Lmax} k=255", "sellers_scan", kdev,
         BIG_N, st_255, EOS, 255, True, 1 << 20),
        (f"P={st_255.P} Lmax={st_255.Lmax} k=255 without indels",
         "sellers_scan", kdev, BIG_N, st_255, EOS, 255, False, 1 << 20)]
    kcases += big_cases
    kedit_err = check_kedit(kcases)
    for name, _kind, cd, nn, st_, _eos, k, indels, cap in big_cases:
        b_ms = cuda_ms(lambda: sellers_scan(cd, nn, st_, EOS, k, indels,
                                            cap), reps=3)
        _r, b_plain = timed(lambda: sellers_ref(cd, nn, st_, EOS, k, indels,
                                                cap))
        log(f"sellers_scan {name} at n=2^15 on {smi}: kernel {b_ms:.4f} ms, "
            f"plain {b_plain:.4f} ms (CUDA events)")
    ran = Launches()
    big_row = sellers_scan(big_dev, BIG_N, st_big, EOS, 2, True, 1 << 20)
    big_launches = ran["sellers_scan"]
    t0 = time.perf_counter()
    ends, pids, dists = split_host_pairs(t_big, 2, codes[:BIG_N])
    s_native = time.perf_counter() - t0
    native = set(zip((ends - 1).tolist(), pids.tolist(), dists.tolist()))
    if big_launches != 2 or row_set(big_row, 1 << 20, 3)[1] != native \
            or len(native) < 4:
        raise AssertionError(f"sellers_scan at P={st_big.P}: {big_launches} "
                             "launches, or triples other than the native "
                             "Sellers rows'")
    log(f"sellers_scan at P={st_big.P}, k=2: {big_launches} launches, "
        f"{len(native)} triples == the native Sellers rows over pattern "
        f"groups ({s_native:.3f} s on 8 threads); k=255 held against "
        f"plain only (the native rows take k <= 8)")
    for k in (1, 2, 3):
        my22 = cuda_ms(lambda: myers_pairs(kdev, KEDIT_N, mt_b, EOS, k,
                                           1 << 20), reps=10)
        if "myers" in parents:
            if row_set(parents["myers"](kdev, KEDIT_N, mt_b, EOS, k,
                                        1 << 20), 1 << 20, 2) != row_set(
                    myers_pairs(kdev, KEDIT_N, mt_b, EOS, k, 1 << 20),
                    1 << 20, 2):
                raise AssertionError(f"parent myers differs at 2^22, k={k}")
            my22, _old = beside_parent(
                f"myers_pairs at n=2^22 (EOS-dense), P=20, k={k} (equal "
                f"pairs)",
                lambda: myers_pairs(kdev, KEDIT_N, mt_b, EOS, k, 1 << 20),
                lambda: parents["myers"](kdev, KEDIT_N, mt_b, EOS, k,
                                         1 << 20), 10, smi)
        log(f"myers_pairs at n=2^22 (EOS-dense), P=20 ({mt_b.nw} words), "
            f"k={k} on {smi}: kernel {my22:.4f} ms (CUDA events, median)")
    xl_ms = cuda_ms(lambda: sellers_scan(xl_dev, xl_n, st_xl, EOS, 2, True,
                                         1 << 20), reps=5)
    _r, xl_plain = timed(lambda: sellers_ref(xl_dev, xl_n, st_xl, EOS, 2,
                                             True, 1 << 20))
    xxl_ms = cuda_ms(lambda: sellers_scan(xl_dev, 1 << 20, st_xxl, EOS, 2,
                                          True, 1 << 20), reps=3)
    log(f"sellers_scan at n=2^21, P={st_xl.P}, Lmax={st_xl.Lmax}, k=2 on "
        f"{smi}: kernel {xl_ms:.4f} ms, plain {xl_plain:.4f} ms (CUDA "
        f"events); at n=2^20, P={st_xxl.P}, Lmax={st_xxl.Lmax}: kernel "
        f"{xxl_ms:.4f} ms")
    if "sellers" in parents:
        for label, cd, nn, st_, reps in (
                (f"n=2^21, P={st_xl.P}, Lmax={st_xl.Lmax}", xl_dev, xl_n,
                 st_xl, 3),
                (f"n=2^20, P={st_xxl.P}, Lmax={st_xxl.Lmax}", xl_dev,
                 1 << 20, st_xxl, 2)):
            want = sellers_scan(cd, nn, st_, EOS, 2, True, 1 << 20)
            if row_set(parents["sellers"](cd, nn, st_, EOS, 2, True,
                                          1 << 20), 1 << 20, 3) \
                    != row_set(want, 1 << 20, 3):
                raise AssertionError(f"parent sellers differs at {label}")
            beside_parent(
                f"sellers_scan at {label}, k=2 (equal triples)",
                lambda: sellers_scan(cd, nn, st_, EOS, 2, True, 1 << 20),
                lambda: parents["sellers"](cd, nn, st_, EOS, 2, True,
                                           1 << 20), reps, smi)
    del kdev, xl_dev

    # 8. the k = 2 main path: the filter engine (Myers route) at 2^28
    m2 = PrimerMatchModel(db, ps1, k=2, indels=True, device=dev)
    m2.use_host = False
    m2h = PrimerMatchModel(db, ps1, k=2, indels=True, device=dev)
    m2h.use_host = True
    if m2.engine != "filter":
        raise AssertionError(f"k=2 main path took engine {m2.engine}")
    sc2 = m2._filter_ctx()[0]
    if not sc2.myers_available(MAIN_N):
        raise AssertionError("k=2 main path: the Myers kernel declined")
    t0 = time.perf_counter()
    want2 = list(m2h.engine_hits())
    log(f"k=2 host route (native Sellers rows, cluster verify): "
        f"{len(want2)} engine hits in {time.perf_counter() - t0:.3f} s")
    ran = Launches()
    got2 = list(m2.engine_hits())
    k2_launches = {"myers_pairs": ran["myers_pairs"],
                   "sellers_scan": ran["sellers_scan"]}
    if k2_launches["myers_pairs"] < 1:
        raise AssertionError(f"k=2 main path skipped Myers: {k2_launches}")
    if got2 != want2 or not got2:
        raise AssertionError(f"k=2 device route differs from host route: "
                             f"{len(got2)} vs {len(want2)} engine hits")
    ends_of = {}
    for end, pid, _v in got2:
        ends_of.setdefault(pid, []).append(end)
    covered = [(at, s, s) for at, s in planted] + [
        (at, s, v) for at, s, v, ne in variants if ne <= 2]
    for at, s, v in covered:
        if not any(abs(e - (at + len(v))) <= 2
                   for e in ends_of.get(pid_of[s], ())):
            raise AssertionError(f"k=2: planted {v} ({s}) at {at} not found")
    log(f"k=2 main path: {len(got2)} engine hits == host route, all "
        f"{len(covered)} exact, 1- and 2-edit plants found, launches "
        f"{k2_launches}")
    try:
        list(m2.engine_hits_stream(2))  # starts the tail processes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs = list(m2.engine_hits_stream(5))
        s_k2 = time.perf_counter() - t0
    finally:
        m2.close()
    if runs != [got2] * 5:
        raise AssertionError("k=2 engine_hits_stream changed its hits")
    log(f"k=2 engine_hits_stream, n=2^28 resident, P=20 on {smi}: "
        f"{s_k2 / 5:.6f} s per run, {5 * MAIN_N / s_k2 / 1e9:.3f} Gbases/s "
        f"(host clock, 5 runs, host tail in worker processes)")
    sends, spids = sc2.scan_pairs(codes)
    t0 = time.perf_counter()
    for _ in range(3):
        list(m2._filter_emit(sends, spids))
    log(f"k=2 host tail (clusters + native verify) of {len(sends)} "
        f"candidates: {(time.perf_counter() - t0) / 3 * 1e3:.3f} ms per run")
    profile("k=2 main path, engine_hits, n=2^28 resident, P=20",
            lambda: list(m2.engine_hits()), 3)
    main_dev = device_form(codes, sc2.device)
    mt2 = sc2._myers_t()
    my_cap = sc2._cap("myers", MAIN_N)
    my_row = myers_pairs(main_dev, MAIN_N, mt2, EOS, 2, my_cap)
    my_ref, my_plain = timed(lambda: myers_pairs_ref(main_dev, MAIN_N, mt2,
                                                     EOS, 2, my_cap))
    if row_set(my_row, my_cap, 2) != row_set(my_ref, my_cap, 2):
        raise AssertionError("myers_pairs differs from plain at 2^28")
    my_ms = cuda_ms(lambda: myers_pairs(main_dev, MAIN_N, mt2, EOS, 2,
                                        my_cap), reps=10)
    if "myers" in parents:
        if row_set(parents["myers"](main_dev, MAIN_N, mt2, EOS, 2, my_cap),
                   my_cap, 2) != row_set(my_row, my_cap, 2):
            raise AssertionError("parent myers differs at 2^28")
        my_ms, _old = beside_parent(
            f"myers_pairs at n=2^28, P=20 ({mt2.nw} words), k=2 (equal "
            f"pairs)",
            lambda: myers_pairs(main_dev, MAIN_N, mt2, EOS, 2, my_cap),
            lambda: parents["myers"](main_dev, MAIN_N, mt2, EOS, 2, my_cap),
            10, smi)
    my_pairs_n = int(my_row[0])
    log(f"myers_pairs at n=2^28, P=20 ({mt2.nw} words), k=2 on {smi}: "
        f"kernel {my_ms:.4f} ms, plain {my_plain:.4f} ms (CUDA events; "
        f"equal; {my_pairs_n} pairs)")

    # 8c. a whole-genome panel's shape over a blocked scan
    blocked_panel_phase(db, main_dev, smi, dev)
    del main_dev, m2h

    # 8b. -K 2: the poisoned k-mismatch scan at 2^28
    mK = PrimerMatchModel(db, ps1, k=2, indels=False, device=dev)
    mK.use_host = False
    mKh = PrimerMatchModel(db, ps1, k=2, indels=False, device=dev)
    mKh.use_host = True
    wantK = list(mKh.engine_hits())
    ran = Launches()
    gotK = list(mK.engine_hits())
    if ran["scan_occupancy"] < 1:
        raise AssertionError("-K 2 main path never launched scan_occupancy")
    if gotK != wantK or not gotK:
        raise AssertionError(f"-K 2 device route differs from host route: "
                             f"{len(gotK)} vs {len(wantK)} engine hits")
    t0 = time.perf_counter()
    runs = list(mK.engine_hits_stream(3))
    s_K2 = time.perf_counter() - t0
    if runs != [gotK] * 3:
        raise AssertionError("-K 2 engine_hits_stream changed its hits")
    log(f"-K 2 main path: {len(gotK)} engine hits == host route (native "
        f"shift-and), engine_hits_stream {s_K2 / 3:.6f} s per run, "
        f"{3 * MAIN_N / s_K2 / 1e9:.3f} Gbases/s on {smi}")
    profile("-K 2 main path, engine_hits, n=2^28 resident, P=20",
            lambda: list(mK.engine_hits()), 3)
    del mK, mKh

    # 9. the Sellers route: long primers over the first 2^26 positions
    sub = codes[:SELLERS_N].copy()
    sub_eos = np.arange(0, SELLERS_N, ENTRY + 1)
    sub_starts = sub_eos + 1
    long_plants = plant_variants(sub, LONG, sub_starts,
                                 np.random.default_rng(SEED + 4), 300_000)
    sdb = SeqDB(codes=sub, table=TABLE, entry_starts=sub_starts,
                entry_lengths=np.minimum(ENTRY, SELLERS_N - sub_starts),
                headers=[f"chr{i} synthetic entry {i}"
                         for i in range(len(sub_starts))])
    psl = build_pattern_set(LONG, rev_comp=True)
    ml = PrimerMatchModel(sdb, psl, k=2, indels=True, device=dev)
    ml.use_host = False
    scl = ml._filter_ctx()[0]
    if ml.engine != "filter" or scl.myers_available(SELLERS_N) \
            or not scl.kernel_available(SELLERS_N):
        raise AssertionError("long primers did not take the Sellers route")
    t0 = time.perf_counter()
    hends, hpids, _d = split_host_pairs(scl.tables, 2, sub)
    wantl = list(ml._filter_emit(hends, hpids))
    log(f"Sellers route host reference (native Sellers rows over pattern "
        f"groups): {len(hends)} candidates, {len(wantl)} engine hits in "
        f"{time.perf_counter() - t0:.3f} s")
    ran = Launches()
    gotl = list(ml.engine_hits())
    sel_launches = {"myers_pairs": ran["myers_pairs"],
                    "sellers_scan": ran["sellers_scan"]}
    if sel_launches["sellers_scan"] < 1:
        raise AssertionError(f"Sellers route skipped the kernel: "
                             f"{sel_launches}")
    if gotl != wantl or not gotl:
        raise AssertionError(f"Sellers route differs from host route: "
                             f"{len(gotl)} vs {len(wantl)} engine hits")
    dends, dpids = scl.scan_pairs(sub)
    if set(zip(dends.tolist(), dpids.tolist())) != set(
            zip(hends.tolist(), hpids.tolist())):
        raise AssertionError("Sellers candidates differ from the host's")
    lpid = {}
    for pid in range(psl.n_total, 0, -1):
        lpid[psl.pattern(pid)] = pid
    lends = {}
    for end, pid, _v in gotl:
        lends.setdefault(pid, []).append(end)
    for at, s, v, _ne in long_plants:
        if not any(abs(e - (at + len(v))) <= 2
                   for e in lends.get(lpid[s], ())):
            raise AssertionError(f"long primer {v} at {at} not found")
    log(f"Sellers route: P={psl.n_total}, Lmax={scl.tables.Lmax}, k=2, "
        f"n=2^26: {len(gotl)} engine hits == host route, all "
        f"{len(long_plants)} plants found, launches {sel_launches}")
    sl_dev = device_form(sub, scl.device)
    st2 = scl._sellers_t()
    sel_cap = scl._cap("sellers", SELLERS_N)
    sel_row = sellers_scan(sl_dev, SELLERS_N, st2, EOS, 2, True, sel_cap)
    sel_ref, sel_plain = timed(lambda: sellers_ref(
        sl_dev, SELLERS_N, st2, EOS, 2, True, sel_cap))
    if row_set(sel_row, sel_cap, 3) != row_set(sel_ref, sel_cap, 3):
        raise AssertionError("sellers_scan differs from plain at 2^26")
    sel_ms = cuda_ms(lambda: sellers_scan(sl_dev, SELLERS_N, st2, EOS, 2,
                                          True, sel_cap), reps=5)
    sel_hits_n = int(sel_row[0])
    log(f"sellers_scan at n=2^26, P=48, Lmax={st2.Lmax}, k=2 on {smi}: "
        f"kernel {sel_ms:.4f} ms, plain {sel_plain:.4f} ms (CUDA events; "
        f"equal; {sel_hits_n} triples)")
    if "sellers" in parents:
        if row_set(parents["sellers"](sl_dev, SELLERS_N, st2, EOS, 2, True,
                                      sel_cap),
                   sel_cap, 3) != row_set(sel_row, sel_cap, 3):
            raise AssertionError("parent sellers kernel differs at 2^26")
        sel_ms, _old = beside_parent(
            f"sellers_scan at n=2^26, P=48, Lmax={st2.Lmax}, k=2 (equal "
            f"triples)",
            lambda: sellers_scan(sl_dev, SELLERS_N, st2, EOS, 2, True,
                                 sel_cap),
            lambda: parents["sellers"](sl_dev, SELLERS_N, st2, EOS, 2, True,
                                       sel_cap), 5, smi)
    # without indels: the counter form, on its own line
    noi_row = sellers_scan(sl_dev, SELLERS_N, st2, EOS, 2, False, sel_cap)
    noi_ms = cuda_ms(lambda: sellers_scan(sl_dev, SELLERS_N, st2, EOS, 2,
                                          False, sel_cap), reps=5)
    line = (f"sellers_scan without indels at n=2^26, P=48, k=2 on {smi}: "
            f"kernel {noi_ms:.4f} ms (CUDA events, median; "
            f"{int(noi_row[0])} triples)")
    if "sellers" in parents:
        old_row = parents["sellers"](sl_dev, SELLERS_N, st2, EOS, 2, False,
                                     sel_cap)
        if row_set(old_row, sel_cap, 3) != row_set(noi_row, sel_cap, 3):
            raise AssertionError("parent sellers kernel differs without "
                                 "indels at 2^26")
        old_ms = cuda_ms(lambda: parents["sellers"](
            sl_dev, SELLERS_N, st2, EOS, 2, False, sel_cap), reps=5)
        line += f"; older kernel {old_ms:.4f} ms, equal triples"
    log(line)
    # the route end to end: engine hits per 2^26 scan with the host tail
    try:
        list(ml.engine_hits_stream(2))  # starts the tail processes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs = list(ml.engine_hits_stream(5))
        s_sel = time.perf_counter() - t0
    finally:
        ml.close()
    if runs != [gotl] * 5:
        raise AssertionError("Sellers route engine_hits_stream changed its "
                             "hits")
    log(f"Sellers route engine_hits_stream, n=2^26 resident, P=48 on {smi}: "
        f"{s_sel / 5:.6f} s per run, {5 * SELLERS_N / s_sel / 1e9:.3f} "
        f"Gbases/s (host clock, 5 runs, host tail in worker processes)")
    t0 = time.perf_counter()
    for _ in range(3):
        list(ml._filter_emit(dends, dpids))
    log(f"Sellers route host tail (clusters + native verify) of "
        f"{len(dends)} candidates: "
        f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms per run")
    profile("Sellers route, engine_hits, n=2^26 resident, P=48",
            lambda: list(ml.engine_hits()), 3)
    del sl_dev, ml

    # 10. the slot kernels against plain, and the pattern-blocked rung
    from sequence_alignment_tools_tpu_torch.models.pcr_match import (
        PcrMatchModel,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.slots import (
        gate_slots,
        gate_slots_ref,
        scan_slots,
        scan_slots_ref,
        slot_gated_hits,
    )

    slot_n = 1 << 20
    sr = np.random.default_rng(SEED + 5)
    scodes = codes[:slot_n].copy()
    stab = np.frombuffer(TABLE, np.uint8)
    spats = []
    while len(spats) < 2492:
        at = int(sr.integers(1, slot_n - 60))
        w = scodes[at : at + int(sr.integers(16, 49))]
        if (w < 4).all():
            spats.append(stab[w].tobytes().decode())
    cut = random_pats(sr, 1, 40, 40)[0]  # planted with an EOS in each half
    spats = spats + [cut] + spats[:7]     # 2,500 patterns, 7 of them twice
    for at in (700_000, 800_000):
        scodes[at : at + 40] = [TABLE.index(c.encode()) for c in cut]
    scodes[700_009] = scodes[800_031] = EOS
    sdb1 = SeqDB(codes=scodes, table=TABLE, entry_starts=np.array([1]),
                 entry_lengths=np.array([slot_n - 1]), headers=["slots"])

    def slots_setup(k, indels, node):
        m = PrimerMatchModel(sdb1, build_pattern_set(spats, rev_comp=False),
                             k=k, indels=indels, node=node, device=dev)
        if m.engine != "halves":
            raise AssertionError(f"slot check took engine {m.engine}")
        _o, hsc, _b, hdirs, hext, hgeomB = m._halves_ctx()
        hsc.use_host = False
        gate = m._engine_gate(hsc, hdirs, hext, hgeomB, lambda p0: p0 + 1)
        return hsc, hsc._gate_dev(gate)

    ssc, gt_s1 = slots_setup(1, True, 0)
    mt_s = ssc._mer_dev()
    sdev = device_form(scodes, ssc.device)
    full = 1 << 22
    slots_row = scan_slots(sdev, slot_n, mt_s, full)
    want_row = scan_slots_ref(sdev, slot_n, mt_s, full)
    torch.cuda.synchronize()
    slots_err = check_slots(
        f"scan_slots check n=2^20, {mt_s.P} seeds of lengths "
        f"{mt_s.lens[0]} to {mt_s.lens[-1]} ({len(mt_s.lens)} classes)",
        slots_row, want_row, full, full)
    cut_sids = {2 * spats.index(cut), 2 * spats.index(cut) + 1}
    cut_hits = [(t, sd) for t, sd in row_set(want_row, full, 2)[1]
                if sd in cut_sids]
    if sorted(cut_hits) != [(700_020, max(cut_sids)),
                            (800_000, min(cut_sids))]:
        raise AssertionError(f"seed halves cut by EOS: {cut_hits}")
    slots_err = max(slots_err, check_slots(
        "scan_slots check cap 1 (overflow)",
        scan_slots(sdev, slot_n, mt_s, 1), want_row, 1, full))
    gslots_err = 0
    for k, indels, node in ((1, True, 0), (1, False, 0), (2, True, 11),
                            (2, False, 11)):
        _sc, gt_s = (ssc, gt_s1) if (k, indels) == (1, True) \
            else slots_setup(k, indels, node)
        gslots_err = max(gslots_err, check_slots(
            f"gate_slots check k={k} indels={indels} Lg={gt_s.Lg} "
            f"band={gt_s.band}, {int(slots_row[0])} slots",
            gate_slots(sdev, slot_n, slots_row, mt_s.lengths, gt_s, indels,
                       full),
            gate_slots_ref(sdev, slot_n, slots_row, mt_s.lengths, gt_s,
                           indels, full), full, full))
    gslots_err = max(gslots_err, check_slots(
        "gate_slots check cap 1 (overflow)",
        gate_slots(sdev, slot_n, slots_row, mt_s.lengths, gt_s1, True, 1),
        gate_slots_ref(sdev, slot_n, slots_row, mt_s.lengths, gt_s1, True,
                       full), 1, full))
    del sdev, slots_row, want_row
    gate_dev = torch.from_numpy(codes[:gate_n].copy()).to(dev)
    fused_row = gated_hits(gate_dev, gate_n, dt_h, gt_h, EOS, True,
                           gate_n // 32, 1 << 16)
    unfused_row = slot_gated_hits(gate_dev, gate_n, sc1._mer_dev(), gt_h,
                                  True, 1 << 22, 1 << 16)
    fc, fset = row_set(fused_row[1:], 1 << 16, 2)
    uc, uset = row_set(unfused_row[1:], 1 << 16, 2)
    if fset != uset or fc != uc or not fset:
        raise AssertionError(f"gate_slots(scan_slots) differs from seed_gate: "
                             f"{uc} vs {fc} survivors")
    log(f"gate_slots(scan_slots) == seed_gate on the 40 half seeds, n=2^22: "
        f"{int(unfused_row[0])} slots, {uc} survivors")
    del gate_dev
    wtext = wdb.decode(0, len(wdb.codes))
    wmany = [wtext[i : i + 14] for i in
             sr.integers(1, len(wtext) - 20, size=2600)]
    wmany = [w for w in wmany if w.isalpha()][:2499] + ["ACGRYTNNSWKT"]
    wt_many = build_tables(build_pattern_set(wmany, rev_comp=False), wdb,
                           wc=True, textn=False)
    psc = ConvScanner(wt_many, k=0, device=dev)
    psc.use_host = False
    if psc._radix_eligible() or wt_many.P <= psc._PBLOCK:
        raise AssertionError("the degenerate set is not pattern-blocked")
    ran = Launches()
    got_pb = list(psc.scan(wdb.codes))
    want_pb = grouped_host_scan(wt_many, wdb.codes)
    if got_pb != want_pb or not got_pb:
        raise AssertionError(f"pattern-blocked scan differs from the host "
                             f"shift-and: {len(got_pb)} vs {len(want_pb)}")
    log(f"pattern-blocked rung: P={wt_many.P} degenerate primers, n=2^20: "
        f"{len(got_pb)} hits == native shift-and over pattern groups, "
        f"scan_occupancy launches {ran['scan_occupancy']}")
    del psc

    # 11. the many-pattern path: 50,000 literal 20-mers from the database
    xpats = draw_patterns(codes, 50_000, 20)
    xps = literal_pattern_set(xpats)
    xtables = build_tables(xps, db, wc=False, textn=False)
    xsc = ConvScanner(xtables, k=0, device=dev)
    xsc.use_host = False
    xhost = ConvScanner(xtables, k=0, device="cpu")
    if xtables.P <= xsc._PBLOCK or not xsc._census_eligible(MAIN_N):
        raise AssertionError("the 50,000-pattern batch left the census rung")
    pre_n = 1 << 26
    pre = codes[:pre_n]
    t0 = time.perf_counter()
    want_e, want_p = xhost.scan_seed_arrays(pre)
    log(f"p50k host census (native threaded mer-hash) over 2^26: "
        f"{len(want_e)} hits in {time.perf_counter() - t0:.3f} s")
    ran = Launches()
    got_e, got_p = xsc.scan_seed_arrays(pre)
    if ran["scan_slots"] < 1:
        raise AssertionError("p50k: the census never launched scan_slots")
    if not (np.array_equal(got_e, want_e) and np.array_equal(got_p, want_p)) \
            or not len(got_e):
        raise AssertionError(f"p50k device census differs from the host "
                             f"census: {len(got_e)} vs {len(want_e)} hits")
    ran = Launches()
    ends50, pids50 = xsc.scan_seed_arrays(codes)
    p50k_launches = ran["scan_slots"]
    if p50k_launches < 1 or len(np.unique(pids50)) != 50_000:
        raise AssertionError(f"p50k at 2^28: {p50k_launches} launches, "
                             f"{len(np.unique(pids50))} patterns found")
    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e5, _p5 = xsc.scan_seed_arrays(codes)
        secs.append(time.perf_counter() - t0)
        if len(e5) != len(ends50):
            raise AssertionError("repeated census changed its hit count")
    s_p50k = statistics.median(secs)
    log(f"p50k main path: scan_seed_arrays, n=2^28 resident, P=50000 "
        f"20-mers on {smi}: {len(got_e)} hits == host census over 2^26; "
        f"{len(ends50)} hits over 2^28 (every pattern found), scan_slots "
        f"launches {p50k_launches}, {s_p50k:.6f} s per scan, "
        f"{MAIN_N / s_p50k / 1e9:.3f} Gbases/s (host clock, median of 5)")
    main_dev = device_form(codes, xsc.device)
    mt50 = xsc._mer_dev()
    cap50 = xsc._slot_cap_for(MAIN_N)
    x_ms = cuda_ms(lambda: scan_slots(main_dev, MAIN_N, mt50, cap50), reps=10)
    if "seed_slots" in parents:
        pc, pk = row_keys(parents["seed_slots"](main_dev, MAIN_N, mt50,
                                                cap50), cap50)
        nc, nk = row_keys(scan_slots(main_dev, MAIN_N, mt50, cap50), cap50)
        if pc != nc or not np.array_equal(pk, nk):
            raise AssertionError("parent seed_slots differs on the 20-mers")
        x_ms, _old = beside_parent(
            "scan_slots at n=2^28, 50000 20-mers (equal slots)",
            lambda: scan_slots(main_dev, MAIN_N, mt50, cap50),
            lambda: parents["seed_slots"](main_dev, MAIN_N, mt50, cap50), 10,
            smi)
    x_ref, x_plain = timed(lambda: scan_slots_ref(main_dev, MAIN_N, mt50,
                                                  cap50))
    slots_err = max(slots_err, check_slots(
        "scan_slots check n=2^28, 50,000 20-mers",
        scan_slots(main_dev, MAIN_N, mt50, cap50), x_ref, cap50, cap50))
    log(f"scan_slots at n=2^28, 50000 20-mers (1 class) on {smi}: kernel "
        f"{x_ms:.4f} ms, plain {x_plain:.4f} ms (CUDA events; equal)")
    profile("p50k main path, scan_seed_arrays, n=2^28 resident",
            lambda: xsc.scan_seed_arrays(codes), 3)
    del x_ref, xhost

    # 11b. the same 50,000 patterns at k = 1: halves, 100,000 half seeds
    kpre_n = 1 << 24
    pdb = prefix_db(db, kpre_n)
    t0 = time.perf_counter()
    mx_cpu = PrimerMatchModel(pdb, xps, k=1, indels=True, device="cpu")
    want_k = mx_cpu.engine_hits_arrays()
    log(f"xk1 CPU route (native census, inline gate, native extension) over "
        f"2^24: {len(want_k[0])} engine hits in "
        f"{time.perf_counter() - t0:.3f} s")
    mx_pre = PrimerMatchModel(pdb, xps, k=1, indels=True, device=dev)
    mx_pre.use_host = False
    ran = Launches()
    got_k = mx_pre.engine_hits_arrays()
    if min(ran["scan_slots"], ran["gate_slots"]) < 1:
        raise AssertionError("xk1 prefix run skipped a slot kernel")
    if not all(np.array_equal(g, w) for g, w in zip(got_k, want_k)) \
            or not len(got_k[0]):
        raise AssertionError(f"xk1 device route differs from the CPU route: "
                             f"{len(got_k[0])} vs {len(want_k[0])} hits")
    del mx_cpu, mx_pre, pdb
    t0 = time.perf_counter()
    mx = PrimerMatchModel(db, xps, k=1, indels=True, device=dev)
    mx.use_host = False
    if mx.engine != "halves":
        raise AssertionError(f"xk1 took engine {mx.engine}")
    _o, xsc1, _b, xdirs, xext, xgeomB = mx._halves_ctx()
    if xsc1.tables.P != 100_000 or not xsc1.gated_available(MAIN_N):
        raise AssertionError("xk1: the slots route is not available")
    mx.engine_hits_arrays()  # tables, gate, caps
    log(f"xk1 set-up and first run (100,000 half seeds): "
        f"{time.perf_counter() - t0:.3f} s")
    ran = Launches()
    hes, hp, hv = mx.engine_hits_arrays()
    xk1_launches = {"scan_slots": ran["scan_slots"],
                    "gate_slots": ran["gate_slots"],
                    "scan_occupancy": ran["scan_occupancy"],
                    "seed_gate": ran["seed_gate"]}
    if xk1_launches["scan_slots"] < 1 or xk1_launches["gate_slots"] < 1:
        raise AssertionError(f"xk1 main path skipped a kernel: "
                             f"{xk1_launches}")
    if list(zip(hes.tolist(), hp.tolist(), hv.tolist())) != list(
            mx.engine_hits()):
        raise AssertionError("xk1: engine_hits_arrays differs from "
                             "engine_hits")
    if len(np.unique(hp)) != 50_000:
        raise AssertionError(f"xk1: {len(np.unique(hp))} of 50000 patterns "
                             "found")
    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = mx.engine_hits_arrays()
        secs.append(time.perf_counter() - t0)
        if len(out_k[0]) != len(hes):
            raise AssertionError("repeated xk1 run changed its hit count")
    s_xk1 = statistics.median(secs)
    gate_x = mx._engine_gate(xsc1, xdirs, xext, xgeomB, lambda p0: p0 + 1)
    gt_x = xsc1._gate_dev(gate_x)
    mt_x = xsc1._mer_dev()
    slot_cap, surv_cap = xsc1._gated_caps(MAIN_N, True)
    xslots = scan_slots(main_dev, MAIN_N, mt_x, slot_cap)
    xsurv = gate_slots(main_dev, MAIN_N, xslots, mt_x.lengths, gt_x, True,
                       surv_cap)
    n_slots, n_surv = int(xslots[0]), int(xsurv[0])
    if n_slots > slot_cap or n_surv > surv_cap:
        raise AssertionError(f"xk1 caps overflow: {n_slots} slots (cap "
                             f"{slot_cap}), {n_surv} survivors ({surv_cap})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        anchors_x, sids_x = xsc1.scan_gated(codes, gate_x, True, 1)
    scan_x = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        mx._halves_emit_arrays(anchors_x, xsc1._hid_lut_c[sids_x])
    tail_x = (time.perf_counter() - t0) / 3 * 1e3
    log(f"xk1 main path: engine_hits_arrays, n=2^28 resident, 50000 20-mers "
        f"at k=1 (100000 half seeds) on {smi}: {len(got_k[0])} engine hits "
        f"== CPU route over 2^24; over 2^28 {n_slots} slots, {n_surv} gate "
        f"survivors, {len(hes)} engine hits (every pattern found), launches "
        f"{xk1_launches}, scan_gated (both kernels, row fetch) "
        f"{scan_x:.3f} ms, host tail {tail_x:.3f} ms, {s_xk1:.6f} s per run, "
        f"{MAIN_N / s_xk1 / 1e9:.3f} Gbases/s (host clock, median of 5)")
    s_ms = cuda_ms(lambda: scan_slots(main_dev, MAIN_N, mt_x, slot_cap),
                   reps=10)
    g_ms = cuda_ms(lambda: gate_slots(main_dev, MAIN_N, xslots, mt_x.lengths,
                                      gt_x, True, surv_cap), reps=10)
    if "gate_slots" in parents:
        if check_slots("gate_slots of the older commit, n=2^28",
                       parents["gate_slots"](main_dev, MAIN_N, xslots,
                                             mt_x.lengths, gt_x, True,
                                             surv_cap),
                       xsurv, surv_cap, surv_cap):
            raise AssertionError("parent gate_slots differs at 2^28")
        g_ms, _old = beside_parent(
            "gate_slots at n=2^28, 100000 half seeds, k=1 (equal survivors)",
            lambda: gate_slots(main_dev, MAIN_N, xslots, mt_x.lengths, gt_x,
                               True, surv_cap),
            lambda: parents["gate_slots"](main_dev, MAIN_N, xslots,
                                          mt_x.lengths, gt_x, True,
                                          surv_cap), 10, smi)
    if "seed_slots" in parents:
        old_slots = parents["seed_slots"](main_dev, MAIN_N, mt_x, slot_cap)
        pc, pk = row_keys(old_slots, slot_cap)
        nc, nk = row_keys(xslots, slot_cap)
        if pc != nc or not np.array_equal(pk, nk):
            raise AssertionError("parent seed_slots differs at 2^28")
        # the same slots in the older kernel's order, through gate_slots
        g_old = cuda_ms(lambda: gate_slots(main_dev, MAIN_N, old_slots,
                                           mt_x.lengths, gt_x, True,
                                           surv_cap), reps=10)
        log(f"gate_slots over the older census's slot order on {smi}: "
            f"{g_old:.4f} ms; over this census's order {g_ms:.4f} ms (CUDA "
            f"events, median)")
        del old_slots
        s_ms, _old = beside_parent(
            "scan_slots at n=2^28, 100000 half seeds (equal slots)",
            lambda: scan_slots(main_dev, MAIN_N, mt_x, slot_cap),
            lambda: parents["seed_slots"](main_dev, MAIN_N, mt_x, slot_cap),
            10, smi)
    s_ref, s_plain = timed(lambda: scan_slots_ref(main_dev, MAIN_N, mt_x,
                                                  slot_cap))
    g_ref, g_plain = timed(lambda: gate_slots_ref(
        main_dev, MAIN_N, xslots, mt_x.lengths, gt_x, True, surv_cap))
    log(f"slot kernels at n=2^28, 100000 half seeds of 10 bases, k=1 on "
        f"{smi}: scan_slots {s_ms:.4f} ms (plain {s_plain:.4f} ms), "
        f"gate_slots {g_ms:.4f} ms (plain {g_plain:.4f} ms) (CUDA events)")
    slots_err = max(slots_err, check_slots(
        "scan_slots check n=2^28, 100,000 half seeds", xslots, s_ref,
        slot_cap, slot_cap))
    del s_ref
    gslots_err = max(gslots_err, check_slots(
        "gate_slots check n=2^28, k=1", xsurv, g_ref, surv_cap, surv_cap))
    profile("xk1 main path, engine_hits_arrays, n=2^28 resident",
            lambda: mx.engine_hits_arrays(), 3)
    del main_dev, xslots, xsurv, g_ref, mx, xsc

    # 11b. the census keyed by prefixes at Swiss-Prot's size
    prefix_census_phase(smi)

    # 12. pcr_match: the pair join over the resident database
    from sequence_alignment_tools_tpu_torch.apps.pcr_match import (
        build_pair_pattern_set,
    )
    from sequence_alignment_tools_tpu_torch.utils.iupac import reverse_comp

    pcr_opts = {"ucdict": False, "rev_comp": True, "fplen": 0, "tplen": 0,
                "stlen": 0, "edlen": 0}

    def bench_pairs(text):
        """bench.py's 10 STS-style pairs: 15-mers 800 bases apart."""
        out = []
        for i in range(10):
            x = 100_000 + 170_000 * i
            out += [text[x : x + 15], reverse_comp(text[x + 800 : x + 815])]
        return out

    pairs = bench_pairs(db.decode(0, 2_000_000))
    mp = PcrMatchModel(db, build_pair_pattern_set(pairs, pcr_opts, [], []),
                       k=0, maxdist=2000, rev_comp=True, device=dev)
    mp.inner.use_host = False

    def pair_key(h):
        return (h.pid, h.pid1, h.pe, h.pe1, h.amplicon)

    ran = Launches()
    want_pairs = [pair_key(h) for h in mp.pairs()]
    if ran["scan_occupancy"] < 1 or len(want_pairs) < 10:
        raise AssertionError(f"pcr_match: {len(want_pairs)} pairs, "
                             f"{ran['scan_occupancy']} launches")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = [[pair_key(h) for h in run] for run in mp.pairs_stream(5)]
    s_pcr = time.perf_counter() - t0
    if runs != [want_pairs] * 5:
        raise AssertionError("pcr_match pairs_stream differs from pairs")
    log(f"pcr_match pairs_stream, n=2^28 resident, 10 pairs (P=40), k=0 on "
        f"{smi}: {len(want_pairs)} pairs per run == pairs(), "
        f"{s_pcr / 5:.6f} s per run, {5 * MAIN_N / s_pcr / 1e9:.3f} Gbases/s "
        f"(host clock, 5 runs)")
    del mp

    # 12b. peptide_scan's path: peptides over the six-frame translation
    from sequence_alignment_tools_tpu_torch.io.compress import (
        compress,
        load_db,
    )
    from sequence_alignment_tools_tpu_torch.io.translate import translate_db

    t0 = time.perf_counter()
    tdb = translate_db(db, all_frames=True)
    s_tr = time.perf_counter() - t0
    peps = forward_peptides(tdb, 10)
    pps = build_pattern_set(peps)
    mpep = PrimerMatchModel(tdb.aa_db, pps, k=0, device=dev)
    mpep.use_host = False
    mpep_host = PrimerMatchModel(tdb.aa_db, pps, k=0, device=dev)
    mpep_host.use_host = True
    t0 = time.perf_counter()
    want_pep = list(mpep_host.engine_hits())
    s_pep_host = time.perf_counter() - t0
    ran = Launches()
    got_pep = list(mpep.engine_hits())
    pep_launches = ran["scan_occupancy"]
    if pep_launches < 1 or got_pep != want_pep or len(want_pep) < 10:
        raise AssertionError(f"peptide path: {len(got_pep)} vs "
                             f"{len(want_pep)} hits, {pep_launches} "
                             "scan_occupancy launches")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = [list(run) for run in mpep.engine_hits_stream(3)]
    s_pep = time.perf_counter() - t0
    if runs != [want_pep] * 3:
        raise AssertionError("peptide engine_hits_stream changed its hits")
    log(f"peptide path: translate_db of n=2^28 (6 frames, "
        f"{len(tdb.aa_db.codes)} residues) {s_tr:.3f} s on the host; 10 "
        f"peptides of 9 residues, k=0, engine_hits == host route "
        f"({len(want_pep)} hits; host route {s_pep_host:.3f} s), "
        f"scan_occupancy launches {pep_launches}; engine_hits_stream on "
        f"{smi}: {s_pep / 3:.6f} s per run, "
        f"{3 * MAIN_N / s_pep / 1e9:.3f} Gbases/s in DNA bases (host "
        f"clock, 3 runs)")
    del mpep, mpep_host, tdb

    # 12c. the wide-alphabet route: 15 symbols, 10 IUPAC 14-mers, -w, -r
    wide16 = wide_corpus_db()
    wtext16 = wide16.decode(0, 200_000)
    wpats = []
    at = 100
    while len(wpats) < 10:
        p = wtext16[at : at + 14]
        if len(p) == 14 and "\n" not in p:
            wpats.append(p)
        at += 17_000
    wps = build_pattern_set(wpats, rev_comp=True)
    mwide = PrimerMatchModel(wide16, wps, k=0, wc=True, device=dev)
    mwide.use_host = False
    mwide_host = PrimerMatchModel(wide16, wps, k=0, wc=True, device=dev)
    mwide_host.use_host = True
    want_wide = list(mwide_host.engine_hits())
    ran = Launches()
    got_wide = list(mwide.engine_hits())
    wide_launches = ran["scan_occupancy"]
    if wide_launches < 1 or got_wide != want_wide or len(want_wide) < 10:
        raise AssertionError(f"wide-alphabet path: {len(got_wide)} vs "
                             f"{len(want_wide)} hits, {wide_launches} "
                             "scan_occupancy launches")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = [list(run) for run in mwide.engine_hits_stream(5)]
    s_wide = time.perf_counter() - t0
    if runs != [want_wide] * 5:
        raise AssertionError("wide-alphabet engine_hits_stream changed its "
                             "hits")
    n_wide = len(wide16.codes)
    log(f"wide-alphabet path: {wide16.alphabet_size} codes, n={n_wide}, 10 "
        f"IUPAC 14-mers with -w -r (P={wps.n_total}), k=0: engine_hits == "
        f"host route ({len(want_wide)} hits), scan_occupancy launches "
        f"{wide_launches}; engine_hits_stream on {smi}: "
        f"{s_wide / 5:.6f} s per run, {5 * n_wide / s_wide / 1e9:.3f} "
        f"Gbases/s (host clock, 5 runs)")
    del mwide, mwide_host, wide16

    # 13. CLI: device route and host route print the same bytes
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "corpus.fasta")
        small = os.path.join(tmp, "small.fasta")
        pfile = os.path.join(tmp, "primers.txt")
        lfile = os.path.join(tmp, "long_primers.txt")
        entry0 = write_bench_corpus(fasta)
        write_bench_corpus(small, entries=1, entry_len=600_000)
        with open(pfile, "w") as f:
            f.write("\n".join(PATS) + "\n")
        with open(lfile, "w") as f:
            f.write("\n".join(LONG) + "\n")
        pair_arg = " ".join(bench_pairs(entry0))
        # the translated tools read a normalized copy of the corpus
        tfasta = os.path.join(tmp, "normalized.fasta")
        shutil.copyfile(fasta, tfasta)
        compress(tfasta, normalize=True)
        pepfile = os.path.join(tmp, "peptides.txt")
        with open(pepfile, "w") as f:
            f.write("\n".join(forward_peptides(
                translate_db(load_db(tfasta), all_frames=True), 10)) + "\n")
        pm = ["scan_occupancy"]
        # the seed-table engines run on the small corpus: their candidate
        # lists (every 4-base seed hit of the hash engine) are walked in
        # Python, as in the JAX package
        for tool, db_file, pats_flag, flags, need in (
                ("primer_match", fasta, ["-P", pfile], ["-r", "-c"], pm),
                ("primer_match", fasta, ["-P", pfile], ["-r"], pm),
                ("primer_match", fasta, ["-P", pfile],
                 ["-k", "1", "-r", "-c"], pm + ["seed_gate"]),
                ("primer_match", fasta, ["-P", pfile], ["-K", "1", "-r"],
                 pm + ["seed_gate"]),
                ("primer_match", fasta, ["-P", pfile],
                 ["-k", "1", "-r", "-3", "8"], pm + ["seed_gate"]),
                ("primer_match", fasta, ["-P", pfile],
                 ["-k", "2", "-r", "-c"], ["myers_pairs"]),
                ("primer_match", fasta, ["-P", pfile], ["-k", "2", "-r"],
                 ["myers_pairs"]),
                ("primer_match", fasta, ["-P", pfile], ["-K", "2", "-r"], pm),
                ("primer_match", fasta, ["-P", lfile], ["-k", "2", "-r"],
                 ["sellers_scan"]),
                ("primer_match", small, ["-P", pfile],
                 ["-N", "6", "-k", "1", "-r"], ["scan_slots"]),
                ("primer_match", small, ["-P", pfile],
                 ["-N", "15", "-K", "2", "-r"], pm),
                ("primer_match", small, ["-P", lfile],
                 ["-N", "15", "-k", "2", "-r"], pm),
                ("pcr_match", fasta, ["-p", pair_arg],
                 ["-r", "-M", "2000"], pm),
                ("pcr_match", fasta, ["-p", pair_arg],
                 ["-r", "-M", "2000", "-k", "1"], pm + ["seed_gate"]),
                ("peptide_scan", tfasta, ["-P", pepfile], ["-T", "A"], pm),
                ("peptide_scan", tfasta, ["-P", pepfile],
                 ["-T", "A", "-K", "1"], pm + ["seed_gate"]),
                ("primer_match", tfasta, ["-P", pepfile], ["-T", "-r"],
                 pm)):
            argv = ["-i", db_file] + pats_flag + flags
            long_set = pats_flag[1] == lfile
            os.environ["SAT_HOST_SCAN"] = "0"
            ran = Launches()
            t0 = time.perf_counter()
            out_dev = run_tool(tool, argv)
            s_cli = time.perf_counter() - t0
            cli_launches = ran.all()
            del os.environ["SAT_HOST_SCAN"]
            # the long primers exceed one native Sellers machine: the
            # host run takes the machines over pattern groups (their gs
            # templates exceed the native shift-and too: both runs then
            # take the pattern-blocked rung, and the plants decide)
            with (split_host_route() if long_set
                  else contextlib.nullcontext()):
                out_host = run_tool(tool, argv)
            if min(cli_launches[kname] for kname in need) < 1:
                raise AssertionError(f"CLI {tool} {flags}: the device run "
                                     f"skipped a kernel: {cli_launches}")
            if out_dev != out_host or not out_dev:
                raise AssertionError(f"CLI {tool} {flags}: device and host "
                                     "outputs differ")
            if "-N" in flags and long_set and (
                    cli_launches["scan_occupancy"] < 4
                    or out_dev.count(b">") < len(LONG)):
                raise AssertionError(
                    f"CLI gs over the long primers: {cli_launches}, "
                    f"{out_dev.count(b'>')} hits for {len(LONG)} exact plants")
            if tool == "pcr_match" and out_dev.count(b"\n") < 10:
                raise AssertionError("CLI pcr_match found fewer than its 10 "
                                     "planted pairs")
            if db_file == tfasta and out_dev.count(b"\n") < 10:
                raise AssertionError(f"CLI {tool} {flags}: fewer hits than "
                                     "its 10 peptides")
            log(f"CLI {tool} {' '.join(flags)}"
                f"{' (long primers)' if long_set else ''}"
                f"{' (normalized corpus)' if db_file == tfasta else ''}"
                f"{' (600,000-base corpus)' if db_file == small else ''}: "
                f"{len(out_dev)} bytes, {len(out_dev.splitlines())} lines, "
                f"device == host, device run {s_cli:.3f} s, launches "
                f"{cli_launches}")
        # 16. the tools of the scanners' paths through the CLI
        t0 = time.perf_counter()
        cli_tools_phase(tmp, fasta, pfile, lfile, entry0, smi)
        log(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # 17. nrdb and xmers at the sizes users run them
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scale_phase(tmp, smi)
        log(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # 18. the tools that reach no scanner, through the CLI on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        host_tools_phase(tmp, smi)
        log(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # 19. the mesh on the card: four shards on cuda:0, then two ranks
    t0 = time.perf_counter()
    mesh_phase(smi, dev, db, ps, got, s_main, got1, s_k1 / 5, sdb, psl,
               gotl, blocks, want_blocks, s_stream)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # 20. the cold one-shot regime: the site-less launcher
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cold_phase(tmp, smi)
        log(f"phase 20: {time.perf_counter() - t0:.1f} s")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    src = "sequence_alignment_tools_tpu_torch/ops/cuda/csrc/"
    tpu = "sequence_alignment_tools_tpu/ops/pallas/scan_kernel.py"
    # bounds: each input byte read once, each output byte written once;
    # operations as this run's data needs them, at least.  The filter's
    # bit-parallel form decides 32 window starts per word operation: at
    # least one ballot per mask row (one per class of the P = 20 set) and
    # 32 positions, and one word step (a load and an AND) per pattern and
    # 32-start microblock; its bytes are the text and one byte per
    # microblock
    nmb24 = BLOCK_N // 32
    occ_bound = bound(BLOCK_N + nmb24,
                      nmb24 * filter_tables(dt0.weights16, dt0.thresholds).R
                      + nmb24 * 2 * len(PATS))
    cand28, surv28, hits28 = gate_counts
    lmax_s = int(dt_h.weights16.shape[0])
    ft_h = filter_tables(dt_h.weights16, dt_h.thresholds)
    # seed_gate: each candidate microblock's index and text in, 8 bytes per
    # survivor out; per candidate microblock one ballot per mask row and
    # 32-position word of its text and at least one word step (a funnel
    # shift and an AND, for 32 starts) per seed; per seed hit at least
    # k + 1 gate rows, a survivor all Lg, of 2 band + 1 cells of about 4
    # operations
    gate_cells = 2 * gt_h.band + 1
    gate_bound = bound(
        cand28 * (8 + 32 + lmax_s - 1) + 8 * surv28,
        cand28 * (ft_h.R * -(-(32 + lmax_s - 1) // 32) + 2 * ft_h.P)
        + ((hits28 - surv28) * (gt_h.k + 1) + surv28 * gt_h.Lg)
        * gate_cells * 4)
    # Myers: 17 operations per word and character, the recurrence as
    # myers.cu's header writes it (15 word operations, 2 for the score)
    my_bound = bound(MAIN_N + 8 * my_pairs_n, 17 * MAIN_N * mt2.nw)
    # Sellers: Ukkonen's cutoff visits at least k + 1 cells per character
    # and pattern, about 5 operations each
    sel_bound = bound(SELLERS_N + 12 * sel_hits_n,
                      5 * 3 * SELLERS_N * st2.P)
    # scan_slots: n bytes of text in, 8 bytes per slot out; one code roll
    # step and one probe per start and length class, about 8 operations
    slots_bound = bound(MAIN_N + 8 * n_slots,
                        8 * MAIN_N * len(mt_x.lens))
    # gate_slots: 8 bytes per slot and its extension window in, 8 bytes
    # per survivor out; a slot needs at least k + 1 DP rows to be dropped,
    # a survivor all Lg, of 2 band + 1 cells of about 4 operations
    cells = 2 * gt_x.band + 1
    gslots_bound = bound(
        n_slots * (8 + gt_x.Lg + gt_x.band) + 8 * n_surv,
        ((n_slots - n_surv) * (gt_x.k + 1) + n_surv * gt_x.Lg) * cells * 4)
    kernels = [{
        "name": "scan_occupancy",
        "route": "cuda",
        "source": src + "scan_filter.cu",
        "replaces": tpu + ":240",
        "launches": k1_launches["scan_occupancy"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": occ_bound[0],
        "bound_by": occ_bound[1],
        "library_ms": None,
    }, {
        "name": "seed_gate",
        "route": "cuda",
        "source": src + "seed_gate.cu",
        "replaces": tpu + ":796",
        "launches": k1_launches["seed_gate"],
        "max_abs_err": gate_err,
        "ms": timings["2^28"][0],
        "plain_ms": timings["2^28"][1],
        "bound_ms": gate_bound[0],
        "bound_by": gate_bound[1],
        "library_ms": None,
    }, {
        "name": "myers_pairs",
        "route": "cuda",
        "source": src + "myers.cu",
        "replaces": "sequence_alignment_tools_tpu/ops/pallas/"
                    "myers_kernel.py:74",
        "launches": k2_launches["myers_pairs"],
        "max_abs_err": kedit_err["myers_pairs"],
        "ms": my_ms,
        "plain_ms": my_plain,
        "bound_ms": my_bound[0],
        "bound_by": my_bound[1],
        "library_ms": None,
    }, {
        "name": "sellers_scan",
        "route": "cuda",
        "source": src + "sellers.cu",
        "replaces": "sequence_alignment_tools_tpu/ops/sellers.py:149",
        "launches": sel_launches["sellers_scan"],
        "max_abs_err": kedit_err["sellers_scan"],
        "ms": sel_ms,
        "plain_ms": sel_plain,
        "bound_ms": sel_bound[0],
        "bound_by": sel_bound[1],
        "library_ms": None,
    }, {
        "name": "scan_slots",
        "route": "cuda",
        "source": src + "seed_slots.cu",
        "replaces": tpu + ":1125",
        "launches": xk1_launches["scan_slots"],
        "max_abs_err": slots_err,
        "ms": s_ms,
        "plain_ms": s_plain,
        "bound_ms": slots_bound[0],
        "bound_by": slots_bound[1],
        "library_ms": None,
    }, {
        "name": "gate_slots",
        "route": "cuda",
        "source": src + "gate_slots.cu",
        "replaces": tpu + ":1334",
        "launches": xk1_launches["gate_slots"],
        "max_abs_err": gslots_err,
        "ms": g_ms,
        "plain_ms": g_plain,
        "bound_ms": gslots_bound[0],
        "bound_by": gslots_bound[1],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_worker(int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4]))
    sys.exit(main())
