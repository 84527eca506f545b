#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version, then drives the port's main paths (exact, k = 1,
k = 2 and ``-K 2`` primer_match, both strands; the 50,000-pattern exact
batch and its k = 1 halves run; pcr_match) at full size and checks their
output:

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
   forced overflow (cap 1); kernel and plain timed at 2^22 and 2^28;
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
   3) and ``sellers_scan`` against ``sellers_ref`` (100 patterns of 60 to
   100 bases at k = 1, 2, 4, without indels, and degenerate primers over
   an IUPAC database under ``-w``; patterns of about 3,200 and about
   7,400 bases, about 100 and 232 words, all but the first in device
   scratch), both also at cap 1 (the overflow); the older commit's
   Sellers kernel timed beside the long-pattern shapes;
9. the k = 2 main path: ``PrimerMatchModel(k=2, indels=True)`` (the
   filter engine, Myers route) over the resident 2^28 database, engine
   hits equal to the host route's (the native Sellers rows), every exact,
   1- and 2-edit plant found; ``engine_hits_stream`` throughput with the
   host tail, the tail alone and a ``torch.profiler`` breakdown; then
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
    seed sets when ``PARENT_DIR`` holds its source;
13. pcr_match: ``pairs_stream`` of 10 primer pairs over the resident 2^28
    database at k = 0, equal to ``pairs``;
14. CLI: ``-k 2 -r -c``, ``-k 2 -r``, ``-K 2 -r`` and the long primers with
    ``-k 2 -r``; on a 600,000-base corpus the seed-table engines, ``-N 6
    -k 1 -r`` (hash: the census rung), ``-N 15 -K 2 -r`` (gs) and the long
    primers with ``-N 15 -k 2 -r`` (gs: the pattern-blocked rung);
    ``pcr_match -r -M 2000`` at k = 0 and ``-k 1``; device bytes equal to
    host bytes.

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
SELLERS_N = 1 << 26       # the Sellers-route configuration's database
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


# An older commit's scan filter and Sellers kernel (its scan_filter.cu,
# sellers.cu and scan_chunk.cuh; 40b2571 below), timed beside this
# checkout's kernels when their sources have been unpacked into this
# git-ignored directory:
#   mkdir -p build/parent_kernels && for f in sellers.cu seed_slots.cu \
#     slot_out.cuh scan_chunk.cuh; do git show e27d89a:\
#     sequence_alignment_tools_tpu_torch/ops/cuda/csrc/$f \
#     > build/parent_kernels/$f; done
# (add scan_filter.cu to the list to time an older filter too)
PARENT_DIR = os.path.join("build", "parent_kernels")


def parent_kernels():
    """{name: fn} of the older commit's kernels built from ``PARENT_DIR``
    (empty for a plain checkout): ``scan_filter(codes, w, thr, n, eos)
    -> occ``, ``sellers(codes, n, st, eos, k, indels, cap) -> row`` (the
    byte-cell row DP with its own wrapper's segments) and
    ``seed_slots(codes, n, mt, cap) -> row``, each present when its source
    is."""
    import ctypes

    import torch

    from sequence_alignment_tools_tpu_torch.ops.cuda.build import (
        NVCC_FLAGS,
        _nvcc,
    )

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    procs = {}
    for name in ("scan_filter", "sellers", "seed_slots"):
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
    from sequence_alignment_tools_tpu_torch.ops.cuda.scan_kernel import (
        scan_occupancy,
    )

    host = HostShiftAnd(tables, 0, False)
    if not host.available():
        raise RuntimeError(f"{name}: native shift-and unavailable")
    want = list(host.scan(codes))
    sc = ConvScanner(tables, k=0, device=dev)
    sc.use_host = False
    scan_occupancy.launches = 0
    got = list(sc.scan(codes))
    launches = scan_occupancy.launches
    if launches < 1:
        raise AssertionError(f"{name}: the device route never launched "
                             "scan_occupancy")
    if got != want or not want:
        raise AssertionError(f"{name}: device route differs from host "
                             f"shift-and ({len(got)} vs {len(want)} hits)")
    log(f"device route {name}: n={len(codes)} P={tables.P} "
        f"Lmax={tables.Lmax} alpha={tables.alpha}: {len(got)} hits == "
        f"host shift-and, scan_occupancy launches {launches}")


def profile(label, fn, reps):
    """Print ``fn``'s device self time per kernel under torch.profiler
    (``reps`` calls), with the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    # keep every event of the window (without it, torch may drop the
    # events of earlier cycles from key_averages)
    keep = ({"acc_events": True}
            if "acc_events" in inspect.signature(tprofile).parameters
            else {})
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA], **keep) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3 / reps, ev.count / reps, ev.key,
                         us / 1e3 / ev.count))
    rows.sort(reverse=True)
    # the aten:: rows repeat the device time of the kernels they launch
    dev_ms = sum(ms for ms, _, key, _ in rows
                 if not key.startswith("aten::")
                 and key != "Activity Buffer Request")
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


def split_host_pairs(tables, k, codes):
    """The native Sellers rows (``HostSellers``) over groups of patterns
    that each fit the native machine (at most 24 x 64 pattern bits), the
    candidate sets merged: the host route for a pattern set too wide for
    one machine.  Returns (ends, pids) like ``SellersScanner.host_pairs``."""
    from sequence_alignment_tools_tpu_torch.ops.host_scan import HostSellers
    from sequence_alignment_tools_tpu_torch.ops.tables import PatternTables

    groups, cur, bits = [], [], 0
    for p in range(tables.P):
        ln = int(tables.lengths[p])
        if cur and bits + ln > 24 * 64:
            groups.append(cur)
            cur, bits = [], 0
        cur.append(p)
        bits += ln
    groups.append(cur)
    ends_l, pids_l = [], []
    for g in groups:
        idx = np.asarray(g)
        sub = PatternTables(match=tables.match[idx],
                            lengths=tables.lengths[idx],
                            pat_codes=tables.pat_codes[idx],
                            Lmax=tables.Lmax, alpha=tables.alpha,
                            eos_code=tables.eos_code,
                            code_chars=tables.code_chars)
        hs = HostSellers(sub, k)
        if not hs.available():
            raise RuntimeError("native Sellers rows unavailable")
        e, pl, _d = hs.pairs(np.asarray(codes))
        ends_l.append(e)
        pids_l.append(idx[pl])
    return np.concatenate(ends_l), np.concatenate(pids_l).astype(np.int64)


@contextlib.contextmanager
def split_host_route():
    """The filter engine's host route through :func:`split_host_pairs`
    for the scans the CLI's host run makes."""
    from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner

    saved = (SellersScanner._host_eligible, SellersScanner.host_pairs)
    SellersScanner._host_eligible = lambda self, n: True
    SellersScanner.host_pairs = lambda self, codes: split_host_pairs(
        self.tables, self.k, codes)
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


def grouped_host_scan(tables, codes, bits=4096):
    """The native shift-and over groups of patterns that each fit its
    state (``bits``), merged to (window start, pattern) order: the host
    reference for a pattern set too wide for one machine."""
    from sequence_alignment_tools_tpu_torch.ops.host_scan import HostShiftAnd
    from sequence_alignment_tools_tpu_torch.ops.tables import PatternTables

    out = []
    p0 = 0
    while p0 < tables.P:
        p1 = p0
        used = 0
        while p1 < tables.P and used + int(tables.lengths[p1]) <= bits:
            used += int(tables.lengths[p1])
            p1 += 1
        sl = slice(p0, p1)
        sub = PatternTables(match=tables.match[sl], lengths=tables.lengths[sl],
                            pat_codes=tables.pat_codes[sl], Lmax=tables.Lmax,
                            alpha=tables.alpha, eos_code=tables.eos_code,
                            code_chars=tables.code_chars)
        host = HostShiftAnd(sub, 0, False)
        if not host.available():
            raise RuntimeError("native shift-and unavailable")
        out += [(e - int(sub.lengths[q]), p0 + q, e, m)
                for e, q, m in host.scan(codes)]
        p0 = p1
    return [(e, q, m) for _s, q, e, m in sorted(out)]


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


def run_cli(argv, tool="primer_match"):
    import importlib

    main = importlib.import_module(
        "sequence_alignment_tools_tpu_torch.apps." + tool).main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


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
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
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
    scan_occupancy.launches = 0
    got = list(sc.scan(codes))
    main_launches = scan_occupancy.launches
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
    main_dev = sc._device_form(codes)
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
    scan_occupancy.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_blocks = dict(sc.scan_stream(iter(blocks)))
    s_stream = time.perf_counter() - t0
    stream_launches = scan_occupancy.launches
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

    timings = {}
    for label, codes_dev, n in (("2^22", gate_dev, gate_n),
                                ("2^28", sc._device_form(codes), MAIN_N)):
        mbc, mbi = gate_inputs(codes_dev, n)
        g_ms = cuda_ms(lambda: seed_gate(codes_dev, n, dt_h, mbc, mbi, gt_h,
                                         EOS, True, 1 << 16), reps=10)
        r_ms = cuda_ms(lambda: seed_gate_ref(codes_dev, n, dt_h, mbc, mbi,
                                             gt_h, EOS, True, 1 << 16),
                       reps=3)
        row = gated_hits(codes_dev, n, dt_h, gt_h, EOS, True, n // 32,
                         1 << 16)
        timings[label] = (g_ms, r_ms)
        gate_counts = (int(row[0]), int(row[1]))
        log(f"seed_gate at n={label}, halves k=1 (40 seeds) on {smi}: "
            f"kernel {g_ms:.4f} ms, plain {r_ms:.4f} ms (CUDA events, "
            f"median); {int(row[0])} of {n // 32} microblocks are "
            f"candidates, {int(row[1])} gate survivors")
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
    scan_occupancy.launches = seed_gate.launches = 0
    got1 = list(m_dev.engine_hits())
    k1_launches = {"scan_occupancy": scan_occupancy.launches,
                   "seed_gate": seed_gate.launches}
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
    kedit_err = check_kedit(kcases)
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
    myers_pairs.launches = sellers_scan.launches = 0
    got2 = list(m2.engine_hits())
    k2_launches = {"myers_pairs": myers_pairs.launches,
                   "sellers_scan": sellers_scan.launches}
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
    main_dev = sc2._device_form(codes)
    mt2 = sc2._myers_t()
    my_cap = sc2._cap("myers", MAIN_N)
    my_row = myers_pairs(main_dev, MAIN_N, mt2, EOS, 2, my_cap)
    my_ref, my_plain = timed(lambda: myers_pairs_ref(main_dev, MAIN_N, mt2,
                                                     EOS, 2, my_cap))
    if row_set(my_row, my_cap, 2) != row_set(my_ref, my_cap, 2):
        raise AssertionError("myers_pairs differs from plain at 2^28")
    my_ms = cuda_ms(lambda: myers_pairs(main_dev, MAIN_N, mt2, EOS, 2,
                                        my_cap), reps=10)
    my_pairs_n = int(my_row[0])
    log(f"myers_pairs at n=2^28, P=20 ({mt2.nw} words), k=2 on {smi}: "
        f"kernel {my_ms:.4f} ms, plain {my_plain:.4f} ms (CUDA events; "
        f"equal; {my_pairs_n} pairs)")
    del main_dev, m2h

    # 8b. -K 2: the poisoned k-mismatch scan at 2^28
    mK = PrimerMatchModel(db, ps1, k=2, indels=False, device=dev)
    mK.use_host = False
    mKh = PrimerMatchModel(db, ps1, k=2, indels=False, device=dev)
    mKh.use_host = True
    wantK = list(mKh.engine_hits())
    scan_occupancy.launches = 0
    gotK = list(mK.engine_hits())
    if scan_occupancy.launches < 1:
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
    hends, hpids = split_host_pairs(scl.tables, 2, sub)
    wantl = list(ml._filter_emit(hends, hpids))
    log(f"Sellers route host reference (native Sellers rows over pattern "
        f"groups): {len(hends)} candidates, {len(wantl)} engine hits in "
        f"{time.perf_counter() - t0:.3f} s")
    myers_pairs.launches = sellers_scan.launches = 0
    gotl = list(ml.engine_hits())
    sel_launches = {"myers_pairs": myers_pairs.launches,
                    "sellers_scan": sellers_scan.launches}
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
    sl_dev = scl._device_form(sub)
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
    sdev = ssc._device_form(scodes)
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
    scan_occupancy.launches = 0
    got_pb = list(psc.scan(wdb.codes))
    want_pb = grouped_host_scan(wt_many, wdb.codes)
    if got_pb != want_pb or not got_pb:
        raise AssertionError(f"pattern-blocked scan differs from the host "
                             f"shift-and: {len(got_pb)} vs {len(want_pb)}")
    log(f"pattern-blocked rung: P={wt_many.P} degenerate primers, n=2^20: "
        f"{len(got_pb)} hits == native shift-and over pattern groups, "
        f"scan_occupancy launches {scan_occupancy.launches}")
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
    scan_slots.launches = 0
    got_e, got_p = xsc.scan_seed_arrays(pre)
    if scan_slots.launches < 1:
        raise AssertionError("p50k: the census never launched scan_slots")
    if not (np.array_equal(got_e, want_e) and np.array_equal(got_p, want_p)) \
            or not len(got_e):
        raise AssertionError(f"p50k device census differs from the host "
                             f"census: {len(got_e)} vs {len(want_e)} hits")
    scan_slots.launches = 0
    ends50, pids50 = xsc.scan_seed_arrays(codes)
    p50k_launches = scan_slots.launches
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
    main_dev = xsc._device_form(codes)
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
    scan_slots.launches = gate_slots.launches = 0
    got_k = mx_pre.engine_hits_arrays()
    if min(scan_slots.launches, gate_slots.launches) < 1:
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
    scan_slots.launches = gate_slots.launches = 0
    scan_occupancy.launches = seed_gate.launches = 0
    hes, hp, hv = mx.engine_hits_arrays()
    xk1_launches = {"scan_slots": scan_slots.launches,
                    "gate_slots": gate_slots.launches,
                    "scan_occupancy": scan_occupancy.launches,
                    "seed_gate": seed_gate.launches}
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

    scan_occupancy.launches = 0
    want_pairs = [pair_key(h) for h in mp.pairs()]
    if scan_occupancy.launches < 1 or len(want_pairs) < 10:
        raise AssertionError(f"pcr_match: {len(want_pairs)} pairs, "
                             f"{scan_occupancy.launches} launches")
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
                 ["-r", "-M", "2000", "-k", "1"], pm + ["seed_gate"])):
            argv = ["-i", db_file] + pats_flag + flags
            long_set = pats_flag[1] == lfile
            os.environ["SAT_HOST_SCAN"] = "0"
            for fn in (scan_occupancy, seed_gate, myers_pairs, sellers_scan,
                       scan_slots, gate_slots):
                fn.launches = 0
            t0 = time.perf_counter()
            out_dev = run_cli(argv, tool)
            s_cli = time.perf_counter() - t0
            cli_launches = {"scan_occupancy": scan_occupancy.launches,
                            "seed_gate": seed_gate.launches,
                            "myers_pairs": myers_pairs.launches,
                            "sellers_scan": sellers_scan.launches,
                            "scan_slots": scan_slots.launches,
                            "gate_slots": gate_slots.launches}
            del os.environ["SAT_HOST_SCAN"]
            # the long primers exceed one native Sellers machine: the
            # host run takes the machines over pattern groups (their gs
            # templates exceed the native shift-and too: both runs then
            # take the pattern-blocked rung, and the plants decide)
            with (split_host_route() if long_set
                  else contextlib.nullcontext()):
                out_host = run_cli(argv, tool)
            if min(cli_launches[kname] for kname in need) < 1:
                raise AssertionError(f"CLI {tool} {flags}: the device run "
                                     f"skipped a kernel: {cli_launches}")
            if out_dev != out_host or not out_dev:
                raise AssertionError(f"CLI {tool} {flags}: device and host "
                                     "outputs differ")
            if "-N" in flags and long_set and (
                    cli_launches["scan_occupancy"] < 4
                    or out_dev.count(">") < len(LONG)):
                raise AssertionError(
                    f"CLI gs over the long primers: {cli_launches}, "
                    f"{out_dev.count('>')} hits for {len(LONG)} exact plants")
            if tool == "pcr_match" and out_dev.count("\n") < 10:
                raise AssertionError("CLI pcr_match found fewer than its 10 "
                                     "planted pairs")
            log(f"CLI {tool} {' '.join(flags)}"
                f"{' (long primers)' if long_set else ''}"
                f"{' (600,000-base corpus)' if db_file == small else ''}: "
                f"{len(out_dev)} bytes, {out_dev.count(chr(10))} lines, "
                f"device == host, device run {s_cli:.3f} s, launches "
                f"{cli_launches}")

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
    cand28, surv28 = gate_counts
    lmax_s = int(dt_h.weights16.shape[0])
    gate_bound = bound(cand28 * (32 + lmax_s - 1 + 8) + 8 * surv28,
                       cand28 * 32 * int(dt_h.lengths.numel()) * 2
                       + surv28 * gt_h.Lg * (2 * gt_h.band + 1) * 4)
    # Myers: about 17 word operations per character and word
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
    sys.exit(main())
