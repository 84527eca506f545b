#!/usr/bin/env python3
"""Measurements behind PERF.md section 6 that ``chip_smoke.py`` does not
repeat on every run.

    python3 kernel_probe.py

On one NVIDIA GPU with the CUDA toolkit (``nvcc``, ``cuobjdump``):

1. the SASS (``cuobjdump -sass``) of this checkout's Myers and
   ``seed_gate`` kernels, counted by the pipe that issues each
   instruction: Myers per character and per word step at the main path's
   10 words (its instances for 10 and 11 words), ``seed_gate``'s
   innermost loops; and the same for an older commit's ``myers.cu`` and
   ``seed_gate.cu`` when ``chip_smoke.PARENT_DIR`` holds their sources;
2. Myers' exact word-count instances against padded ones: the bench
   primers with their reverse complements in 9, 10 and 11 words (9 and
   10 primers, and 10 with one more 13-mer), k = 2, over 2^28 random
   positions in entries of 2,000,000, through the instance of their word
   count and through the 12- and 16-word instances (inert padding
   words); pairs equal to the exact instance's, times in turns (exact,
   padded, padded, exact; CUDA events, median of 10).

The padded launches go through a library built from ``csrc/myers.cu``
itself (included by a small probe source under ``build/kernel_probe/``).
Exits 1 without a CUDA device.
"""

import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np

from chip_smoke import EOS, ENTRY, PARENT_DIR, PATS, TABLE, cuda_ms, log

PROBE_DIR = os.path.join("build", "kernel_probe")
MYERS_N = 1 << 28
EXTRA_PRIMER = "ACGTTGCAGTCCA"  # with the bench primers: 11 words
PADDED = (12, 16)
# the probe's own entry point: the launch of instance `inst` (>= nw)
MYERS_PROBE = r"""
#include "myers.cu"

extern "C" int probe_myers_as(int inst, const void* codes, int64_t n,
                              const void* eq, const int32_t* words, int nw,
                              int eos, int k, int segc, int halo, void* out,
                              int64_t cap, void* stream) {
  segc = (segc + 15) / 16 * 16;
  halo = (halo + 15) / 16 * 16;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  if (inst < nw) return static_cast<int>(cudaErrorInvalidValue);
  switch (inst) {
    case 9: return launch<9>(codes, nn, eq, words, nw, eos, k, segc, halo,
                             out, cap, s);
    case 10: return launch<10>(codes, nn, eq, words, nw, eos, k, segc, halo,
                               out, cap, s);
    case 11: return launch<11>(codes, nn, eq, words, nw, eos, k, segc, halo,
                               out, cap, s);
    case 12: return launch<12>(codes, nn, eq, words, nw, eos, k, segc, halo,
                               out, cap, s);
    case 16: return launch<16>(codes, nn, eq, words, nw, eos, k, segc, halo,
                               out, cap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


# SASS opcodes by the pipe that issues them on sm_90 (the integer ALU
# pipe at 64 lanes per SM and clock, the FMA pipe that also takes IMAD,
# memory, control, the uniform datapath)
SASS_PIPES = {
    "alu": {"LOP3", "LOP", "SHF", "IADD3", "ISETP", "IMNMX", "VIMNMX",
            "VIMNMX3", "VIADD", "VIADDMNMX", "SEL", "PRMT", "LEA", "FLO",
            "BMSK", "SGXT", "PLOP3", "P2R", "R2P", "IABS", "MOV", "POPC",
            "BREV", "VOTE", "FSEL", "FSETP"},
    "fma": {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2"},
    "mem": {"LDS", "LDG", "STS", "STG", "ATOM", "ATOMS", "ATOMG", "RED",
            "LD", "ST", "LDC", "SHFL", "MATCH"},
    "control": {"BRA", "BSSY", "BSYNC", "EXIT", "WARPSYNC", "NOP", "BAR",
                "CALL", "RET", "DEPBAR", "YIELD"},
}


def sass_functions(lib):
    """{kernel name: [(address, predicate, instruction)]} of a built
    library's SASS (``cuobjdump -sass``), or {} where the tool is
    missing."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.access(tool, os.X_OK):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        ins = []
        for line in part.split("\n"):
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                t = m.group(2).strip()
                pred = ""
                if t.startswith("@"):
                    pred, t = t.split(None, 1)
                ins.append((int(m.group(1), 16), pred, t))
        out[part.split("\n")[0].strip()] = ins
    return out


def sass_loops(ins, voted=True):
    """[(first, last address, {pipe: count}, [instructions])] of each loop
    (a backward branch) of one kernel, innermost first; with ``voted``
    without the code that a warp vote branches around (a hit's emission,
    rarely run)."""
    loops = []
    for a, _p, t in ins:
        if t.startswith("BRA"):
            tgt = int(t.split()[-1], 16)
            if tgt < a:
                loops.append((tgt, a))
    skip = vote_skips(ins) if voted else []
    return [(lo, hi, *sass_region(ins, lo, hi + 1, skip))
            for lo, hi in sorted(loops, key=lambda x: x[1] - x[0])]


def vote_skips(ins):
    """[(first, end address)] of the code that a warp vote branches
    around: from each VOTE.ANY, the first predicated forward branch."""
    skip = []
    for i, (a, _p, t) in enumerate(ins):
        if t.startswith("VOTE.ANY"):
            for a2, p2, t2 in ins[i + 1 : i + 120]:
                if t2.startswith("BRA") and p2 and int(t2.split()[-1],
                                                       16) > a2:
                    skip.append((a2 + 16, int(t2.split()[-1], 16)))
                    break
    return skip


def sass_region(ins, lo, hi, skip=()):
    """({pipe: count}, [instructions]) of addresses [lo, hi) outside the
    ``skip`` ranges."""
    c = {}
    body = []
    for a, _p, t in ins:
        if lo <= a < hi and not any(x <= a < y for x, y in skip):
            op = t.split()[0].split(".")[0]
            body.append(t)
            pipe = next((k for k, v in SASS_PIPES.items() if op in v),
                        "uniform" if op.startswith("U") else "other")
            c[pipe] = c.get(pipe, 0) + 1
    return c, body


def sass_counts(lib, key, needs=()):
    """({pipe: count}, instructions) of the innermost loop of the kernel
    of ``lib`` whose name contains ``key`` and whose body holds an
    instruction starting with each of ``needs``; ({}, []) where no SASS
    can be read."""
    for name, ins in sass_functions(lib).items():
        if key in name:
            for _lo, _hi, c, body in sass_loops(ins):
                if all(any(t.startswith(x) for t in body) for x in needs):
                    return c, body
    return {}, []


def sass_line(label, c, body, unit):
    log(f"SASS {label}: {sum(c.values())} instructions per {unit} "
        f"({', '.join(f'{k} {v:g}' for k, v in sorted(c.items()))}); "
        f"{', '.join(f'{op} {body.count(op)}' for op in sorted(set(body), key=body.count, reverse=True)[:8])}")


def sass_loops_report(label, lib, key, count=6):
    """Log the pipe counts of the ``count`` smallest loops of the kernels
    of ``lib`` whose names contain ``key``."""
    for name, ins in sass_functions(lib).items():
        if key not in name:
            continue
        for lo, hi, c, body in sass_loops(ins, voted=False)[:count]:
            sass_line(f"{label} {name[:60]} loop {lo:#x}-{hi:#x}", c,
                      [t.split()[0] for t in body], "trip")


def per_step(a, b, div):
    """{pipe: (b - a) / div}, and its total."""
    d = {k: (b.get(k, 0) - a.get(k, 0)) / div for k in set(a) | set(b)}
    return {k: v for k, v in d.items() if v}, sum(d.values())


def myers_sass(label, lib, parent):
    """Log the Myers kernel's instructions per character and per word
    step, by pipe, at the main path's 10 words: this form's instances for
    10 and 11 words (one character of the unrolled path without EOS), the
    older form's for 16 and 8 words (one character a loop trip, each word
    behind a guard)."""
    if parent:
        c16 = sass_counts(lib, "myers_kernelILi16E", ("VOTE.ANY",))[0]
        c8 = sass_counts(lib, "myers_kernelILi8E", ("VOTE.ANY",))[0]
        word, wt = per_step(c8, c16, 8)
        char = {k: c16.get(k, 0) - 6 * word.get(k, 0) for k in c16}
    else:
        # one character of the path without EOS: from the row load of the
        # second character to that of the third, less the hit decode
        fns = sass_functions(lib)
        per_char = []
        for key in ("myers_kernelILi10E", "myers_kernelILi11E"):
            ins = next((v for k, v in fns.items() if key in k), [])
            rows = [a for a, _p, t in ins
                    if t.startswith("LDS.128") and "+" not in t]
            if len(rows) < 3:
                per_char.append({})
                continue
            lo, hi = rows[1], rows[2]
            skip = [(x, y) for x, y in vote_skips(ins) if lo <= x and y <= hi]
            per_char.append(sass_region(ins, lo, hi, skip)[0])
        word, wt = per_step(per_char[0], per_char[1], 1)
        char = per_char[0]
    if not char:
        log(f"SASS {label}: not read (no cuobjdump)")
        return
    log(f"SASS {label}, 10 words: {sum(char.values()):g} instructions per "
        f"character ({', '.join(f'{k} {v:g}' for k, v in sorted(char.items()))}"
        f"); a word step {wt:g} "
        f"({', '.join(f'{k} {v:g}' for k, v in sorted(word.items()))})")


def build_probe_libs():
    """{name: library path}, built in parallel under ``PROBE_DIR``: the
    probe library over this checkout's ``myers.cu``, and the older
    ``myers.cu`` and ``seed_gate.cu`` where ``PARENT_DIR`` holds them; each
    build's wall time is logged (they share the host's cores)."""
    from sequence_alignment_tools_tpu_torch.ops.cuda.build import (
        CSRC,
        NVCC_FLAGS,
        _nvcc,
    )

    os.makedirs(PROBE_DIR, exist_ok=True)
    src = os.path.join(PROBE_DIR, "myers_probe.cu")
    with open(src, "w") as f:
        f.write(MYERS_PROBE)
    jobs = {"myers_probe": ["-I", str(CSRC), src]}
    for name in ("myers", "seed_gate"):
        older = os.path.join(PARENT_DIR, name + ".cu")
        if os.path.exists(older):
            jobs["older_" + name] = [older]
    t0 = time.perf_counter()
    procs = {}
    for name, args in jobs.items():
        out = os.path.abspath(os.path.join(PROBE_DIR, f"lib{name}.so"))
        procs[name] = (out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", out, *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    took = {}
    while len(took) < len(procs):
        for name, (_out, proc) in procs.items():
            if name not in took and proc.poll() is not None:
                took[name] = time.perf_counter() - t0
        time.sleep(0.05)
    libs = {}
    for name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: {text.decode(errors='replace')}")
        log(f"built {name} in {took[name]:.1f} s")
        libs[name] = out
    return libs


def pair_set(row, cap):
    """The sorted (pos, pid) pairs of a Myers row, all of them kept."""
    count = int(row[0])
    if count > cap:
        raise AssertionError(f"{count} pairs overflow the cap {cap}")
    pos = row[1 : 1 + count].cpu().numpy()
    pid = row[1 + cap : 1 + cap + count].cpu().numpy()
    return sorted(zip(pos.tolist(), pid.tolist()))


def myers_padding(probe_lib, smi):
    """Time each word count's exact instance against the padded ones."""
    import torch

    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.io.patterns import (
        build_pattern_set,
    )
    from sequence_alignment_tools_tpu_torch.ops.cuda.myers import (
        myers_pairs,
        myers_segc,
        myers_tables,
    )
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = ctypes.CDLL(probe_lib).probe_myers_as
    fn.restype = i32
    fn.argtypes = [i32, vp, i64, vp, ctypes.POINTER(ctypes.c_int32), i32,
                   i32, i32, i32, i32, vp, i64, vp]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20240601)
    codes = torch.randint(0, 4, (MYERS_N,), generator=gen, device=dev,
                          dtype=torch.uint8)
    codes[ENTRY :: ENTRY + 1] = EOS
    small = np.zeros(64, np.uint8)
    db = SeqDB(codes=small, table=TABLE, entry_starts=np.array([0]),
               entry_lengths=np.array([len(small)]), headers=["alphabet"])
    k, cap = 2, 1 << 20
    for pats in (PATS[:9], PATS, PATS + [EXTRA_PRIMER]):
        mt = myers_tables(build_tables(build_pattern_set(pats, rev_comp=True),
                                       db, wc=False, textn=False)).to(dev)
        nw = mt.nw
        halo = mt.Lmax + k
        segc = myers_segc(MYERS_N, halo)
        words = np.ascontiguousarray(mt.words_np, np.int32)

        def run(inst):
            out = torch.zeros(1 + 2 * cap, dtype=torch.int32, device=dev)
            rc = fn(inst, codes.data_ptr(), MYERS_N, mt.eq.data_ptr(),
                    words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), nw,
                    EOS, k, segc, halo, out.data_ptr(), cap,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"probe_myers_as({inst}): cudaError_t "
                                   f"{rc}")
            return out

        want = pair_set(myers_pairs(codes, MYERS_N, mt, EOS, k, cap), cap)
        if pair_set(run(nw), cap) != want or not want:
            raise AssertionError(f"{nw} words: the probe's exact instance "
                                 "differs from myers_pairs")
        for inst in PADDED:
            if pair_set(run(inst), cap) != want:
                raise AssertionError(f"{nw} words on the {inst}-word "
                                     "instance: pairs differ")
            e1 = cuda_ms(lambda: run(nw))
            p1 = cuda_ms(lambda inst=inst: run(inst))
            p2 = cuda_ms(lambda inst=inst: run(inst))
            e2 = cuda_ms(lambda: run(nw))
            log(f"myers at n=2^28, P={2 * len(pats)} in {nw} words, k={k} "
                f"({len(want)} pairs, equal) on {smi}: exact instance "
                f"{e1:.4f}, {e2:.4f} ms; {inst}-word instance {p1:.4f}, "
                f"{p2:.4f} ms ({(p1 + p2) / (e1 + e2) - 1:+.1%}; CUDA "
                f"events, median of 10; exact, padded, padded, exact)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: torch.cuda.is_available() is False; this "
              "script measures the port's kernels on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from sequence_alignment_tools_tpu_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    probe = build_probe_libs()
    myers_sass("myers.cu", str(libs["myers"]), False)
    # the main path's instance: direct mask rows, band 1
    sass_loops_report("seed_gate.cu", str(libs["seed_gate"]),
                      "seed_gate_kernelILb1ELi1E", 6)
    if "older_myers" in probe:
        myers_sass("older myers.cu", probe["older_myers"], True)
    if "older_seed_gate" in probe:
        sass_loops_report("older seed_gate.cu", probe["older_seed_gate"],
                          "seed_gate_kernelILb1E", 6)
    myers_padding(probe["myers_probe"], smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
