"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/sat_torch_kernels/``
at the repository root, and loaded with ctypes.  Every source is built
from this checkout at first use: all nvcc processes start together,
under a file lock, and a library is rebuilt when its source or a shared
header (``csrc/*.cuh``) changes (the file name carries a hash of both).
A failed build raises with nvcc's output; nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "sat_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every stale ``csrc/*.cu`` (in parallel, one nvcc each) and
    return ``{name: library path}``."""
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = []
        for src in sources:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(".tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {src.stem: _target(src) for src in sources}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        _bind(name, lib)
        _LIBS[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if name == "scan_filter":
        lib.sat_scan_occupancy.restype = i32
        lib.sat_scan_occupancy.argtypes = [
            vp, i64, i32,       # codes, n, eos
            vp, i32,            # bits, R
            vp, vp, i32, i32,   # ent, pat, P, J
            vp, vp, i32, i32,   # cls_off, cls_rows, direct, small
            vp, i64,            # occ, nmb
            vp,                 # stream
        ]
    elif name == "seed_gate":
        lib.sat_seed_gate.restype = i32
        lib.sat_seed_gate.argtypes = [
            vp, i64,            # codes, n
            vp, vp, vp,         # w, thr, lengths
            i32, i32, i32,      # Lmax, alpha, P
            i32,                # eos
            vp, vp, i64,        # mb_count, mb_idx, cap_mb
            vp, vp, vp,         # gate bits, glen, gdir
            i32, i32, i32, i32,  # Lg, k, band, indels
            vp, i64,            # out, cap
            vp,                 # stream
        ]
    elif name == "seed_slots":
        lib.sat_seed_slots.restype = i32
        lib.sat_seed_slots.argtypes = [
            vp, i64, i32,       # codes, n, alpha
            vp, i32, i32,       # cls, ncls, Lmax
            vp, vp, vp, vp,     # keys, head, enext, epid
            vp, i32,            # presence filter, its bits (log2)
            vp, i64,            # out, cap
            vp,                 # stream
        ]
    elif name == "gate_slots":
        lib.sat_gate_slots.restype = i32
        lib.sat_gate_slots.argtypes = [
            vp, i64,            # codes, n
            vp, i64,            # slots, cap_in
            vp,                 # lengths
            vp, vp, vp,         # gate bits, glen, gdir
            i32, i32, i32, i32,  # Lg, k, band, indels
            vp, i64,            # out, cap
            vp,                 # stream
        ]
    elif name == "myers":
        lib.sat_myers_pairs.restype = i32
        lib.sat_myers_pairs.argtypes = [
            vp, i64, vp,        # codes, n, eq
            ctypes.POINTER(ctypes.c_int32), i32,  # host words [nw, 4], nw
            i32, i32,           # eos, k
            i32, i32,           # segc, halo
            vp, i64,            # out, cap
            vp,                 # stream
        ]
    elif name == "sellers":
        lib.sat_sellers_plan.restype = i32
        lib.sat_sellers_plan.argtypes = [
            i64, i32, i32, i32,  # n, P, Lmax, alpha
            i32, i32, i32,      # k, indels, segc requested
            i64, ctypes.POINTER(ctypes.c_int64),  # scratch max, plan [3]
        ]
        lib.sat_sellers_scan.restype = i32
        lib.sat_sellers_scan.argtypes = [
            vp, i64,            # codes, n
            vp, vp,             # peq, lens
            i32, i32, i32,      # P, Lmax, alpha
            i32, i32, i32,      # eos, k, indels
            i64, i64,           # segc, halo
            vp, i64,            # out, cap
            vp, i64,            # scratch, its bytes
            vp,                 # stream
        ]
