"""Native (C++) host-runtime components of the port.

The port's copy of ``sequence_alignment_tools_tpu/native/``: the same
four C++ sources and the same C interfaces, built as C-ABI shared
libraries on first use with ``g++`` and bound with ctypes.  Callers fall
back to their pure-Python paths when the toolchain is unavailable or
``SAT_TPU_NO_NATIVE`` is set.

The libraries go to ``build/sat_torch_native/`` at the repository root
(``SAT_TORCH_NATIVE_DIR`` overrides it), never to the JAX package's
cache, so the two packages neither share nor race over one ``.so``.  A
library's file name carries a hash of its source, and concurrent
builders (pytest workers, the filter engine's tail processes) serialise
on a file lock, so a stale or half-written library is never loaded; the
threads of one process serialise their first load on a lock, so none
sees another's unfinished load as "unavailable".

- ``verify_dp.cpp``: the per-candidate banded edit-distance DP of the
  filter -> verify pipeline, the seed extension and the pair sort.
- ``fasta_pack.cpp``: FASTA pass 1 (parse, filter, uppercase, EOS layout).
- ``sais.cpp``: SA-IS suffix array construction.
- ``shift_and.cpp``: the host shift-and and Sellers row machines, the
  threaded mer-hash census with its inline gate, and the last-hit dedup.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIBS: dict[str, object] = {}
_LOAD_LOCK = threading.Lock()


def _build_dir() -> str:
    d = os.environ.get(
        "SAT_TORCH_NATIVE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                     "sat_torch_native"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _load(name: str, src_name: str):
    """Build (if missing) and dlopen native/<src_name> as
    lib<name>_<hash>.so; None when the toolchain is unavailable or
    SAT_TPU_NO_NATIVE is set."""
    if os.environ.get("SAT_TPU_NO_NATIVE"):
        return None
    if name in _LIBS:
        return _LIBS[name]
    with _LOAD_LOCK:
        if name not in _LIBS:
            _LIBS[name] = _build_and_load(name, src_name)
    return _LIBS[name]


def _build_and_load(name: str, src_name: str):
    """The loaded library, built first when its file is missing; None on
    any failure."""
    src = os.path.join(_HERE, src_name)
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        d = _build_dir()
        out = os.path.join(d, f"lib{name}_{digest}.so")
        if not os.path.exists(out):
            with open(os.path.join(d, "lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(out):
                    tmp = f"{out}.{os.getpid()}.tmp"
                    r = subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-pthread",
                         "-o", tmp, src],
                        capture_output=True,
                    )
                    if r.returncode != 0:
                        return None
                    os.replace(tmp, out)
        return ctypes.CDLL(out)
    except Exception:
        return None


def load_verify_lib():
    """Load (building if needed) the native verify DP; None if unavailable."""
    lib = _load("satverify", "verify_dp.cpp")
    if lib is None or getattr(lib, "_sat_bound", False):
        return lib
    c_i8p = ctypes.POINTER(ctypes.c_int8)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sat_verify_align.restype = ctypes.c_int
    lib.sat_verify_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,       # pat
        ctypes.c_char_p, ctypes.c_int32,       # buffer
        c_i8p,                                 # cids
        ctypes.c_int32, ctypes.c_uint8,        # k, eos
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # wc, tn, indels
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # dm, trans, yesno
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,  # esb, eeb, free
        c_u8p, c_i8p, c_i8p,                   # compat, aasub, aacodonsub
        c_i32p, c_i32p, c_i32p, c_i32p,        # found, bestval, bs, endt
        c_i32p, ctypes.c_int32, c_i32p,        # codes, cap, ncodes
        c_i64p,                                # stats
    ]
    lib.sat_extend_align.restype = ctypes.c_int
    lib.sat_extend_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,       # text
        ctypes.c_char_p, ctypes.c_int32,       # pattern
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # dirn, lm, rm
        ctypes.c_int32, ctypes.c_uint8,        # k, eos
        ctypes.c_int32, ctypes.c_int32,        # wc, textn
        ctypes.c_int32, ctypes.c_int32,        # indels, dna_mut
        c_u8p, c_i8p,                          # compat, aasub
        c_i32p, c_i32p, c_i32p,                # ok, matchlen, value
    ]
    lib.sat_extend_align_batch.restype = ctypes.c_int
    lib.sat_extend_align_batch.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p,          # codes, n, ch_of
        c_u8p, c_i32p, c_i32p,                 # expats, ext_off, ext_len
        c_i32p, c_i32p, c_i32p,                # dirs, la, ra
        c_i32p, c_i32p,                        # geomA, geomB
        c_i64p, c_i32p, ctypes.c_int64,        # anchors, sids, ncand
        ctypes.c_int32, ctypes.c_uint8,        # k, eos
        ctypes.c_int32, ctypes.c_int32,        # wc, textn
        ctypes.c_int32, ctypes.c_int32,        # indels, dna_mut
        c_u8p, c_i8p,                          # compat, aasub
        c_i32p, c_i64p, c_i32p,                # ok, end, value
    ]
    lib.sat_verify_align_batch.restype = ctypes.c_int
    lib.sat_verify_align_batch.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p,          # codes, n, ch_of
        c_u8p, c_i32p, c_i32p,                 # pats, pat_off, pat_len
        c_i32p, c_i32p,                        # esb, eeb
        c_i64p, c_i64p, c_i32p, ctypes.c_int64,  # poslb, posub, sids, n
        ctypes.c_int32, ctypes.c_uint8,        # k, eos
        ctypes.c_int32, ctypes.c_int32,        # wc, textn
        ctypes.c_int32, ctypes.c_int32,        # indels, dna_mut
        c_u8p, c_i8p,                          # compat, aasub
        c_i32p, c_i64p, c_i64p, c_i32p,        # found, start, end, value
    ]
    lib.sat_sort_pairs.restype = None
    lib.sat_sort_pairs.argtypes = [c_i64p, c_i64p, ctypes.c_int64]
    lib._sat_bound = True
    return lib


def load_fasta_lib():
    """Native FASTA pass-1 packer; None if unavailable."""
    lib = _load("satfasta", "fasta_pack.cpp")
    if lib is None or getattr(lib, "_sat_bound", False):
        return lib
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sat_fasta_pass1.restype = ctypes.c_int64
    lib.sat_fasta_pass1.argtypes = [
        c_u8p, ctypes.c_int64,                 # data, n
        ctypes.c_int32, ctypes.c_int32,        # filter_mode, uppercase
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint8,  # eos, init_eos, char
        c_u8p,                                 # out_seq
        c_i64p, c_i64p,                        # entry_starts, entry_lengths
        c_i64p, c_i64p,                        # hdr_start, hdr_end
        ctypes.c_int64,                        # max_entries
        c_i64p,                                # out_meta [seq_len, n_entries]
    ]
    lib._sat_bound = True
    return lib


def load_shift_and_lib():
    """Native bit-parallel multi-pattern scanner; None if unavailable."""
    lib = _load("satshiftand", "shift_and.cpp")
    if lib is None or getattr(lib, "_sat_bound", False):
        return lib
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_u64p = ctypes.POINTER(ctypes.c_uint64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sat_shift_and_scan.restype = ctypes.c_int64
    lib.sat_shift_and_scan.argtypes = [
        c_u8p, ctypes.c_int64,                 # codes, n
        c_u64p, ctypes.c_int32, ctypes.c_int32,  # u, alpha, nwords
        c_u64p, c_u64p,                        # s, e
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # k, poison, eos
        c_u64p,                                # rows scratch
        c_i64p, c_i32p, c_i32p, ctypes.c_int64,  # out_end/bit/mism, cap
    ]
    lib.sat_shift_and_scan_mt.restype = ctypes.c_int64
    lib.sat_shift_and_scan_mt.argtypes = [
        c_u8p, ctypes.c_int64,                 # codes, n
        c_u64p, ctypes.c_int32, ctypes.c_int32,  # u, alpha, nwords
        c_u64p, c_u64p,                        # s, e
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # k, poison, eos
        ctypes.c_int32, ctypes.c_int32,        # halo, nthreads
        c_i64p, c_i32p, c_i32p, ctypes.c_int64,  # out_end/bit/mism, cap
    ]
    c_i8p = ctypes.POINTER(ctypes.c_int8)
    lib.sat_mer_scan.restype = ctypes.c_int64
    lib.sat_mer_scan.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int32,  # codes, n, L
        ctypes.c_int64,                         # alpha
        c_u64p, c_i32p, c_i32p, c_i32p,         # keys, head, enext, epid
        ctypes.c_int64, c_u64p,                 # tsize, bloom
        ctypes.c_int32,                         # bloom_bits
        c_i8p, c_u8p, c_u8p,                    # gate dir/pref/glen
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # G, gk, gband
        c_u64p,                                 # gate_pack (or NULL)
        ctypes.c_int32,                         # nthreads
        c_i64p, c_i32p, ctypes.c_int64,         # out_start/pid, cap
    ]
    lib.sat_mer_scan_d4.restype = ctypes.c_int64
    lib.sat_mer_scan_d4.argtypes = [
        c_u8p, c_u8p,                           # codes, 2-bit pack
        c_i64p, ctypes.c_int64,                 # bad positions, nbad
        ctypes.c_int64, ctypes.c_int32,         # n, L
        c_i32p, c_i32p, c_i32p,                 # head4, enext, epid
        c_u64p,                                 # presence bitmap
        ctypes.c_int32, ctypes.c_int32,         # gk, gband
        c_u64p,                                 # gate_pack (or NULL)
        ctypes.c_int32,                         # nthreads
        c_i64p, c_i32p, ctypes.c_int64,         # out_start/pid, cap
    ]
    lib.sat_lasthit_dedup.restype = ctypes.c_int64
    lib.sat_lasthit_dedup.argtypes = [
        c_i64p, c_i64p, ctypes.c_int64,        # pid, he, m
        ctypes.c_int64,                        # dedup distance
        c_i64p, c_u8p,                         # lasthit scratch, keep out
    ]
    lib.sat_sellers_scan.restype = ctypes.c_int64
    lib.sat_sellers_scan.argtypes = [
        c_u8p, ctypes.c_int64,                 # codes, n
        c_u64p, ctypes.c_int32, ctypes.c_int32,  # u, alpha, nwords
        c_u64p, c_u64p, c_u64p,                # s, e, init
        ctypes.c_int32, ctypes.c_int32,        # k, eos
        ctypes.c_int32, ctypes.c_int32,        # halo, nthreads
        c_i64p, c_i32p, c_i32p, ctypes.c_int64,  # out_end/bit/mism, cap
    ]
    lib._sat_bound = True
    return lib


def load_sais_lib():
    """Native SA-IS suffix array builder; None if unavailable."""
    lib = _load("satsais", "sais.cpp")
    if lib is None or getattr(lib, "_sat_bound", False):
        return lib
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sat_suffix_array.restype = ctypes.c_int
    lib.sat_suffix_array.argtypes = [c_u8p, ctypes.c_int64, c_i64p]
    lib._sat_bound = True
    return lib
