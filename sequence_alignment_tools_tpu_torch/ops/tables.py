"""Pattern tables: the host build and the device operands.

:func:`build_tables` is the port's copy of the JAX package's
``ops/tables.build_tables``: the numpy ``PatternTables`` (the accept
relation per pattern, position and code).  The JAX ``conv_weights`` ends
in a bfloat16 cast that needs ``ml_dtypes``, which ships with jax, so the
port builds the same weights here in float32 (:func:`conv_weights_f32`)
and moves them to the device once per scanner (:func:`device_tables`).
The host build imports no torch; :func:`device_tables` imports it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from ..io.database import SeqDB
from ..io.patterns import PatternSet
from ..utils import trace
from ..utils.iupac import COMPATIBLE

if TYPE_CHECKING:
    import torch

# the extension gate's accept words (``gate.GateTables``) hold one bit per
# code below this (int32, bit 30 the out-of-range sentinel): wider
# alphabets take the ungated routes
GATE_ALPHA = 30


@dataclass
class PatternTables:
    match: np.ndarray  # [P, Lmax, alpha] bool
    lengths: np.ndarray  # [P] int32
    pat_codes: np.ndarray  # [P, Lmax] int16, -1 pad / unmappable
    Lmax: int
    alpha: int
    eos_code: int
    # producer alphabet chars per code (db.table); None when unknown
    code_chars: bytes | None = None

    @property
    def P(self) -> int:
        return len(self.lengths)


def build_tables(ps: PatternSet, db: SeqDB, wc: bool,
                 textn: bool) -> PatternTables:
    """Accept tables of ``ps`` over ``db``'s alphabet (IUPAC wildcard
    expansion with the text-N rule under ``wc``)."""
    P = ps.n_total
    Lmax = max(ps.max_len, 1)
    alpha = db.alphabet_size
    match = np.zeros((P, Lmax, alpha), dtype=bool)
    lengths = np.zeros(P, dtype=np.int32)
    pat_codes = np.full((P, Lmax), -1, dtype=np.int16)
    for p in range(P):
        pat = ps.pattern(p + 1)
        lengths[p] = len(pat)
        for j, ch in enumerate(pat):
            compat = COMPATIBLE.get(ch.upper()) if wc else None
            if wc and compat is not None:
                for cch in compat:
                    code = db.nch(cch)
                    if code >= 0 and (cch != "N" or textn):
                        match[p, j, code] = True
            else:
                code = db.nch(ch)
                if code >= 0:
                    match[p, j, code] = True
                    pat_codes[p, j] = code
    return PatternTables(
        match=match,
        lengths=lengths,
        pat_codes=pat_codes,
        Lmax=Lmax,
        alpha=alpha,
        eos_code=db.eos_code,
        code_chars=bytes(db.table) if getattr(db, "table", None) else None,
    )


@dataclass(frozen=True)
class DeviceTables:
    """The scan operands of one pattern set, k and EOS mode on one device.

    ``weights``: [Lmax, alpha, P] float32, ``conv_weights`` semantics:
    1 where pattern position j accepts code c, with the EOS column set to
    ``-(Lmax + k + 1)`` inside each pattern's length under ``poison_eos``.
    ``weights16``: the same values as int16, the scan filter kernel's
    operand (the poison reaches -129 at Lmax = 128, k = 0, past int8).
    ``thresholds``: [P] int32, ``lengths - k``; ``lengths``: [P] int32.
    """

    weights: torch.Tensor
    weights16: torch.Tensor
    thresholds: torch.Tensor
    lengths: torch.Tensor


def conv_weights_f32(tables, k: int, poison_eos: bool) -> np.ndarray:
    """``conv_weights(tables, k, poison_eos)`` in float32 (no bfloat16
    cast): [Lmax, alpha, P], score(i, p) = sum_j W[j, text[i+j], p]."""
    w = tables.match.astype(np.float32)
    if poison_eos:
        in_range = np.arange(tables.Lmax)[None, :] < tables.lengths[:, None]
        w[..., tables.eos_code] = np.where(
            in_range, -(tables.Lmax + k + 1.0), 0.0)
    return np.ascontiguousarray(w.transpose(1, 2, 0))


def device_tables(tables, k: int, poison_eos: bool, device) -> DeviceTables:
    """The numpy ``PatternTables`` as the port's device tensors (their
    bytes counted in ``upload.bytes``)."""
    import torch

    with trace.span("scan.tables"):
        w = conv_weights_f32(tables, k, poison_eos)
        lengths = np.asarray(tables.lengths, np.int32)
        host = (w, w.astype(np.int16), lengths - np.int32(k), lengths.copy())
        device = torch.device(device)
        dt = DeviceTables(*(torch.from_numpy(a).to(device) for a in host))
    trace.count("upload.bytes", sum(a.nbytes for a in host))
    return dt
