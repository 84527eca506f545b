"""Pattern tables on the device.

The JAX package's :func:`sequence_alignment_tools_tpu.ops.tables.build_tables`
builds the numpy ``PatternTables`` (the accept relation per pattern,
position and code) and is used as it is.  Its ``conv_weights`` ends in a
bfloat16 cast that needs ``ml_dtypes``, which ships with jax, so the
port builds the same weights here in float32 and moves them to the
device once per scanner.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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
    """The numpy ``PatternTables`` as the port's device tensors."""
    w = conv_weights_f32(tables, k, poison_eos)
    lengths = np.asarray(tables.lengths, np.int32)
    device = torch.device(device)
    return DeviceTables(
        weights=torch.from_numpy(w).to(device),
        weights16=torch.from_numpy(w.astype(np.int16)).to(device),
        thresholds=torch.from_numpy(lengths - np.int32(k)).to(device),
        lengths=torch.from_numpy(lengths.copy()).to(device),
    )
