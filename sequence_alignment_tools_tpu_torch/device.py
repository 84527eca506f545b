"""The one device a scanner or model runs on.

Every scanner and model takes a ``device=`` argument and keeps the
resolved ``torch.device``; nothing picks a device behind the caller's
back.  ``None`` means the CLI's choice: the ``SAT_DEVICE`` environment
variable, ``cuda`` when it is unset.  Asking for CUDA where
``torch.cuda.is_available()`` is False raises: no route falls back to the
CPU on its own.  The CPU is used only when asked for by name (the tests
pass ``device="cpu"``).
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (a string, a ``torch.device`` or
    ``None`` for ``$SAT_DEVICE``, default ``cuda``)."""
    if device is None:
        device = os.environ.get("SAT_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; set SAT_DEVICE=cpu to run the plain PyTorch versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
