"""The one device a scanner or model runs on.

Every scanner and model takes a ``device=`` argument and keeps it as
given; nothing picks a device behind the caller's back.  ``None`` means
the CLI's choice: the ``SAT_DEVICE`` environment variable, ``cuda`` when
it is unset.  Asking for CUDA where ``torch.cuda.is_available()`` is
False raises: no route falls back to the CPU on its own.  The CPU is used
only when asked for by name (the tests pass ``device="cpu"``).

The argument is resolved (torch imported, CUDA checked) the first time a
device route reads ``device`` (:class:`LazyDevice`), so a run whose
routes are all host routes (the native machines) never imports torch.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (a string, a ``torch.device`` or
    ``None`` for ``$SAT_DEVICE``, default ``cuda``)."""
    import torch

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


def device_type(device=None) -> str:
    """The type (``cuda``, ``cpu``) of the device ``device`` names, read
    without importing torch or touching CUDA."""
    if device is None:
        device = os.environ.get("SAT_DEVICE", "cuda")
    if isinstance(device, str):
        return device.split(":", 1)[0]
    return device.type


class LazyDevice:
    """The ``device`` attribute of a scanner or model: its ``device=``
    argument (kept as ``_device_arg``) through :func:`resolve_device`,
    resolved on the first read and kept."""

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        dev = obj.__dict__.get("_device")
        if dev is None:
            dev = obj.__dict__["_device"] = resolve_device(obj._device_arg)
        return dev
