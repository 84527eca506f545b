"""The port's copy of ``sequence_alignment_tools_tpu/utils/__init__.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from . import iupac  # noqa: F401
