"""The port's copy of ``sequence_alignment_tools_tpu/io/__init__.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from .fasta import iter_fasta, read_fasta  # noqa: F401
from .database import SeqDB  # noqa: F401
