"""PyTorch / CUDA port of sequence_alignment_tools_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  Module
names mirror the JAX package's, so each ported module sits where its
counterpart does (``ops/conv_scan.py``, ``models/primer_match.py``,
``apps/primer_match.py``).  The port imports nothing of the JAX package:
the host layers it needs are its own copies, kept byte-compatible
(``io/``, ``engine/``, ``native/``, ``utils/``, ``ops/host_scan.py`` and
``ops/tables.build_tables``); the native libraries build into
``build/sat_torch_native/`` at the repository root.

Every device kernel is hand-written CUDA C++ for ``sm_90a`` under
``ops/cuda/csrc``, built with nvcc at first use into ``build/`` at the
repository root; each has a plain PyTorch version beside it, which the
wrapper runs for tensors on the CPU.

Importing this package imports no torch, initialises no CUDA context
and installs no import hook: the scanners and models import torch when a
device route first needs it (``device.LazyDevice``), so a run whose
routes are all host routes never loads it (the site-less ``sat_torch``
launcher at the repository root is the cold one-shot entry point).
"""

__version__ = "0.1.0"
