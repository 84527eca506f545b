"""PyTorch / CUDA port of sequence_alignment_tools_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  Module
names mirror the JAX package's, so each ported module sits where its
counterpart does (``ops/conv_scan.py``, ``models/primer_match.py``,
``apps/primer_match.py``).  The JAX package's host layers carry no jax
and are imported as they are: ``io/``, ``engine/``, ``native/``,
``utils/``, ``ops/tables.build_tables`` and ``ops/host_scan``.

Every device kernel is hand-written CUDA C++ for ``sm_90a`` under
``ops/cuda/csrc``, built with nvcc at first use into ``build/`` at the
repository root; each has a plain PyTorch version beside it, which the
wrapper runs for tensors on the CPU.

Importing this package initialises no CUDA context and installs no
import hook.  torch is imported first, before the JAX package's host
layers add their deferred-jax meta-path finder, so that nothing torch
probes while it loads ever reaches that finder.
"""

import torch  # noqa: F401

__version__ = "0.1.0"
