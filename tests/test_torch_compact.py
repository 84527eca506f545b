"""The port's ``compact_mask`` against the JAX package's, exactly.

The JAX version has three branches (compact.py): one top_k for n <= 2^16
or when the two-level form would not pay, the cumsum form for dense caps,
and the two-level chunked top_k; each is covered, with and without
overflow (count > cap)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.ops.compact import compact_mask as jax_compact
from sequence_alignment_tools_tpu_torch.ops.compact import compact_mask

CASES = [
    (1, 4),             # n <= 2^16, cap > n
    (200, 16),          # n <= 2^16
    (50_000, 1024),     # n <= 2^16
    (70_000, 8192),     # dense cap: cap * 16 >= n > 2^16
    (70_000, 512),      # single top_k: cap * chunk * 2 >= n
    (500_000, 16),      # two-level chunked
    (500_000, 1024),    # two-level chunked
]


@pytest.mark.parametrize("p", [0.0, 1e-3, 0.05, 1.0])
@pytest.mark.parametrize("n,cap", CASES)
def test_compact_matches_jax(n, cap, p):
    rng = np.random.default_rng(n + cap + int(p * 1e4))
    mask = rng.random(n) < p
    want_count, want_idx = jax_compact(jnp.asarray(mask), cap)
    count, idx = compact_mask(torch.from_numpy(mask), cap)
    assert int(count) == int(want_count) == int(mask.sum())
    assert idx.shape == (cap,)
    assert np.array_equal(idx.numpy(), np.asarray(want_idx).astype(np.int64))


def test_compact_takes_any_shape():
    """A [rows, cols] mask compacts as its row-major flattening."""
    rng = np.random.default_rng(1)
    mask = rng.random((64, 20)) < 0.02
    count, idx = compact_mask(torch.from_numpy(mask), 8)
    flat = np.flatnonzero(mask.reshape(-1))
    want = np.full(8, mask.size)
    want[: min(8, flat.size)] = flat[:8]
    assert int(count) == flat.size
    assert np.array_equal(idx.numpy(), want)
