"""The port's device tables against the JAX package's ``conv_weights``."""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu.ops.tables import build_tables, conv_weights
from sequence_alignment_tools_tpu_torch.ops.tables import device_tables

DNA = ["AGAAGCGAGTTCT", "CTATTGATAAGGGAGTGC", "TCATGAAGTAAAC"]
IUPAC = ["ACGNRTTAC", "GGYSWAACT", "TTKMBDHVA", "ACGTACGTNN"]


def _db(table: bytes) -> SeqDB:
    rng = np.random.default_rng(5)
    codes = rng.integers(0, len(table), size=4000).astype(np.uint8)
    return SeqDB(codes=codes, table=table, entry_starts=np.array([0]),
                 entry_lengths=np.array([4000]), headers=["e1"])


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("wc", [False, True], ids=["dna", "iupac"])
def test_device_tables_match_conv_weights(k, poison, wc):
    if wc:
        db = _db(b"ACGT\nNRYSWKMBDHV")
        ps = build_pattern_set(IUPAC, rev_comp=True)
    else:
        db = _db(b"ACGT\n")
        ps = build_pattern_set(DNA, rev_comp=True)
    t = build_tables(ps, db, wc=wc, textn=True)
    dt = device_tables(t, k, poison, "cpu")
    want = conv_weights(t, k, poison).astype(np.float32)
    assert dt.weights.dtype == torch.float32
    assert dt.weights16.dtype == torch.int16
    assert np.array_equal(dt.weights.numpy(), want)
    assert np.array_equal(dt.weights16.numpy().astype(np.float32), want)
    assert np.array_equal(dt.thresholds.numpy(), t.lengths - k)
    assert np.array_equal(dt.lengths.numpy(), t.lengths)
    if poison:
        assert want.min() == -(t.Lmax + k + 1)


def test_int16_holds_the_longest_poison():
    """Lmax = 128 at k = 0 poisons EOS with -129, past int8."""
    db = _db(b"ACGT\n")
    ps = build_pattern_set(["ACGT" * 32, "GATTACA"], rev_comp=False)
    t = build_tables(ps, db, wc=False, textn=False)
    assert t.Lmax == 128
    dt = device_tables(t, 0, True, "cpu")
    assert int(dt.weights16.min()) == -129
    want = conv_weights(t, 0, True).astype(np.float32)
    assert np.array_equal(dt.weights16.numpy().astype(np.float32), want)
