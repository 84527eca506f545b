"""The census keyed by prefixes on the card (``seed_slots.cu``).

At 2^24 positions of a random protein text and 5,000 peptides of 7 to 45
residues drawn from it, longer than the int64 register holds (14 codes
at 21): the card's prefix census equals its plain twin (the same
scanner on the CPU, ``scan_slots_ref``) and the card's pattern-blocked
route.  The CPU cases, against the JAX package, are
``tests/test_torch_prefix_census.py``; this file imports no JAX, so
that the card's machine runs it (``python -m pytest --noconftest -m cuda
tests/test_torch_prefix_census_cuda.py``).
"""

import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu_torch.io.database import SeqDB
from sequence_alignment_tools_tpu_torch.io.patterns import PatternSet
from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
from sequence_alignment_tools_tpu_torch.utils import trace

AAS = "ACDEFGHIKLMNPQRSTVWY"


def literal_tables(db, pats):
    ps = PatternSet(patterns=[""] + pats, esb=[0] * (len(pats) + 1),
                    eeb=[0] * (len(pats) + 1), n_forward=len(pats))
    return build_tables(ps, db, wc=False, textn=False)


def prefix_scanner(tables, device):
    sc = ConvScanner(tables, k=0, device=device)
    sc.use_host = False
    return sc


@pytest.mark.cuda
def test_cuda_prefix_census():
    """One ``seed_slots.cu`` launch a scan; the hits equal the plain
    twin's and the pattern-blocked route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(47)
    n = 1 << 24
    residues = np.array([0, 1, 2, 3] + list(range(5, 21)), np.uint8)
    codes = residues[rng.integers(0, 20, size=n)]
    codes[rng.integers(0, n, size=n // 361)] = 4  # ends of sequence
    table = b"ACGT\n" + bytes(c for c in AAS.encode() if c not in b"ACGT")
    db = SeqDB(codes=codes, table=table, entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["e"])
    pats = []
    while len(pats) < 5_000:
        L = int(rng.integers(7, 46))
        at = int(rng.integers(0, n - L))
        if (codes[at : at + L] != 4).all():
            pats.append("".join(chr(table[c]) for c in codes[at : at + L]))
    tables = literal_tables(db, pats)
    sc = prefix_scanner(tables, "cuda")
    assert sc._census_key() is not None and sc.census_serves(codes)
    launches = trace.total("launch.scan_slots")
    got = list(sc.scan(codes))
    assert trace.total("launch.scan_slots") - launches == 1
    assert len(got) >= len(pats)
    assert got == list(prefix_scanner(tables, "cpu").scan(codes))
    assert got == list(sc._scan_pblocked(codes))
