"""The harness's CPU tests: tiny sizes, the program on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny versions of the two cells: every rule as benchmarked, the scale
# cut to what a test run holds.  The primers are 5.5 bases shorter, so
# that 2^17 random positions hold as many sites within one edit of a
# primer as 2^28 hold of one 5.5 bases longer (4^5.5 = 2^11).
TINY = {
    "primer_chr1.k1_panel": (
        {"positions": 1 << 17, "entry_length": 20_000},
        {"pattern_length": [12, 21], "checked_queries": 4}),
    "peptide_sprot.map": (
        {"entries": 600, "residues": 600 * 361},
        {"patterns_per_query": [20, 40], "size_steps": 5,
         "checked_queries": 3}),
}


@pytest.fixture
def cuda_device():
    """Skips where there is no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
