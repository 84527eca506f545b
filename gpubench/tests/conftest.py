"""The harness's CPU tests: tiny sizes, the program on the CPU.

Each cell of ``BENCHMARK.json`` has a file of its tiny size,
``tiny/<cell>.json``: ``config`` and ``traffic`` hold the keys that
replace the configuration's and the traffic's for a CPU test run, and an
optional ``on_card`` the same two for a test on the card, at a size that
reaches the kernels.  A new cell adds its file and edits no test."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DIR = Path(__file__).resolve().parent / "tiny"


def _tiny_files() -> dict[str, dict]:
    return {p.stem: json.loads(p.read_text())
            for p in sorted(TINY_DIR.glob("*.json"))}


TINY_FILES = _tiny_files()
# {cell: (configuration keys, traffic keys)} at the tiny size
TINY = {w: (t["config"], t["traffic"]) for w, t in TINY_FILES.items()}
# the same on the card, where a file gives it (else the tiny size)
ON_CARD = {w: (t["on_card"]["config"], t["on_card"]["traffic"])
           if "on_card" in t else TINY[w] for w, t in TINY_FILES.items()}


@pytest.fixture
def cuda_device():
    """Skips where there is no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture
def four_cards(cuda_device):
    """Skips where there are fewer than four cards."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    return cuda_device
