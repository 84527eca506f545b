"""The Sellers k-edit scan at patterns of thousands of bases.

Past about 1,760 bases a pattern's DP columns no longer fit one block's
shared memory, and ``csrc/sellers.cu`` keeps them in device scratch.  The
port's ``SellersScanner`` takes such sets on every route; here its plain
version (``sellers_ref`` on the CPU) is held against the JAX scanner's
XLA block DP (``use_host`` not pinned) with and without indels.
Tolerance 0: every quantity is an integer.  The kernel is held against
the plain version on the card in ``tests/test_torch_sellers.py`` (marked
``cuda``) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.ops.sellers import (
    SellersScanner as JaxSellers,
)
from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
from test_torch_sellers import EOS, both_tables, text_db


@pytest.mark.parametrize("indels", [True, False])
def test_long_patterns_match_jax_scanner(indels):
    """Patterns of 2,000 to 5,000 bases (past one block's shared memory,
    so the kernel keeps their columns in device scratch): the port's
    ``SellersScanner.scan`` and ``scan_pairs`` (plain version on the CPU)
    equal the JAX scanner's XLA block DP triple for triple."""
    n = 12_500
    codes, kw = text_db(n, 30, entries=2)
    codes[codes == EOS] = 0
    codes[[100, 11_900]] = EOS
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes)
    rng = np.random.default_rng(30)
    pats = []
    for at, ln, edits in ((200, 2000, 0), (2_400, 3_500, 2),
                          (6_000, 5_000, 3)):
        p = list(text[at : at + ln])
        for _ in range(edits):
            j = int(rng.integers(10, ln - 10))
            p[j] = "ACGT"[("ACGT".index(p[j]) + 1) % 4]
        pats.append("".join(p))
    jt, pt = both_tables(pats, kw, rev_comp=False)
    want = list(JaxSellers(jt, k=2, indels=indels, block=1 << 14).scan(codes))
    sc = SellersScanner(pt, k=2, indels=indels, device="cpu")
    assert list(sc.scan(codes)) == want
    assert pt.Lmax == 5000 and sc.kernel_available(n)
    ends, pids = sc.scan_pairs(codes)
    assert sorted(zip(ends.tolist(), pids.tolist())) == [
        (e, p) for e, p, _d in want]
    # the exact copy and the 2-edit copy hit; 3 edits are past k
    assert {p for _e, p, _d in want} == {0, 1}
