"""The port's allvall under ``-k`` (the Sellers row DP) against the JAX
package's: ``-k 1 -r`` over the two-chunk query of
``tests/test_torch_allvall.py`` (4,096 patterns in the first chunk), and
``-k 1 -X -P`` with the chunk offset protocol (``-C`` and a ``.N``
background name), bitmap bytes of the port (host rung and plain device
route) against the JAX app's, the JAX output computed once.
"""

import os
import shutil

import pytest

from test_torch_allvall import av_files, parity  # noqa: F401 (fixture)


@pytest.mark.parametrize("host_scan", ["1", "0"])
def test_allvall_kedit_two_chunks(av_files, host_scan,  # noqa: F811
                                  monkeypatch):
    want, got = parity(av_files, ["-r", "-k", "1"], monkeypatch, host_scan)
    assert got == want
    from sequence_alignment_tools_tpu_torch.apps.allvall import read_bitmap

    bits, _s, _p = read_bitmap(os.path.join(av_files["dir"], "t.bm"))
    assert bits[121:142].all() and bits[1021:1042].all()
    assert bits[2081:2102].all()
    assert not bits[300:420].any()


@pytest.mark.parametrize("host_scan", ["1", "0"])
def test_allvall_kedit_chunk_offsets(av_files, host_scan,  # noqa: F811
                                     monkeypatch):
    """A background named ``.1`` with ``-C 500`` shifts its hit
    coordinates by 500; ``-X`` drops exact same-position hits, ``-P``
    keeps hits at the query mer's own offset."""
    part = av_files["b"] + ".1"
    if not os.path.exists(part):
        shutil.copyfile(av_files["b"], part)
    av_files = dict(av_files, part=part)
    want, got = parity(av_files, ["-k", "1", "-X", "-P", "-C", "500"],
                       monkeypatch, host_scan, query="sq", bg="part")
    assert got == want
