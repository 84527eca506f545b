"""The port's six-frame translation against the JAX package's.

``io/translate.py`` of the port is a copy of the JAX module: on the same
normalized DNA database (made by the port's ``compress_seq``)
both give the same amino-acid codes, codon ids, frame end positions,
coordinate mapping and decoded text, for all six frames and the forward
three, under each amino-acid map; ``apply_charmap`` likewise over a
protein database.
"""

import numpy as np
import pytest

from sequence_alignment_tools_tpu.io import compress as jax_compress
from sequence_alignment_tools_tpu.io import translate as jax_tr
from sequence_alignment_tools_tpu_torch.apps.compress_seq import (
    main as compress,
)
from sequence_alignment_tools_tpu_torch.io import compress as torch_compress
from sequence_alignment_tools_tpu_torch.io import translate as torch_tr
from tests.conftest import make_synthetic_fasta

AAS = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tr")
    dna = str(d / "dna.fasta")
    make_synthetic_fasta(dna, n_entries=3, total=9_001, seed=11,
                         alphabet="ACGTN")
    prot = str(d / "prot.fasta")
    make_synthetic_fasta(prot, n_entries=2, total=3_000, seed=12,
                         alphabet=AAS)
    for path in (dna, prot):
        assert compress(["-i", path, "-n", "true"]) == 0
    return dna, prot


def test_codon_tables_match_jax():
    for got, want in zip(torch_tr._codon_tables(), jax_tr._codon_tables()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert torch_tr.AA_CHMAP == jax_tr.AA_CHMAP


@pytest.mark.parametrize("mapindex", [0, 2, 3])
@pytest.mark.parametrize("all_frames", [True, False], ids=["A", "F"])
def test_translate_db_matches_jax(dbs, all_frames, mapindex):
    dna, _prot = dbs
    want = jax_tr.translate_db(jax_compress.load_db(dna),
                               all_frames=all_frames, mapindex=mapindex)
    got = torch_tr.translate_db(torch_compress.load_db(dna),
                                all_frames=all_frames, mapindex=mapindex)
    assert got.n_frames == want.n_frames == (6 if all_frames else 3)
    assert np.array_equal(got.frame_end_pos, want.frame_end_pos)
    assert got.codon_ids.dtype == want.codon_ids.dtype
    assert np.array_equal(got.codon_ids, want.codon_ids)
    ga, wa = got.aa_db, want.aa_db
    assert ga.table == wa.table and ga.eos_char == wa.eos_char
    assert np.array_equal(ga.codes, wa.codes)
    assert np.array_equal(ga.char_to_code, wa.char_to_code)
    assert ga.decode(0, len(ga.codes)) == wa.decode(0, len(wa.codes))
    total = int(want.frame_end_pos[want.n_frames - 1])
    assert len(ga.codes) == total
    for p in list(range(0, total, 97)) + [total - 1, total + 1]:
        assert got.getbasepos(p) == want.getbasepos(p)
    for start in (0, 17, 3_000, 8_990):
        assert got.base_decode(start, 9) == want.base_decode(start, 9)


@pytest.mark.parametrize("mapindex", [0, 2, 3])
def test_apply_charmap_matches_jax(dbs, mapindex):
    _dna, prot = dbs
    want = jax_tr.apply_charmap(jax_compress.load_db(prot), mapindex)
    got = torch_tr.apply_charmap(torch_compress.load_db(prot), mapindex)
    assert np.array_equal(got.codes, want.codes)
    assert np.array_equal(got.char_to_code, want.char_to_code)
    assert got.decode(0, len(got.codes)) == want.decode(0, len(want.codes))
