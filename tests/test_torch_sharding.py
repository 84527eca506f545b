"""The port's position-sharded paths (``parallel/shard.py``) against the
JAX package's single-device output and the port's own unsharded routes.

A mesh of N entries of the CPU device (N = 2, 3, 8) carries N shards;
the kernels' plain PyTorch versions scan each.  Each database is made
from a seed with numpy, its length not a multiple of N, and planted at
every shard boundary of its N: a copy of a primer with one substitution
in its LEFT half whose right-half seed starts within Lmax of the shard's
start (only the right-half seed finds it, and its extension gate reads
left across the boundary), the same with the substitution in the right
half (the left-half seed's gate reads right across it), a 2-edit copy
with a deletion ending on the last position of the shard, and exact
copies on both sides; and at position 0 a primer less its first base
(a Sellers candidate at the text's start, which shard 0 must read as
the unsharded scan does).  The JAX sharded functions are not run: in
interpret mode they take 13 to 99 s a test on this image.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from sequence_alignment_tools_tpu.apps import pcr_match as jax_pcr
from sequence_alignment_tools_tpu.apps import primer_match as jax_app
from sequence_alignment_tools_tpu.io.database import SeqDB
from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
from sequence_alignment_tools_tpu.models.primer_match import (
    PrimerMatchModel as JaxModel,
)
from sequence_alignment_tools_tpu.ops.conv_scan import ConvScanner as JaxScanner
from sequence_alignment_tools_tpu.ops.sellers import (
    SellersScanner as JaxSellers,
)
from sequence_alignment_tools_tpu.ops.tables import build_tables
from sequence_alignment_tools_tpu.parallel import shard as jax_shard
from sequence_alignment_tools_tpu.utils.iupac import reverse_comp
from sequence_alignment_tools_tpu_torch.apps import pcr_match as torch_pcr
from sequence_alignment_tools_tpu_torch.apps import (
    primer_match as torch_app,
)
from sequence_alignment_tools_tpu_torch.models.primer_match import (
    PrimerMatchModel,
)
from sequence_alignment_tools_tpu_torch.ops import conv_scan
from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
    ConvScanner,
    device_form,
)
from sequence_alignment_tools_tpu_torch.ops.sellers import SellersScanner
from sequence_alignment_tools_tpu_torch.parallel import devcache, shard

TABLE = b"ACGT\n"
EOS = 4
PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
        "CTATTGATAAGGGAGTGC"]
NS = [2, 3, 8]
N_POS = 24_011  # not a multiple of 2, 3 or 8


def _put(codes, at, s):
    codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]


def _sub(s, j):
    """``s`` with a substitution at j."""
    return s[:j] + "ACGT"[("ACGT".index(s[j]) + 1) % 4] + s[j + 1 :]


def _planted_db(N):
    """(db, boundaries): random ACGT in three entries, planted at every
    shard boundary of an N-entry mesh (see the module docstring)."""
    rng = np.random.default_rng(100 + N)
    codes = rng.integers(0, 4, size=N_POS).astype(np.uint8)
    S = -(-N_POS // N)
    bounds = [i * S for i in range(1, N)]
    for j, b in enumerate(bounds):
        p = PATS[j % len(PATS)]
        h = len(p) // 2
        d = (3 * j) % (len(p) - h)  # the right half starts at b + d
        if j % 2 == 0:  # left-half substitution: only the right seed hits
            _put(codes, b + d - h, _sub(p, h // 2))
        else:  # right-half substitution: only the left seed hits
            _put(codes, b - h + d, _sub(reverse_comp(p), h + 2))
        q = PATS[(j + 1) % len(PATS)]
        # 2 edits (a deletion, a substitution) ending at b - 1 - 40
        var = _sub(q[:4] + q[5:], 9)
        _put(codes, b - 40 - len(var), var)
        _put(codes, b - 120, q)                   # exact, left side
        _put(codes, b + 60, reverse_comp(q))      # exact, right side
    _put(codes, 0, PATS[2][1:])  # Sellers at the text's start
    codes[[10_500, 19_500]] = EOS  # away from every plant
    db = SeqDB(codes=codes, table=TABLE,
               entry_starts=np.array([0, 10_501, 19_501]),
               entry_lengths=np.array([10_500, 8_999, N_POS - 19_501]),
               headers=["e1 one", "e2 two", "e3 three"])
    return db, bounds


@pytest.fixture(scope="module")
def dbs():
    return {N: _planted_db(N) for N in NS}


@pytest.fixture(scope="module")
def tables():
    """The pattern tables of each database (both strands)."""
    cache = {}

    def get(db):
        if id(db) not in cache:
            cache[id(db)] = build_tables(build_pattern_set(PATS, rev_comp=True),
                                         db, wc=False, textn=False)
        return cache[id(db)]

    return get


def _mesh(N):
    return shard.make_mesh(["cpu"] * N)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the shards' many small plain
    PyTorch ops gain nothing from more (11.7 s alone against 13), and
    beside the other workers of a parallel (xdist) run their threads'
    spin waits made the module about 50 times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def launches(monkeypatch):
    """The lengths of the fused scans (``scan_hits`` calls) made."""
    calls = []
    real = conv_scan.scan_hits
    monkeypatch.setattr(conv_scan, "scan_hits",
                        lambda *a: calls.append(a[1]) or real(*a))
    return calls


# -- the layout --------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 999, 24_011, 4096 + 5])
@pytest.mark.parametrize("N", NS)
def test_shard_codes_matches_jax_layout(N, n):
    codes = np.random.default_rng(n).integers(0, 4, size=n).astype(np.uint8)
    halo = 17
    want, want_len = jax_shard.shard_codes(
        codes.astype(np.int32), jax_shard.make_mesh(jax.devices()[:N]), halo,
        EOS)
    uploads = device_form.uploads
    rows, shard_len = shard.shard_codes(codes, _mesh(N), halo, EOS)
    assert device_form.uploads - uploads == N
    assert shard_len == want_len
    np.testing.assert_array_equal(torch.stack(rows).numpy(),
                                  np.asarray(want))
    # a left halo: row i starts ``left`` positions earlier, EOS before 0
    left, _ = shard.shard_codes(codes, _mesh(N), 0, EOS, left=halo)
    padded = np.concatenate([np.full(halo, EOS, np.uint8), codes,
                             np.full(N * shard_len, EOS, np.uint8)])
    for i, row in enumerate(left):
        np.testing.assert_array_equal(
            row.numpy(), padded[i * shard_len : i * shard_len + len(row)])


def test_resident_layout_uploads_once(dbs, tables):
    """A resident database is sharded and uploaded once per shard,
    whatever the number of scans and streamed runs; a new array is
    uploaded anew."""
    db, _ = dbs[3]
    sc = ConvScanner(tables(db), k=0, device="cpu")
    sc.mesh = _mesh(3)
    uploads = device_form.uploads
    first = list(sc.scan(db.codes))
    runs = [h for _i, h in sc.scan_stream(db.codes for _ in range(3))]
    assert runs == [first] * 3 and first == list(sc.scan(db.codes))
    assert device_form.uploads - uploads == 3
    list(sc.scan(db.codes.copy()))
    assert device_form.uploads - uploads == 6


@pytest.mark.parametrize("N", NS)
def test_plain_counts_and_hits(dbs, tables, N):
    """``sharded_scan_counts`` / ``sharded_scan_hits`` (the JAX one-hot
    products as plain gathers) over the JAX layout with halo Lmax - 1:
    the hit set and per-pattern counts of the JAX single-device scan, in
    position order."""
    from sequence_alignment_tools_tpu_torch.ops.tables import (
        conv_weights_f32,
    )

    db, _ = dbs[N]
    t = tables(db)
    want = [(e - int(t.lengths[p]), p) for e, p, _m in _jax_scan(t, 0,
                                                                 db.codes)]
    mesh = _mesh(N)
    rows, _ = shard.shard_codes(db.codes, mesh, t.Lmax - 1, EOS)
    w = conv_weights_f32(t, 0, False)
    thr = t.lengths.astype(np.float32)
    counts = shard.sharded_scan_counts(rows, w, thr, t.lengths, t.alpha,
                                       mesh)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount([p for _s, p in want], minlength=t.P))
    n_hit, starts, pids = shard.sharded_scan_hits(rows, w, thr, t.lengths,
                                                  t.alpha, mesh, cap=64)
    got = [(int(a), int(b)) for a, b in zip(starts.reshape(-1).tolist(),
                                            pids.reshape(-1).tolist())
           if a >= 0]
    assert got == want and int(n_hit.sum()) == len(want)


# -- the fused route, the stream ------------------------------------------------


def _jax_scan(t, k, codes):
    ref = JaxScanner(t, k=k, block=1 << 14, use_pallas=False)
    ref.use_host = False  # the XLA block path
    return list(ref.scan(codes))


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("N", NS)
def test_sharded_fused_scan(dbs, tables, N, k, launches):
    db, bounds = dbs[N]
    t = tables(db)
    want = _jax_scan(t, k, db.codes)
    plain = ConvScanner(t, k=k, device="cpu")
    plain.use_host = False
    assert list(plain.scan(db.codes)) == want
    launches.clear()
    sc = ConvScanner(t, k=k, device="cpu")
    sc.mesh = _mesh(N)
    got = list(sc.scan(db.codes))
    assert got == want
    assert len(launches) == N  # one fused scan a shard, no host rung
    # the plants at the boundaries are among them
    starts = {e - int(t.lengths[p]) for e, p, _m in got}
    assert sum(b - 120 in starts for b in bounds) == len(bounds)
    got2 = list(shard.sharded_pallas_scan_hits(sc, db.codes, sc.mesh))
    assert got2 == want


@pytest.mark.parametrize("N", NS)
def test_sharded_scan_stream(dbs, tables, N):
    db, _ = dbs[N]
    t = tables(db)
    blocks = [db.codes[:10_007], db.codes[10_007:], db.codes[:5],
              db.codes[:0], db.codes[3:]]
    want = [_jax_scan(t, 0, b) if len(b) else [] for b in blocks]
    plain = ConvScanner(t, k=0, device="cpu")
    plain.use_host = False
    assert [h for _i, h in plain.scan_stream(iter(blocks))] == want
    sc = ConvScanner(t, k=0, device="cpu")
    sc.mesh = _mesh(N)
    got = list(shard.sharded_scan_stream(sc, iter(blocks), sc.mesh, depth=2))
    assert got == list(enumerate(want))
    assert list(sc.scan_stream(iter(blocks))) == list(enumerate(want))


def test_stream_whole_rung_shards_each_block(dbs, tables, monkeypatch):
    """An array past the residency bound streams in halo'd blocks, each
    block sharded over the mesh."""
    db, _ = dbs[3]
    t = tables(db)
    sc = ConvScanner(t, k=1, device="cpu")
    sc.mesh = _mesh(3)
    monkeypatch.setattr(sc, "_RESIDENT_MAX", 5_000)
    monkeypatch.setattr(sc, "_STREAM_BLOCK", 4_096)
    assert list(sc.scan(db.codes)) == _jax_scan(t, 1, db.codes)


# -- Sellers ------------------------------------------------------------------


@pytest.mark.parametrize("k,indels", [(2, True), (2, False), (1, True)])
@pytest.mark.parametrize("N", NS)
def test_sharded_sellers_scan(dbs, tables, N, k, indels):
    db, bounds = dbs[N]
    t = tables(db)
    want = list(JaxSellers(t, k=k, indels=indels, block=1 << 14)
                .scan(db.codes))
    plain = SellersScanner(t, k=k, indels=indels, device="cpu")
    plain.use_host = False
    assert list(plain.scan(db.codes)) == want
    sc = SellersScanner(t, k=k, indels=indels, device="cpu")
    sc.mesh = _mesh(N)
    got = list(sc.scan(db.codes))
    assert got == want
    ends = {e for e, _p, _d in got}
    if indels and k == 2:
        # the 2-edit copies ending 40 before each boundary, and the
        # deletion at the text's start (shard 0 starts the text)
        assert all(any(b - 43 <= e <= b - 39 for e in ends) for b in bounds)
        assert len(PATS[2]) - 1 in ends


# -- the gated route (k = 1 halves), through the model ------------------------


def _engine_runs(db, N, k, indels, node=0, monkeypatch=None):
    ps = build_pattern_set(PATS, rev_comp=True)
    want = list(JaxModel(db, ps, k=k, indels=indels, node=node,
                         mesh=None).engine_hits())
    plain = PrimerMatchModel(db, ps, k=k, indels=indels, node=node,
                             device="cpu", mesh=None)
    plain.use_host = False
    assert list(plain.engine_hits()) == want
    m = PrimerMatchModel(db, ps, k=k, indels=indels, node=node,
                         device="cpu", mesh=_mesh(N))
    return m, want


@pytest.mark.parametrize("indels", [True, False])
@pytest.mark.parametrize("N", NS)
def test_sharded_gated_halves(dbs, N, indels, monkeypatch):
    db, bounds = dbs[N]
    calls = []
    real = shard.sharded_gated_stream
    monkeypatch.setattr(shard, "sharded_gated_stream",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    m, want = _engine_runs(db, N, 1, indels)
    assert m.engine == "halves"
    assert list(m.engine_hits()) == want
    assert list(m.engine_hits_stream(2)) == [want] * 2
    assert len(calls) == 2
    # every boundary plant is a hit (one substitution each)
    ends = {e for e, _p, _v in want}
    for j, b in enumerate(bounds):
        p = PATS[j % len(PATS)]
        h = len(p) // 2
        d = (3 * j) % (len(p) - h)
        end = b + d - h + len(p) if j % 2 == 0 else b - h + d + len(p)
        assert end in ends, (b, j)


def test_gated_seeds_straddle_the_left_halo(dbs, tables):
    """The right-half seeds of the left-half-substitution plants: the
    sharded gated scan keeps each (its gate reads across the boundary)
    and equals the unsharded one."""
    N = 8
    db, bounds = dbs[N]
    m, _want = _engine_runs(db, N, 1, True)
    _o, sc, _b, dirs, ext, geomB = m._halves_ctx()
    gate = m._engine_gate(sc, dirs, ext, geomB, lambda p0: p0 + 1)
    left, _right = shard.gated_halos(sc, gate)
    anchors, sids = sc.scan_gated(db.codes, gate, True, 1)
    plain = ConvScanner(sc.tables, k=0, device="cpu")
    plain.use_host = False
    pa, ps_ = plain.scan_gated(db.codes, gate, True, 1)
    assert sorted(zip(anchors.tolist(), sids.tolist())) == \
        sorted(zip(pa.tolist(), ps_.tolist()))
    got = set(anchors.tolist())
    for j, b in enumerate(bounds[::2]):
        p = PATS[(2 * j) % len(PATS)]
        h = len(p) // 2
        d = (6 * j) % (len(p) - h)
        assert 0 <= d < left
        assert b + d + len(p) - h in got  # the right-half seed's end
    b_anchor, b_sids = shard.sharded_gated_slots(sc, gate, True, 1,
                                                 db.codes, sc.mesh)
    assert sorted(zip(b_anchor.tolist(), b_sids.tolist())) == \
        sorted(zip(pa.tolist(), ps_.tolist()))


def test_sharded_filter_engine_and_hash(dbs):
    """k = 2 with indels takes Sellers per shard under a mesh (not the
    Myers pairs route), -K 2 the sharded poisoned scan; both equal the
    JAX model's hits (its host routes), and so does the hash engine's seed
    scan."""
    db, _ = dbs[3]
    for k, indels, node in ((2, True, 0), (2, False, 0), (1, False, 6)):
        m, want = _engine_runs(db, 3, k, indels, node)
        assert list(m.engine_hits()) == want
        assert list(m.engine_hits_stream(2)) == [want] * 2
        m.close()


# -- past 2,048 patterns: unsharded on the mesh's first device ----------------


def test_many_seeds_run_unsharded(monkeypatch):
    """2,100 primers (4,200 half seeds) at k = 1 and their exact scan over
    2^18 + 3 positions: the census (and at k = 1 the slot gate) runs
    unsharded on the mesh's first device, equal to the JAX model."""
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    rng = np.random.default_rng(5)
    n = (1 << 18) + 3
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    text = "".join("ACGT"[c] for c in codes)
    pats = [text[i : i + 16] for i in range(0, 2_100 * 2, 2)]
    pats = [_sub(p, 3) if i % 3 == 0 else p for i, p in enumerate(pats)]
    db = SeqDB(codes=codes, table=TABLE, entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    ps = build_pattern_set(pats, rev_comp=False)
    for k in (0, 1):
        want = list(JaxModel(db, ps, k=k, mesh=None).engine_hits())
        m = PrimerMatchModel(db, ps, k=k, device="cpu", mesh=_mesh(3))
        m.use_host = False
        assert list(m.engine_hits()) == want
        assert list(m.engine_hits_stream(2)) == [want] * 2


# -- overflow: the caps start at 1 ----------------------------------------------


def test_cap_one_overflow(dbs, tables):
    db, _ = dbs[3]
    t = tables(db)
    mesh = _mesh(3)
    want = _jax_scan(t, 1, db.codes)
    sc = ConvScanner(t, k=1, device="cpu")
    sc.mesh = mesh
    sc._cap_mb = sc._hit_cap = 1
    assert list(sc.scan_stream([db.codes])) == [(0, want)]
    sc._cap_mb = sc._hit_cap = 1
    assert list(sc.scan(db.codes)) == want
    assert sc._hit_cap > 1
    sel = SellersScanner(t, k=2, indels=True, device="cpu")
    sel.mesh = mesh
    sel._sel_cap = 1
    assert list(sel.scan(db.codes)) == list(
        JaxSellers(t, k=2, indels=True, block=1 << 14).scan(db.codes))
    ps = build_pattern_set(PATS, rev_comp=True)
    m = PrimerMatchModel(db, ps, k=1, device="cpu", mesh=mesh)
    _o, hsc, *_rest = m._halves_ctx()
    hsc._gsurv_cap = 1
    assert list(m.engine_hits()) == list(
        JaxModel(db, ps, k=1, mesh=None).engine_hits())
    assert hsc._gsurv_cap > 1


# -- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    from tests.conftest import make_synthetic_fasta

    d = tmp_path_factory.mktemp("sharded_cli")
    planted = [(1000 + 2500 * i, p) for i, p in enumerate(PATS)]
    planted += [(15000 + 2500 * i, reverse_comp(p))
                for i, p in enumerate(PATS)]
    planted += [(27000 + 900 * i, _sub(p, 3)) for i, p in enumerate(PATS)]
    planted += [(31000 + 900 * i, p[:5] + p[6:]) for i, p in enumerate(PATS)]
    fasta = str(d / "db.fasta")
    make_synthetic_fasta(fasta, n_entries=3, total=35_000, planted=planted,
                         seed=33)
    words = d / "pats.txt"
    words.write_text("\n".join(PATS) + "\n")
    return fasta, str(words)


@pytest.mark.parametrize("tool,flags", [
    ("primer_match", ["-r"]), ("primer_match", ["-k", "1", "-r"]),
    ("primer_match", ["-k", "2", "-r"]), ("pcr_match", ["-r", "-k", "1"])],
    ids=["exact", "k1", "k2", "pcr-k1"])
def test_cli_bytes_under_sat_mesh(cli_inputs, tool, flags, capsys,
                                  monkeypatch):
    fasta, words = cli_inputs
    monkeypatch.setenv("SAT_HOST_SCAN", "0")
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    calls = []
    real = shard.shard_codes
    monkeypatch.setattr(shard, "shard_codes",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    if tool == "pcr_match":
        argv = ["-i", fasta, "-p",
                f"{PATS[0]} {reverse_comp(PATS[1])}", "-M", "30000"] + flags
        monkeypatch.setenv("SAT_MESH", "0")
        want = _pcr_out(jax_pcr, argv)
        monkeypatch.setenv("SAT_MESH", "4")
        got = _pcr_out(torch_pcr, argv)
    else:
        argv = ["-i", fasta, "-P", words] + flags
        monkeypatch.setenv("SAT_MESH", "0")
        capsys.readouterr()
        assert jax_app.main(argv) == 0
        want = capsys.readouterr().out
        monkeypatch.setenv("SAT_MESH", "4")
        assert torch_app.main(argv) == 0
        got = capsys.readouterr().out
    assert want.count("\n") >= 2
    assert got == want
    assert calls  # the run was sharded


def _pcr_out(app, argv):
    import io

    out = io.StringIO()
    app.run(app.parse_args(argv), out)
    return out.getvalue()


# -- auto_mesh and the device-count cache ---------------------------------------


def test_auto_mesh_env_semantics(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    monkeypatch.setenv("SAT_DEVICE", "cpu")
    for spec in ("0", "1", "off", "none", " OFF "):
        monkeypatch.setenv("SAT_MESH", spec)
        assert shard.auto_mesh() is None and devcache.peek_no_mesh()
    monkeypatch.setenv("SAT_MESH", "4")
    mesh = shard.auto_mesh()
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.size == 4
    assert not devcache.peek_no_mesh()
    monkeypatch.delenv("SAT_MESH")
    assert shard.auto_mesh() is None  # auto: never on the CPU

    # the GPU platform, counted by a stand-in for the CUDA device count
    monkeypatch.setenv("SAT_DEVICE", "cuda")
    probes = []
    count = [3]
    monkeypatch.setattr(torch.cuda, "device_count",
                        lambda: probes.append(1) or count[0])
    monkeypatch.setenv("SAT_MESH", "2")
    assert shard.auto_mesh().devices == (torch.device("cuda", 0),
                                         torch.device("cuda", 1))
    monkeypatch.setenv("SAT_MESH", "4")
    with pytest.raises(SystemExit, match="SAT_MESH=4 but only 3 devices"):
        shard.auto_mesh()
    monkeypatch.setenv("SAT_MESH", "auto")
    path = devcache.devcount_cache_path()
    assert path.startswith(str(tmp_path)) and "cuda" in path
    assert not os.path.exists(path) and not devcache.peek_no_mesh()
    assert shard.auto_mesh().size == 3 and open(path).read() == "3"
    count[0] = 1
    assert shard.auto_mesh() is None  # a fresh count of 3 is re-probed
    assert open(path).read() == "1" and devcache.peek_no_mesh()
    probes.clear()
    assert shard.auto_mesh() is None and not probes  # fresh 1: no probe
    old = time.time() - devcache.STALE_S - 5
    os.utime(path, (old, old))
    assert not devcache.peek_no_mesh()  # stale: auto_mesh probes again
    count[0] = 2
    assert shard.auto_mesh().size == 2 and probes
    # the model: the cached answer first, and an explicit CPU device
    # keeps GPU meshes away
    monkeypatch.setenv("SAT_MESH", "0")
    db, _ = _planted_db(2)
    ps = build_pattern_set(PATS, rev_comp=True)
    assert PrimerMatchModel(db, ps, device="cpu").mesh is None
    monkeypatch.setenv("SAT_MESH", "auto")
    assert PrimerMatchModel(db, ps, device="cpu").mesh is None
    monkeypatch.setenv("SAT_MESH", "3")
    m = PrimerMatchModel(db, ps, device="cpu")
    assert m.mesh.size == 3 and m.device == torch.device("cpu")
