"""The port's multi-process bring-up and 2-D node x GPU mesh
(``parallel/multihost.py``), after ``tests/test_multihost_2proc.py``.

Two processes join a gloo process group on a free localhost port
(``SAT_COORDINATOR``), each driving two entries of the CPU device: the
("host", "chip") = (2, 2) mesh.  ``init_distributed`` returns (i, 2) in
each; ``sharded_scan_counts_2d`` equals the JAX test's numpy oracle; and
``sharded_pallas_scan_hits_2d`` yields on both ranks the JAX package's
single-device hit stream, also with the caps forced to 1 and the hits
planted so that only one rank overflows (the ranks agree on the caps
before any re-launch).  Every process and every collective has a
timeout.  This file is also the worker: ``python test_torch_multihost.py
<rank> <port> <outdir>``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

TABLE = b"ACGT\n"
PATS = ["AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG"]
N_POS = 40_003


def count_problem():
    """The JAX test's problem: codes, weights and the numpy oracle."""
    P, Lmax, alpha = 6, 10, 5
    rng = np.random.default_rng(0)
    n = 8 * 512
    codes = rng.integers(0, 4, size=n).astype(np.int32)
    pats = rng.integers(0, 4, size=(P, Lmax))
    weights = np.zeros((Lmax, alpha, P), np.float32)
    for p in range(P):
        for j in range(Lmax):
            weights[j, pats[p, j], p] = 1.0
    want = np.zeros(P, np.int64)
    for p in range(P):
        m = np.ones(n - Lmax + 1, bool)
        for j in range(Lmax):
            m &= codes[j : n - Lmax + 1 + j] == pats[p, j]
        want[p] = int(m.sum())
    return codes, weights, want


def hits_db(seq_db):
    """A planted database: the primers on both strands throughout, and
    100 more copies in the last quarter (the second rank's shards)."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=N_POS).astype(np.uint8)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    for i in range(40):
        p = PATS[i % 3]
        s = p if i % 2 else "".join(comp[c] for c in reversed(p))
        at = 500 + 997 * i
        codes[at : at + len(s)] = [TABLE.index(c.encode()) for c in s]
    for i in range(100):
        at = 30_500 + 90 * i
        codes[at : at + len(PATS[0])] = [TABLE.index(c.encode())
                                         for c in PATS[0]]
    codes[[10_000, 25_000]] = 4
    return seq_db(codes=codes, table=TABLE,
                  entry_starts=np.array([0, 10_001, 25_001]),
                  entry_lengths=np.array([10_000, 14_999, N_POS - 25_001]),
                  headers=["a", "b", "c"])


def worker(rank, port, outdir):
    os.environ.update(SAT_COORDINATOR=f"localhost:{port}",
                      SAT_NUM_PROCESSES="2", SAT_PROCESS_ID=str(rank),
                      SAT_DEVICE="cpu")
    import torch.distributed as dist

    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.io.patterns import (
        build_pattern_set,
    )
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
    from sequence_alignment_tools_tpu_torch.parallel.multihost import (
        init_distributed,
        make_host_chip_mesh,
        shard_codes_2d,
        sharded_pallas_scan_hits_2d,
        sharded_scan_counts_2d,
    )

    got = init_distributed(timeout=60)
    assert init_distributed() == got  # idempotent
    mesh = make_host_chip_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == (2, 2) and mesh.size == 4
    codes, weights, _want = count_problem()
    rows, _ = shard_codes_2d(codes, mesh, weights.shape[0] - 1, 4)
    counts = sharded_scan_counts_2d(rows, weights, np.full(6, 10.0),
                                    np.full(6, 10), 5, mesh)
    db = hits_db(SeqDB)
    tables = build_tables(build_pattern_set(PATS, rev_comp=True), db,
                          wc=False, textn=False)
    sc = ConvScanner(tables, k=1, device="cpu")
    hits = list(sharded_pallas_scan_hits_2d(sc, db.codes, mesh))
    sc1 = ConvScanner(tables, k=1, device="cpu")
    sc1._cap_mb = sc1._hit_cap = 1
    hits1 = list(sharded_pallas_scan_hits_2d(sc1, db.codes, mesh))
    dist.destroy_process_group()
    np.savez(os.path.join(outdir, f"r{rank}.npz"), got=np.array(got),
             counts=counts.numpy(), hits=np.array(hits, np.int64),
             hits1=np.array(hits1, np.int64),
             caps1=np.array([sc1._cap_mb, sc1._hit_cap]))
    print(f"worker {rank} ok", flush=True)


@pytest.fixture
def one_thread():
    """One intra-op thread, as each rank has: beside the other workers
    of a parallel (xdist) run more threads only spin."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_stream():
    from sequence_alignment_tools_tpu.io.database import SeqDB
    from sequence_alignment_tools_tpu.io.patterns import build_pattern_set
    from sequence_alignment_tools_tpu.ops.conv_scan import ConvScanner
    from sequence_alignment_tools_tpu.ops.tables import build_tables

    db = hits_db(SeqDB)
    t = build_tables(build_pattern_set(PATS, rev_comp=True), db, wc=False,
                     textn=False)
    ref = ConvScanner(t, k=1, block=1 << 14, use_pallas=False)
    ref.use_host = False
    return ref.scan(db.codes)


def test_two_process_mesh(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("SAT_COORDINATOR", "MASTER_ADDR", "RANK",
                        "WORLD_SIZE", "SAT_MESH")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # one intra-op thread a rank: beside the other workers of a parallel
    # (xdist) run more threads only spin
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(i), str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
        assert b"ok" in out
    _codes, _w, want_counts = count_problem()
    want = np.array(list(_jax_stream()), np.int64)
    assert len(want) >= 130
    for rank in range(2):
        d = np.load(tmp_path / f"r{rank}.npz")
        assert tuple(d["got"]) == (rank, 2)
        np.testing.assert_array_equal(d["counts"], want_counts)
        np.testing.assert_array_equal(d["hits"], want)
        np.testing.assert_array_equal(d["hits1"], want)
        assert (d["caps1"] > 1).all()


def test_one_process_forms(monkeypatch, one_thread):
    """No coordinator: ``init_distributed`` is a no-op returning (0, 1)
    and creates no process group; the (2, 2) mesh then runs in one
    process and gives the same counts and stream."""
    import torch.distributed as dist

    from sequence_alignment_tools_tpu_torch.io.database import SeqDB
    from sequence_alignment_tools_tpu_torch.io.patterns import (
        build_pattern_set,
    )
    from sequence_alignment_tools_tpu_torch.ops.conv_scan import ConvScanner
    from sequence_alignment_tools_tpu_torch.ops.tables import build_tables
    from sequence_alignment_tools_tpu_torch.parallel.multihost import (
        init_distributed,
        make_host_chip_mesh,
        shard_codes_2d,
        sharded_pallas_scan_hits_2d,
        sharded_scan_counts_2d,
    )

    for name in ("SAT_COORDINATOR", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized()
    mesh = make_host_chip_mesh(n_hosts=2, devices=["cpu"] * 4)
    assert mesh.shape == (2, 2) and mesh.group is None
    codes, weights, want_counts = count_problem()
    rows, _ = shard_codes_2d(codes, mesh, weights.shape[0] - 1, 4)
    np.testing.assert_array_equal(
        sharded_scan_counts_2d(rows, weights, np.full(6, 10.0),
                               np.full(6, 10), 5, mesh).numpy(),
        want_counts)
    db = hits_db(SeqDB)
    tables = build_tables(build_pattern_set(PATS, rev_comp=True), db,
                          wc=False, textn=False)
    sc = ConvScanner(tables, k=1, device="cpu")
    assert list(sharded_pallas_scan_hits_2d(sc, db.codes, mesh)) == \
        list(_jax_stream())


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
