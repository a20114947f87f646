"""fenix_tpu_torch across a real process boundary, on the CPU: the port's
counterpart of ``tests/multihost_worker.py`` and ``tests/test_multihost.py``.

Run as a script, this file is one worker of a two-process mesh:

    python tests/test_torch_multihost.py <host:port> <process_id> <out_dir> [timeout_s]

Each worker brings 4 ``cpu`` shards to ``distributed.initialize`` (gloo,
torch capped at 2 threads), uploads only its own row range, and runs the
seven legs of the JAX worker at its sizes (N=4096, D=32, Q=4, k=10, the
ring at Q=16, 8·64 attribute rows): the row-sharded search and its merge,
``train_sharded``, the shuffle (and the id shuffle's retry in step), the
partitioned join's partial tables, the ring, the chunked streaming scan
and the dim-sharded search on a (4, 2) mesh. It writes its results to
``<out_dir>/proc<id>.npz``. The workers import no JAX.

The tests start the pair once per module and hold, per leg, (i) both
processes bitwise equal, (ii) both bitwise equal to the port's
single-process 8-shard ``cpu`` mesh running the same function, and (iii)
both against the JAX package's single-process 8-device mesh: ids exact,
l2 distances within 4e-4·‖q‖ (the JAX l2 is the expanded form), other
distances within 1e-5 · max(1, d), codebooks within 3.3e-7 of their
largest entry, the join's groups equal and its float sums within 1e-4,
the shuffle's outputs bitwise. A ring or shuffle process holds its own
blocks; concatenated in process order they are the single process's.
JAX is imported inside the reference fixture only, so that the worker
runs without it.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fenix_tpu_torch.engine import analytics
from fenix_tpu_torch.ops import kmeans, topk2
from fenix_tpu_torch.parallel import distributed
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.parallel import shuffle as pshuffle
from fenix_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCS, LOCAL = 2, 4  # processes, cpu shards a process
S = PROCS * LOCAL
N, D, Q, K = 4096, 32, 4, 10
Q_RING = 2 * S
A, G = S * 64, 8  # attribute rows, groups
HOT = 0.3  # the id shuffle's share of rows on one key: its estimate overflows
TRAIN = dict(num_codebooks=2, codebook_size=4, batch_size=256, num_epochs=2, metric="l2")
DIM_METRICS = ("l2", "cosine", "dot")
WORKER_TIMEOUT_S = 120


def inputs() -> dict:
    """The JAX worker's inputs, drawn in its order from the same seeds."""
    rng = np.random.default_rng(0)
    out = {"corpus": rng.standard_normal((N, D)).astype(np.float32),
           "queries": rng.standard_normal((Q, D)).astype(np.float32),
           "keys": rng.integers(0, 1 << 20, N).astype(np.int32),
           "akeys": rng.integers(0, 512, A).astype(np.int32),
           "left_keys": rng.integers(0, 600, 64).astype(np.int32),
           "left_vals": rng.standard_normal(64).astype(np.float32)}
    out["ring_queries"] = np.random.default_rng(42).standard_normal((Q_RING, D)).astype(np.float32)
    hot = out["keys"].astype(np.int64)
    hot[: int(HOT * N)] = 7
    out["hot_keys"] = hot
    return out


def own_rows(mesh, n: int) -> tuple[int, int]:
    """This process's contiguous row range of an ``n``-row array."""
    per = n // mesh.size
    return mesh.local_shards[0] * per, (mesh.local_shards[-1] + 1) * per


def put_own(mesh, host: np.ndarray, fill=0) -> psearch.Sharded:
    """``host`` row-sharded, this process uploading its own rows only."""
    lo, hi = own_rows(mesh, host.shape[0])
    return psearch.put_rows(mesh, host[lo:hi], host.shape[0], fill, start=lo)


def legs(mesh) -> dict:
    """The seven legs on ``mesh``; every array it returns is replicated
    (the same on every process) but the ring's, which holds this process's
    query blocks from row ``ring_q_start``."""
    x = inputs()
    corpus, queries = x["corpus"], torch.from_numpy(x["queries"])
    out = {}

    # 1. the row-sharded exact search, merged over the boundary
    corpus_dev = put_own(mesh, corpus)
    mask_dev = put_own(mesh, np.ones(N, bool), False)
    dist, ids = psearch.build_sharded_search(mesh, K, "l2")(corpus_dev, queries, mask_dev)
    out["dist"], out["ids"] = dist.numpy(), ids.numpy()

    # 2. train_sharded
    out["codebooks"] = kmeans.train_sharded(mesh, corpus_dev, N, 0, **TRAIN).numpy()

    # 3. the shuffle, at one chunk and four; then the id shuffle's retry
    keys_dev = put_own(mesh, x["keys"])
    capacity = pshuffle.estimate_capacity(x["keys"], S, N // S, safety=2.0)
    for chunks in (1, 4):
        cap = -(-capacity // chunks) * chunks
        got = pshuffle.build_shuffle(mesh, cap, (D,), chunks=chunks)(corpus_dev, keys_dev)
        for name, arr in zip(("recv", "recv_keys", "valid", "overflow"), got):
            out[f"shuffle{chunks}_{name}"] = arr.gather().numpy()
    for s, ids_s in enumerate(distributed._device_shuffle_ids(mesh, x["hot_keys"], S)):
        if ids_s is not None:
            out[f"hot_ids_{s}"] = ids_s

    # 4. the partitioned join's partial tables, merged on every process
    perm = np.argsort(x["akeys"], kind="stable").astype(np.int32)
    sk, grp = x["akeys"][perm], (x["akeys"] % 5).astype(np.int32)[perm]
    bounds = np.full(S, np.iinfo(np.int32).min, np.int32)
    bounds[1:] = sk[np.arange(1, S) * (A // S) - 1]
    entries = (put_own(mesh, sk), put_own(mesh, perm), bounds, A, put_own(mesh, grp), None)
    left = torch.from_numpy(x["left_keys"])
    for agg, values, int_values in (("sum", torch.from_numpy(x["left_vals"]), False),
                                    ("count", torch.ones(left.shape[0], dtype=torch.int32), True)):
        parts = analytics._parted_partials(mesh, entries, left, None, values, agg=agg, max_groups=G,
                                           int_values=int_values)
        tbl = analytics._merge_parted_tables(parts, G, agg, int_values)
        out[f"join_{agg}_gk"] = tbl.column(analytics.GROUP_COL).to_numpy()
        out[f"join_{agg}_gv"] = tbl.column(analytics.AGG_COL).to_numpy()

    # 5. the ring: each process keeps the blocks that end on its shards
    mul, add = psearch.shard_aux(corpus_dev, mask_dev, "l2")
    ring_d, ring_i = psearch.build_ring_search(mesh, K, "l2")(corpus_dev, torch.from_numpy(x["ring_queries"]),
                                                                mul, add)
    out["ring_dist"], out["ring_ids"] = ring_d.numpy(), ring_i.numpy()
    out["ring_q_start"] = np.int64(mesh.local_shards[0] * (Q_RING // S))

    # 6. the streaming scan: 4 chunks, each row-sharded, merged by (distance, id)
    chunk = N // 4
    serving = psearch.build_serving_search(mesh, K, "l2")
    st_d, st_i = [], []
    for start in range(0, N, chunk):
        c_dev = put_own(mesh, corpus[start : start + chunk])
        c_mul, c_add = psearch.shard_aux(c_dev, put_own(mesh, np.ones(chunk, bool), False), "l2")
        d, i = serving(c_dev, queries, c_mul, c_add)
        st_d.append(d)
        st_i.append(torch.where(i >= 0, i + start, -1))
    stream_d, stream_i = psearch.topk_dist_id(torch.cat(st_d, dim=1), torch.cat(st_i, dim=1), K)
    out["stream_dist"], out["stream_ids"] = stream_d.numpy(), stream_i.numpy()

    # 7. the dim-sharded search on a (4, 2) mesh: partial sums in a process, merge across
    dmesh = mesh.reshape(2)
    corpus_dim, _ = psearch.shard_corpus_dim(dmesh, corpus)
    q_sq = torch.from_numpy((x["queries"].astype(np.float64) ** 2).sum(1).astype(np.float32))
    for metric in DIM_METRICS:
        d_mul, d_add = topk2.prepare_aux(torch.from_numpy(corpus), torch.ones(N, dtype=torch.bool), metric)
        d, i = psearch.build_dim_sharded_search(dmesh, K, metric)(
            corpus_dim, topk2.prepare_queries(queries, metric), corpus_dim.data_rows(d_mul),
            corpus_dim.data_rows(d_add), q_sq)
        out[f"dim_{metric}_dist"], out[f"dim_{metric}_ids"] = d.numpy(), i.numpy()
    return out


def worker(coordinator: str, pid: int, out_dir: str, timeout: float = 60.0) -> None:
    config = distributed.ClusterConfig(coordinator_address=coordinator, num_processes=PROCS, process_id=pid)
    mesh = distributed.initialize(config, devices=["cpu"] * LOCAL, timeout=timeout)
    assert (mesh.process_count, mesh.size, mesh.backend) == (PROCS, S, "gloo"), mesh
    assert mesh.local_shards == list(range(pid * LOCAL, (pid + 1) * LOCAL))
    out = legs(mesh)
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"proc{pid}.npz"), **out)
    print(f"worker {pid}: OK", flush=True)


# -- the tests ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(port: int, pid: int, out: str, *extra: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), f"127.0.0.1:{port}", str(pid), out, *extra],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The two workers' results, ``[proc0, proc1]``."""
    out = str(tmp_path_factory.mktemp("multihost"))
    port = _free_port()
    workers = [_start(port, pid, out) for pid in range(PROCS)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in workers]
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(workers, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log}"
    return [dict(np.load(os.path.join(out, f"proc{pid}.npz"))) for pid in range(PROCS)]


@pytest.fixture(scope="module")
def single():
    """The same legs on the port's single-process 8-shard ``cpu`` mesh."""
    return legs(make_mesh(devices=["cpu"] * S))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's answers on its single-process 8-device mesh, as
    ``tests/test_multihost.py`` and the JAX worker compute them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from fenix_tpu.engine import analytics as jana
    from fenix_tpu.ops import kmeans as jkmeans
    from fenix_tpu.ops import topk2 as jtopk2
    from fenix_tpu.parallel import distributed as jdistributed
    from fenix_tpu.parallel import mesh as jmesh
    from fenix_tpu.parallel import search as jsearch
    from fenix_tpu.parallel import shuffle as jshuffle

    x = inputs()
    corpus, queries = x["corpus"], x["queries"]
    jm = jmesh.make_mesh(devices=jax.devices()[:S])
    out = {}
    corpus_dev, mask_dev = jsearch.shard_corpus(jm, corpus, block=64)
    dist, ids = jsearch.build_sharded_search(jm, k=K, metric="l2")(corpus_dev, jnp.asarray(queries), mask_dev)
    out["dist"], out["ids"] = np.asarray(dist), np.asarray(ids)
    out["codebooks"] = np.asarray(jkmeans.train_sharded(jm, corpus_dev, N, 0, **TRAIN))

    keys_dev = jax.device_put(x["keys"], jmesh.row_sharding(jm, 1))
    capacity = jshuffle.estimate_capacity(x["keys"], S, N // S, safety=2.0)
    for chunks in (1, 4):
        cap = -(-capacity // chunks) * chunks
        got = jshuffle.build_shuffle(jm, cap, (D,), chunks=chunks)(corpus_dev, keys_dev)
        for name, arr in zip(("recv", "recv_keys", "valid", "overflow"), got):
            out[f"shuffle{chunks}_{name}"] = np.asarray(arr)
    for s, ids_s in enumerate(jdistributed._device_shuffle_ids(jm, x["hot_keys"], S)):
        out[f"hot_ids_{s}"] = np.asarray(ids_s)

    perm = np.argsort(x["akeys"], kind="stable").astype(np.int32)
    sk, grp = x["akeys"][perm], (x["akeys"] % 5).astype(np.int32)[perm]
    bounds = np.full(S, np.iinfo(np.int32).min, np.int32)
    bounds[1:] = sk[np.arange(1, S) * (A // S) - 1]
    axes = (jmesh.DATA_AXIS, jmesh.MODEL_AXIS)
    rs1 = jmesh.row_sharding(jm, 1)
    placed = [jax.device_put(a, rs1) for a in (sk, perm, bounds, grp)]
    for agg, values, int_values in (("sum", x["left_vals"], False),
                                    ("count", np.ones(x["left_keys"].shape[0], np.int32), True)):
        def parted(lk, lv, pk_l, pi_l, bound_l, group_l, agg=agg, int_values=int_values):
            hit, pos = jana._local_join_claim(lk, jnp.ones(lk.shape, bool), pk_l, pi_l, bound_l, jnp.int32(A),
                                              jana._is_first_shard())
            groups = jnp.take(group_l, jnp.where(hit, pos, 0)).astype(jnp.int32)
            packed = jana._pack_groups_parted(groups, lv, hit, agg, G, int_values)
            return jax.lax.all_gather(packed, axes, axis=0, tiled=True)

        fn = jax.jit(jax.shard_map(parted, mesh=jm, in_specs=(P(), P(), P(axes), P(axes), P(axes), P(axes)),
                                   out_specs=P(), check_vma=False))
        packed = np.asarray(fn(jnp.asarray(x["left_keys"]), jnp.asarray(values), *placed))
        tbl = jana._merge_parted_tables(packed, S, G, agg, int_values)
        out[f"join_{agg}_gk"] = np.asarray(tbl.column(jana.GROUP_COL))
        out[f"join_{agg}_gv"] = np.asarray(tbl.column(jana.AGG_COL))

    aux_mul, aux_add = jsearch.shard_aux(corpus_dev, mask_dev, "l2")
    q_sharded = jax.device_put(x["ring_queries"], jmesh.row_sharding(jm, 2))
    ring = jtopk2.unpack_result(np.asarray(jsearch.build_ring_search(jm, k=K, metric="l2")(
        corpus_dev, q_sharded, aux_mul, aux_add)))
    out["ring_dist"], out["ring_ids"] = np.asarray(ring[0]), np.asarray(ring[1])

    chunk = N // 4
    serving = jsearch.build_serving_search(jm, k=K, metric="l2")
    st_d, st_i = [], []
    for start in range(0, N, chunk):
        c_dev, m_dev = jsearch.shard_corpus(jm, corpus[start : start + chunk], block=64)
        am, aa = jsearch.shard_aux(c_dev, m_dev, "l2")
        d_l, i_l = jtopk2.unpack_result(np.asarray(serving(c_dev, jnp.asarray(queries), am, aa)))
        st_d.append(np.asarray(d_l))
        st_i.append(np.where(np.asarray(i_l) >= 0, np.asarray(i_l) + start, -1))
    d_all, i_all = np.concatenate(st_d, axis=1), np.concatenate(st_i, axis=1)
    d_all = np.where(i_all >= 0, d_all, np.inf)
    order = np.stack([np.lexsort((i_all[q], d_all[q]))[:K] for q in range(Q)])
    out["stream_dist"] = np.take_along_axis(d_all, order, 1)
    out["stream_ids"] = np.take_along_axis(i_all, order, 1)

    dm = jmesh.make_mesh(devices=jax.devices()[:S], model_parallel=2)
    corpus_dim = jax.device_put(corpus, NamedSharding(dm, P(jmesh.DATA_AXIS, jmesh.MODEL_AXIS)))
    q_sq = jnp.asarray((queries.astype(np.float64) ** 2).sum(1).astype(np.float32))
    for metric in DIM_METRICS:
        am, aa = jtopk2.prepare_aux(jnp.asarray(corpus), jnp.ones(N, bool), metric)
        qp = np.asarray(jtopk2.prepare_queries(jnp.asarray(queries), metric))
        packed = jsearch.build_dim_sharded_search(dm, k=K, metric=metric)(
            corpus_dim, jax.device_put(qp, NamedSharding(dm, P(None, jmesh.MODEL_AXIS))),
            jax.device_put(np.asarray(am), NamedSharding(dm, P(jmesh.DATA_AXIS))),
            jax.device_put(np.asarray(aa), NamedSharding(dm, P(jmesh.DATA_AXIS))), q_sq)
        d, i = jtopk2.unpack_result(np.asarray(packed))
        out[f"dim_{metric}_dist"], out[f"dim_{metric}_ids"] = np.asarray(d), np.asarray(i)
    return out


def _replicated(procs, single, keys) -> None:
    """(i) and (ii): each array equal on both processes and to one
    process's, bit for bit."""
    for key in keys:
        for r in procs:
            assert r[key].dtype == single[key].dtype and r[key].shape == single[key].shape, key
            np.testing.assert_array_equal(r[key], single[key], err_msg=key)


def _l2_close(got: np.ndarray, want: np.ndarray, queries: np.ndarray) -> None:
    """Port l2 against the JAX package's expanded form: 4e-4·‖q‖."""
    bound = 4e-4 * np.linalg.norm(queries, axis=1)[:, None]
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def test_search_merges_across_processes(procs, single, jax_ref):
    _replicated(procs, single, ("dist", "ids"))
    np.testing.assert_array_equal(procs[0]["ids"], jax_ref["ids"])
    _l2_close(procs[0]["dist"], jax_ref["dist"], inputs()["queries"])


def test_train_sharded_across_processes(procs, single, jax_ref):
    _replicated(procs, single, ("codebooks",))
    got, want = procs[0]["codebooks"], jax_ref["codebooks"]
    assert np.abs(got - want).max() <= 3.3e-7 * np.abs(want).max()


def test_shuffle_across_processes(procs, single, jax_ref):
    """The windows cross in one all-to-all a process pair; every output
    (the invalid slots too) is the JAX function's; the skewed id shuffle
    overflows and retries in step on both processes."""
    from fenix_tpu_torch import native

    keys = [f"shuffle{c}_{n}" for c in (1, 4) for n in ("recv", "recv_keys", "valid", "overflow")]
    _replicated(procs, single, keys)
    for key in keys:
        np.testing.assert_array_equal(procs[0][key], jax_ref[key], err_msg=key)
    valid, recv_keys = procs[0]["shuffle1_valid"], procs[0]["shuffle1_recv_keys"]
    assert valid.sum() == N  # every row arrives once
    per = valid.size // S
    for s in range(S):
        got = recv_keys[s * per : (s + 1) * per][valid[s * per : (s + 1) * per]]
        assert (native.hash_partition(got.astype(np.int64), S)[0] == s).all()
    for s in range(S):
        owner = procs[s // LOCAL]
        assert f"hot_ids_{s}" not in procs[1 - s // LOCAL]  # a process holds its own shards' ids
        np.testing.assert_array_equal(owner[f"hot_ids_{s}"], single[f"hot_ids_{s}"])
        np.testing.assert_array_equal(owner[f"hot_ids_{s}"], jax_ref[f"hot_ids_{s}"])


def test_parted_join_across_processes(procs, single, jax_ref):
    for agg in ("sum", "count"):
        _replicated(procs, single, (f"join_{agg}_gk", f"join_{agg}_gv"))
        np.testing.assert_array_equal(procs[0][f"join_{agg}_gk"], jax_ref[f"join_{agg}_gk"])
    np.testing.assert_array_equal(procs[0]["join_count_gv"], jax_ref["join_count_gv"])
    assert np.abs(procs[0]["join_sum_gv"] - jax_ref["join_sum_gv"]).max() < 1e-4


def test_ring_across_processes(procs, single, jax_ref):
    """Each process holds the blocks that end on its shards; in process
    order they are the single process's ring, which is the JAX ring's."""
    order = sorted(procs, key=lambda r: int(r["ring_q_start"]))
    assert [int(r["ring_q_start"]) for r in order] == [0, Q_RING // PROCS]
    for key in ("ring_ids", "ring_dist"):
        got = np.concatenate([r[key] for r in order])
        assert got.dtype == single[key].dtype
        np.testing.assert_array_equal(got, single[key])
    got_i = np.concatenate([r["ring_ids"] for r in order])
    np.testing.assert_array_equal(got_i, jax_ref["ring_ids"])
    _l2_close(np.concatenate([r["ring_dist"] for r in order]), jax_ref["ring_dist"], inputs()["ring_queries"])


def test_stream_across_processes(procs, single, jax_ref):
    _replicated(procs, single, ("stream_dist", "stream_ids"))
    np.testing.assert_array_equal(procs[0]["stream_ids"], jax_ref["stream_ids"])
    _l2_close(procs[0]["stream_dist"], jax_ref["stream_dist"], inputs()["queries"])


@pytest.mark.parametrize("metric", DIM_METRICS)
def test_dim_sharded_across_processes(procs, single, jax_ref, metric):
    _replicated(procs, single, (f"dim_{metric}_dist", f"dim_{metric}_ids"))
    np.testing.assert_array_equal(procs[0][f"dim_{metric}_ids"], jax_ref[f"dim_{metric}_ids"])
    got, want = procs[0][f"dim_{metric}_dist"], jax_ref[f"dim_{metric}_dist"]
    if metric == "l2":
        _l2_close(got, want, inputs()["queries"])
    else:
        assert (np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want))).all()


@pytest.mark.parametrize("uuids, backend", [
    (["GPU-a", "GPU-a", "GPU-b", "GPU-b"], "gloo"),  # two shards on one card
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),  # a card a shard
    ([None] * 8, "gloo"),  # the CPU
    (["GPU-a", None], "gloo"),
])
def test_backend_rule(uuids, backend):
    assert distributed.choose_backend(uuids) == backend


@pytest.mark.parametrize("cards, backend", [(("GPU-a", "GPU-a"), "gloo"), (("GPU-a", "GPU-b"), "nccl")])
def test_backend_rule_reads_the_cards(monkeypatch, cards, backend):
    """``initialize``'s layout names each card by its UUID: a card that two
    local shards share is one card (gloo), distinct cards are NCCL's."""
    class Props:
        def __init__(self, i):
            self.uuid = cards[i]

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props(i))
    uuids = [distributed._card_uuid(torch.device("cuda", i)) for i in range(2)]
    assert distributed.choose_backend(uuids) == backend
    assert distributed._card_uuid(torch.device("cpu")) is None


def test_a_peer_that_never_arrives_fails(tmp_path):
    """Process 0 alone: the rendezvous times out and the worker exits
    non-zero within its timeout, it does not hang."""
    start = time.monotonic()
    p = _start(_free_port(), 0, str(tmp_path), "2")
    try:
        log = p.communicate(timeout=WORKER_TIMEOUT_S)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode != 0, log
    assert time.monotonic() - start < WORKER_TIMEOUT_S
    assert not os.path.exists(tmp_path / "proc0.npz")


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], *(float(a) for a in sys.argv[4:5]))
