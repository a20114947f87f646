"""fenix_tpu_torch's shuffle and repartition against the JAX package's, on
the CPU.

The port's mesh is 8 ``cpu`` shards (``model_parallel=2``), the JAX
package's the 8 virtual CPU devices the suite forces
(``tests/conftest.py``) in the same ``(4, 2)`` grid; both take the same
numpy inputs. The cases are those of ``tests/test_shuffle.py`` and
``tests/test_repartition.py``.

Tolerances: the hash, every output of ``build_shuffle`` (the invalid
slots included), ``estimate_capacity``, the device shuffle's ids and the
shard tables are equal bit for bit (``Table.equals``); searches over a
repartitioned name return the ids they returned before it, in order, with
distances within 1e-5 (no two rows of these tables tie).
"""

import os
import socket
import threading
import time

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu
import fenix_tpu_torch
from fenix_tpu import native as jnative
from fenix_tpu.ops import relational as jrelational
from fenix_tpu.parallel import distributed as jdistributed
from fenix_tpu.parallel import mesh as jmesh
from fenix_tpu.parallel import shuffle as jshuffle
from fenix_tpu.parallel.mesh import row_sharding
from fenix_tpu_torch import expr, native
from fenix_tpu_torch.engine import executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import relational
from fenix_tpu_torch.parallel import distributed, shuffle
from fenix_tpu_torch.parallel import mesh as mesh_mod
from fenix_tpu_torch.parallel.search import put_rows

torch.set_num_threads(2)

S = 8
ROWS, DIM = 2_000, 16
EDGE_KEYS = np.array(
    [0, 1, -1, 2**31 - 1, -(2**31), 2**31, -(2**31) - 1, 2**32, 2**32 + 5, -(2**32) - 7, 2**40 + 3,
     -(2**40) + 3, 2**62 + 7, 2**63 - 1, -(2**63)], np.int64)


@pytest.fixture(autouse=True)
def _one_device_jax(monkeypatch):
    """The JAX package's process-wide serving mesh stays unset unless a
    test builds a mesh itself."""
    monkeypatch.setattr(jmesh, "_SERVING_MESH", None)


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh): 8 shards in a (4, 2) grid each."""
    return jmesh.make_mesh(S, model_parallel=2), mesh_mod.make_mesh(devices=["cpu"] * S, model_parallel=2)


def _jax_shuffle(jm, rows, keys, cap, chunks=1):
    fn = jshuffle.build_shuffle(jm, capacity=cap, row_shape=rows.shape[1:], chunks=chunks)
    out = fn(jax.device_put(rows, row_sharding(jm, rows.ndim)), jax.device_put(keys, row_sharding(jm, 1)))
    return [np.asarray(x) for x in out]


def _port_shuffle(pm, rows, keys, cap, chunks=1):
    fn = shuffle.build_shuffle(pm, cap, rows.shape[1:], chunks=chunks)
    return [x.gather().numpy() for x in fn(put_rows(pm, rows, rows.shape[0]), put_rows(pm, keys, keys.shape[0]))]


def _assert_outputs_equal(got, want):
    for name, a, b in zip(("recv", "recv_keys", "valid", "overflow"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- test_shuffle.py ----------------------------------------------------------


@pytest.mark.parametrize("num_partitions", [1, 3, 8, 1000])
def test_hash_partition_matches_jax_and_native(rng, num_partitions):
    """The murmur3 finalizer over the low 32 bits: bit-equal to the JAX
    function (which sees the keys cut to int32) and to ``native`` (both
    packages' copies) over negative keys, keys at ±2³¹, past 2³² and 0."""
    keys = np.concatenate([EDGE_KEYS, rng.integers(-(2**63), 2**63 - 1, 4096, dtype=np.int64)])
    got = relational.hash_partition(torch.from_numpy(keys), num_partitions)
    assert got.dtype == torch.int32
    want_jax = np.asarray(jrelational.hash_partition(jax.numpy.asarray(keys.astype(np.int32)), num_partitions))
    np.testing.assert_array_equal(got.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), jnative.hash_partition(keys, num_partitions)[0])
    np.testing.assert_array_equal(got.numpy(), native.hash_partition(keys, num_partitions)[0])
    got32 = relational.hash_partition(torch.from_numpy(keys.astype(np.int32)), num_partitions)
    np.testing.assert_array_equal(got32.numpy(), got.numpy())


@pytest.mark.parametrize("chunks", [1, 4], ids=["single", "double-buffered"])
def test_shuffle_routes_all_rows(meshes, rng, chunks):
    """All four outputs equal the JAX function's, and every row arrives
    once, with its key, on the shard its hash names."""
    jm, pm = meshes
    n, d, cap = S * 256, 8, 256
    rows = rng.standard_normal((n, d)).astype(np.float32)
    keys = rng.integers(0, 1 << 30, n).astype(np.int32)
    got = _port_shuffle(pm, rows, keys, cap, chunks)
    _assert_outputs_equal(got, _jax_shuffle(jm, rows, keys, cap, chunks))

    recv_rows, recv_keys, valid, overflow = got
    assert overflow.shape == (S * S,) and not overflow.any()
    parts, _ = native.hash_partition(keys.astype(np.int64), S)
    lookup = {int(k): rows[i] for i, k in enumerate(keys)}
    per_keys, per_valid, per_rows = recv_keys.reshape(S, -1), valid.reshape(S, -1), recv_rows.reshape(S, -1, d)
    for s in range(S):
        assert sorted(per_keys[s][per_valid[s]].tolist()) == sorted(keys[parts == s].tolist()), f"shard {s}"
        for k, r in zip(per_keys[s][per_valid[s]], per_rows[s][per_valid[s]]):
            np.testing.assert_array_equal(r, lookup[int(k)])
    assert valid.sum() == n


def test_shuffle_chunked_bitwise_matches_single(meshes, rng):
    """The double-buffered exchange reassembles to the exact layout of the
    single exchange: the same receive positions, keys and validity."""
    _, pm = meshes
    n, d, cap = S * 128, 4, 128
    rows = rng.standard_normal((n, d)).astype(np.float32)
    keys = rng.integers(0, 1 << 30, n).astype(np.int32)
    _assert_outputs_equal(_port_shuffle(pm, rows, keys, cap, chunks=4), _port_shuffle(pm, rows, keys, cap))


@pytest.mark.parametrize("chunks", [1, 4])
def test_shuffle_overflow_detected(meshes, rng, chunks):
    """Every key to one shard at a tiny capacity: each source flags that
    destination, [S·S] flags in all, equal to the JAX function's with
    the clipped invalid slots."""
    jm, pm = meshes
    n, d, cap = S * 64, 4, 8
    rows = rng.standard_normal((n, d)).astype(np.float32)
    keys = np.zeros(n, dtype=np.int32)
    got = _port_shuffle(pm, rows, keys, cap, chunks)
    _assert_outputs_equal(got, _jax_shuffle(jm, rows, keys, cap, chunks))
    flags = got[3].reshape(S, S)
    hot = int(native.hash_partition(np.zeros(1, np.int64), S)[0][0])
    assert flags[:, hot].all() and flags.sum() == S


def test_shuffle_skewed_keys_match_jax(meshes, rng):
    """Few distinct keys (overflow on some windows), 3-wide rows and
    chunks of 4: every output equals the JAX function's."""
    jm, pm = meshes
    n = S * 64
    rows = rng.standard_normal((n, 3)).astype(np.float32)
    keys = rng.integers(-5, 5, n).astype(np.int32)
    got = _port_shuffle(pm, rows, keys, 16, chunks=4)
    _assert_outputs_equal(got, _jax_shuffle(jm, rows, keys, 16, chunks=4))
    assert got[3].any()


def test_shuffle_refuses_uneven_chunks(meshes):
    with pytest.raises(ValueError, match="chunks"):
        shuffle.build_shuffle(meshes[1], 10, (), chunks=4)


def test_estimate_capacity(rng):
    keys = rng.integers(0, 1 << 30, 10_000).astype(np.int64)
    for sample, rows in ((keys[:1000], 1024), (keys, 4096), (np.zeros(1000, np.int64), 1024)):
        for safety in (1.5, 2.0):
            got = shuffle.estimate_capacity(sample, 8, rows_per_shard=rows, safety=safety)
            assert got == jshuffle.estimate_capacity(sample, 8, rows_per_shard=rows, safety=safety)
    cap = shuffle.estimate_capacity(keys[:1000], 8, rows_per_shard=1024)
    assert 1024 / 8 <= cap <= 1024
    assert shuffle.estimate_capacity(np.zeros(1000, np.int64), 8, rows_per_shard=1024) == 1024


def _items(vecs: np.ndarray) -> pa.Table:
    n = vecs.shape[0]
    return pa.table({
        "id": pa.array(np.arange(n)),
        "tag": pa.array((np.arange(n) % 5).astype(np.int64)),
        "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
    })


def test_shard_table_and_manifest(tmp_path, rng):
    """``shard_table`` places rows as the JAX package's does; the manifest
    round-trips and names each process's shards."""
    vecs = rng.standard_normal((1000, 8)).astype(np.float32)
    for name in ("port", "jax"):
        table.make(str(tmp_path / name), "t", _items(vecs).to_reader())
    manifest = distributed.shard_table(str(tmp_path / "port"), "t", num_shards=4)
    jdistributed.shard_table(str(tmp_path / "jax"), "t", num_shards=4)
    assert manifest.num_shards == 4
    seen = []
    for s in range(4):
        part = table.load(str(tmp_path / "port"), manifest.shard_name(s))
        assert part.equals(table.load(str(tmp_path / "jax"), manifest.shard_name(s)))
        ids = np.asarray(part.column("id"))
        assert (native.hash_partition(ids, 4)[0] == s).all()
        seen.append(ids)
    assert sorted(np.concatenate(seen).tolist()) == list(range(1000))
    m2 = distributed.ShardManifest.from_json(manifest.to_json())
    assert m2 == manifest and m2.local_shards(0, 2) == [0, 2] and m2.local_shards(1, 2) == [1, 3]


@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed_retry"])
def test_device_shuffle_ids_match_jax(meshes, rng, monkeypatch, skewed):
    """The (key, row id) exchange returns the JAX function's ids per shard,
    each equal to the host hash's rows; a skewed table (the hot key's rows
    all on the first source shards) overflows the estimated capacity and
    succeeds on the retry at ``n_pad // S``."""
    jm, pm = meshes
    n = 5003  # padded to a multiple of 8 with −1 ids
    keys = rng.integers(-(1 << 40), 1 << 40, n)
    if skewed:  # 30 %: the estimate stays under the provable bound
        keys[: 3 * n // 10] = 12345
    caps = []
    build = shuffle.build_shuffle

    def spy(mesh, capacity, row_shape, chunks=1):
        fn = build(mesh, capacity, row_shape, chunks)

        def run(rows, ks):
            out = fn(rows, ks)
            caps.append((capacity, chunks, bool(out[3].gather().any())))
            return out

        return run

    monkeypatch.setattr(shuffle, "build_shuffle", spy)
    got = distributed._device_shuffle_ids(pm, keys, S)
    want = jdistributed._device_shuffle_ids(jm, keys, S)
    parts, _ = native.hash_partition(keys, S)
    for s in range(S):
        np.testing.assert_array_equal(got[s], want[s])
        np.testing.assert_array_equal(got[s], np.flatnonzero(parts == s))
    n_pad = -(-n // S) * S
    estimated = shuffle.estimate_capacity(keys, S, n_pad // S, safety=2.0)
    if skewed:
        assert [c[2] for c in caps] == [True, False] and caps[1][0] == n_pad // S
    else:
        assert caps == [(estimated, 1, False)]


# -- test_repartition.py ------------------------------------------------------


@pytest.fixture
def spy_device_route(monkeypatch):
    """Calls of the device shuffle, by shard count."""
    calls = []
    inner = distributed._device_shuffle_ids

    def spy(mesh, keys, num_shards):
        calls.append(num_shards)
        return inner(mesh, keys, num_shards)

    monkeypatch.setattr(distributed, "_device_shuffle_ids", spy)
    return calls


def _search(cache, source, q, **kw):
    source = distributed.resolve_source(cache.root, source)
    return executor.execute_search(cache, executor.SearchRequest(source, "vector", q, **kw))


def test_repartition_on_the_mesh_matches_jax_and_host(meshes, tmp_path, rng, spy_device_route):
    """``repartition`` with a mesh of as many shards takes the device
    shuffle; its shard tables equal the JAX device path's and the host
    path's, and searches over the name return what they did before."""
    jm, pm = meshes
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    roots = {name: str(tmp_path / name) for name in ("port", "jax", "host")}
    for root in roots.values():
        table.make(root, "t", _items(vecs).to_reader())
    cache = DeviceCache(roots["port"], block=128, device="cpu", mesh=pm)
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    kws = [dict(metric="l2", maxval=7), dict(metric="cosine", maxval=5, filter=expr.field("tag") == 2)]
    before = [_search(cache, "t", q, **kw) for kw in kws]

    manifest = distributed.repartition(roots["port"], "t", S, mesh=pm)
    assert spy_device_route == [S]
    jdistributed.repartition(roots["jax"], "t", S, mesh=jm)
    distributed.repartition(roots["host"], "t", S, mesh=None)
    assert spy_device_route == [S]
    for s in range(S):
        got = table.load(roots["port"], manifest.shard_name(s))
        assert got.equals(table.load(roots["jax"], manifest.shard_name(s)))
        assert got.equals(table.load(roots["host"], manifest.shard_name(s)))
    assert distributed.resolve_source(roots["port"], "t") == [f"t@{s}" for s in range(S)]

    cache.invalidate()
    for kw, want in zip(kws, before):
        got = _search(cache, "t", q, **kw)
        assert got.column("id").equals(want.column("id"))
        np.testing.assert_allclose(np.asarray(got.column(executor.DIST_COL)),
                                   np.asarray(want.column(executor.DIST_COL)), atol=1e-5, rtol=1e-5)
    assert all(t == 2 for t in _search(cache, "t", q, **kws[1]).column("tag").to_pylist())


def test_repartition_host_path_matches_device_hash(meshes, tmp_path, rng, spy_device_route):
    """A shard count other than the mesh's takes the host hash, with the
    same placement as the JAX package's host path."""
    _, pm = meshes
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    for name in ("port", "jax"):
        table.make(str(tmp_path / name), "t", _items(vecs).to_reader())
    manifest = distributed.repartition(str(tmp_path / "port"), "t", 3, mesh=pm)
    jdistributed.repartition(str(tmp_path / "jax"), "t", 3, mesh=None)
    assert spy_device_route == []
    for s in range(3):
        got = table.load(str(tmp_path / "port"), manifest.shard_name(s))
        assert got.equals(table.load(str(tmp_path / "jax"), manifest.shard_name(s)))
        assert (native.hash_partition(np.asarray(got.column("id")), 3)[0] == s).all()


def test_repartition_empty_table_takes_the_host_path(meshes, tmp_path, spy_device_route):
    """An empty table on a mesh of as many shards: the host path, S empty
    shard tables, as the JAX package writes them."""
    _, pm = meshes
    empty = _items(np.zeros((0, DIM), np.float32))
    for name in ("port", "jax"):
        table.make(str(tmp_path / name), "t", empty.to_reader())
    manifest = distributed.repartition(str(tmp_path / "port"), "t", S, mesh=pm)
    jdistributed.repartition(str(tmp_path / "jax"), "t", S, mesh=None)
    assert spy_device_route == []
    for s in range(S):
        got = table.load(str(tmp_path / "port"), manifest.shard_name(s))
        assert got.num_rows == 0 and got.equals(table.load(str(tmp_path / "jax"), manifest.shard_name(s)))


@pytest.fixture(scope="module")
def server(tmp_path_factory, meshes):
    """A port server whose cache holds the port's cpu mesh."""
    root = os.path.abspath(str(tmp_path_factory.mktemp("repart_root")))
    key = (root, "cpu")
    executor._CACHES[key] = DeviceCache(root, device="cpu", mesh=meshes[1])
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    yield root, server.port
    server.shutdown()
    executor._CACHES.pop(key, None)


def test_flight_repartition_device_path_search_identical(server, rng, spy_device_route):
    """The unchanged JAX client's ``repartition`` with its default shard
    count (the mesh size) on the port server: the device route, every row
    on one shard, searches, a filtered search and a read as before."""
    root, port = server
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    table.make(root, "t", _items(vecs).to_reader())
    client = fenix_tpu.Flight(host="127.0.0.1", port=port)
    q = vecs[42] + 0.01 * rng.standard_normal(DIM).astype(np.float32)
    before = client.search(q, "t", "vector", metric="l2", maxval=7)

    manifest = client.repartition("t")
    assert manifest["num_shards"] == S and spy_device_route == [S]
    resolved = distributed.resolve_source(root, "t")
    all_ids = np.concatenate([np.asarray(table.load(root, s).column("id")) for s in resolved])
    assert sorted(all_ids.tolist()) == list(range(ROWS))

    after = client.search(q, "t", "vector", metric="l2", maxval=7)
    assert after.column("id").to_pylist() == before.column("id").to_pylist()
    np.testing.assert_allclose(np.asarray(after.column(executor.DIST_COL)),
                               np.asarray(before.column(executor.DIST_COL)), atol=1e-5)
    from fenix_tpu import expr as jexpr

    out = client.search(q, "t", "vector", metric="l2", maxval=5, filter=jexpr.field("tag") == 2)
    assert out.num_rows == 5 and all(t == 2 for t in out.column("tag").to_pylist())
    rt = client.read_table("t").read_all()
    assert sorted(np.asarray(rt.column("id")).tolist()) == list(range(ROWS))


def test_flight_repartition_probed_and_mutation_guard(server, rng):
    """On the name repartitioned above: make-index over the shard list and
    a probed search, an append refused, a delete fanned out over the
    shards, and drop-table removing shards and manifest."""
    from fenix_tpu import expr as jexpr

    root, port = server
    client = fenix_tpu.Flight(host="127.0.0.1", port=port)
    client.make_index("ivf", "t", "vector", {"metric": "l2", "codebook_size": 4, "num_codebooks": 2,
                                             "batch_size": 256, "num_epochs": 1})
    q = rng.standard_normal(DIM).astype(np.float32)
    out = client.search(q, "t", "vector", metric="l2", maxval=5, coding="ivf", probes=4)
    assert 0 < out.num_rows <= 5
    extra = _items(rng.standard_normal((4, DIM)).astype(np.float32))
    with pytest.raises(Exception, match="repartitioned"):
        client.append_table("t", extra.to_reader())
    assert client.delete_rows("t", jexpr.field("id") >= ROWS - 100) == 100
    client.drop_table("t")
    assert distributed.load_manifest(root, "t") is None
    assert [*table.list(root)] == []


# -- ClusterConfig / initialize -----------------------------------------------


def test_cluster_config_and_initialize(monkeypatch):
    """The config reads the JAX package's variables into the same JSON;
    one process gets ``make_mesh`` over its cards with the config's
    model_parallel; with a coordinator nobody serves, ``initialize`` fails
    within its timeout (it never waits forever for a peer)."""
    env = {"FENIX_COORDINATOR": "10.0.0.1:1234", "FENIX_NUM_PROCESSES": "2", "FENIX_PROCESS_ID": "1",
           "FENIX_MODEL_PARALLEL": "2"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config = distributed.ClusterConfig.from_env()
    assert config.to_json() == jdistributed.ClusterConfig.from_env().to_json()
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    start = time.monotonic()
    with pytest.raises(RuntimeError):  # torch.distributed's DistError
        distributed.initialize(distributed.ClusterConfig(f"127.0.0.1:{closed}", 2, 1), devices=["cpu"], timeout=1.0)
    assert time.monotonic() - start < 30
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = distributed.initialize(distributed.ClusterConfig(model_parallel=2))
    assert mesh.shape == {"data": 2, "model": 2}
    assert [str(d) for d in mesh.devices] == [f"cuda:{i}" for i in range(4)]
