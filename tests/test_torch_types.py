"""fenix_tpu_torch.types and the typed-column search path against the JAX
package's, on the CPU.

Every case of tests/test_types.py has a twin here. The port's arrays must
give the JAX package's storage bytes and serialized metadata for the same
input (so a column built by either package has the same IPC bytes), the
same ``dynamic_quantize`` result and bit-equal dequantization. Searches
run through both packages on one root: ids equal, distances within
rtol/atol 1e-5, and an l2 distance held to float64 within 1e-5 (the port
returns ``‖q − v‖``, ROADMAP queue 3). Files cross both ways. Two fresh
subprocesses check the registration hazard: importing the port registers
no extension type, so the JAX package imported after it still searches a
quint8 column dequantized, and the port alone serves one.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu  # noqa: F401 — registers the JAX package's extension types, as its users' processes do
from fenix_tpu import coder as jcoder
from fenix_tpu import index as jindex
from fenix_tpu import types as jtypes
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.io import ingest as jingest
from fenix_tpu.io import table as jtable
from fenix_tpu_torch import coder, index, types
from fenix_tpu_torch.engine import executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import arrow, ingest, table

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ipc_bytes(table_: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table_.schema) as w:
        w.write_table(table_)
    return sink.getvalue().to_pybytes()


def storage_form(arr: pa.ExtensionArray, name: str = "vector") -> pa.Table:
    """A one-column table holding ``arr`` as an unregistered reader sees
    it: the storage type, the extension name and parameters in the field
    metadata."""
    meta = {types.NAME_KEY: arr.type.extension_name.encode(), types.METADATA_KEY: arr.type.__arrow_ext_serialize__()}
    return pa.Table.from_arrays([arr.storage], schema=pa.schema([pa.field(name, arr.storage.type, metadata=meta)]))


def search_both(root, target, coding=None, **kw):
    """The port's and the JAX package's answers (single-device JAX cache)."""
    req = dict(source="t", column="vector", target=target, coding=coding, **kw)
    got = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(**req))
    want = jexecutor.execute_search(JaxCache(root, mesh=None), jexecutor.SearchRequest(**req))
    return got, want


def assert_same_answer(got: pa.Table, want: pa.Table, matrix=None, target=None, metric=None) -> None:
    """Equal schemas and ids, distances within 1e-5 of the JAX package's
    (of float64 for l2, given the matrix and the target)."""
    assert got.schema == want.schema
    assert got.column("id").to_pylist() == want.column("id").to_pylist()
    d = got.column("__DISTANCE__").to_numpy()
    assert d.dtype == np.float32
    if metric == "l2":
        q = np.atleast_2d(np.asarray(target, np.float64))
        rows = matrix.astype(np.float64)[got.column("id").to_numpy()]
        qi = got.column("__QUERY_ID__").to_numpy() if "__QUERY_ID__" in got.column_names else np.zeros(len(rows), int)
        np.testing.assert_allclose(d, np.linalg.norm(rows - q[qi], axis=1), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(d, want.column("__DISTANCE__").to_numpy(), rtol=1e-5, atol=1e-5)


# -- the arrays (twins of the round-trip cases) ------------------------------


def test_tensor_array_roundtrip_matches_jax(rng):
    x = rng.standard_normal((10, 3, 4)).astype(np.float32)
    arr = types.tensor.from_numpy(x)
    want = jtypes.tensor.from_numpy(x)
    assert arr.type.shape == (3, 4) and arr.type.extension_name == want.type.extension_name
    assert arr.type.__arrow_ext_serialize__() == want.type.__arrow_ext_serialize__()
    assert arr.storage.equals(want.storage)
    np.testing.assert_array_equal(arr.to_numpy(), x)
    np.testing.assert_array_equal(arr[2].to_numpy(), x[2])
    np.testing.assert_array_equal(arr.to_torch().numpy(), x)
    np.testing.assert_array_equal(types.tensor.from_torch(torch.from_numpy(x)).to_numpy(), x)
    assert ipc_bytes(pa.table({"t": arr})) == ipc_bytes(pa.table({"t": want}))


def test_tensor_ipc_roundtrip_reads_in_both_packages(tmp_path, rng):
    x = rng.standard_normal((8, 5)).astype(np.float32)
    out = arrow.make(str(tmp_path / "t.arrow"), pa.table({"t": types.tensor.from_numpy(x)}).to_reader())
    col = out.column("t").combine_chunks()
    # this process registered the JAX package's classes: the port's
    # column reads back as the JAX package's own type
    assert isinstance(col.type, jtypes.TensorType)
    assert types.logical_vector(out.schema.field("t")).kind == "tensor"
    np.testing.assert_array_equal(col.to_numpy(), x)


def test_nested_roundtrip_matches_jax(rng):
    data = {
        "a": rng.standard_normal((6, 2)).astype(np.float32),
        "inner": {"b": rng.standard_normal((6, 3, 2)).astype(np.float32)},
    }
    arr = types.nested.from_numpy(data)
    want = jtypes.nested.from_numpy(data)
    assert arr.type.__arrow_ext_serialize__() == want.type.__arrow_ext_serialize__()
    assert arr.storage.equals(want.storage)
    back = arr.to_numpy()
    np.testing.assert_array_equal(back["a"], data["a"])
    np.testing.assert_array_equal(back["inner"]["b"], data["inner"]["b"])
    leaf = arr.to_field("inner", "b")
    assert types.logical_vector(leaf).kind == "tensor"
    np.testing.assert_array_equal(leaf.to_numpy(), data["inner"]["b"])
    sub = arr.to_field("inner")
    assert types.logical_vector(sub).kind == "nested"
    np.testing.assert_array_equal(sub.to_numpy()["b"], data["inner"]["b"])
    torch_back = arr.to_torch()
    np.testing.assert_array_equal(torch_back["inner"]["b"].numpy(), data["inner"]["b"])
    again = types.nested.NestedTensorArray.from_torch({"a": torch.from_numpy(data["a"])})
    np.testing.assert_array_equal(again.to_numpy()["a"], data["a"])
    assert ipc_bytes(pa.table({"n": arr})) == ipc_bytes(pa.table({"n": want}))


def test_nested_scalar(rng):
    data = {"a": rng.standard_normal((4, 2)).astype(np.float32)}
    arr = types.nested.from_numpy(data)
    np.testing.assert_array_equal(arr[1].to_numpy()["a"], data["a"][1])
    np.testing.assert_array_equal(arr[1].to_field("a").to_numpy(), data["a"][1])


@pytest.mark.parametrize("scale", [1.0, 3.0, 1e-3])
def test_quint8_quantize_matches_jax(rng, scale):
    x = rng.standard_normal((20, 16)).astype(np.float32) * scale
    q, s, z = types.quint8.dynamic_quantize(x)
    jq, js, jz = jtypes.quint8.dynamic_quantize(x)
    np.testing.assert_array_equal(q, jq)
    assert (s, z) == (js, jz)
    arr = types.quint8.from_numpy(x)
    want = jtypes.quint8.from_numpy(x)
    assert arr.type.__arrow_ext_serialize__() == want.type.__arrow_ext_serialize__()
    assert arr.storage.equals(want.storage)
    deq = arr.dequantize()
    assert deq.shape == x.shape and deq.dtype == np.float32
    np.testing.assert_array_equal(deq.view(np.uint32), want.dequantize().view(np.uint32))
    # quantization error bounded by scale/2 per element
    assert np.abs(deq - x).max() <= arr.type.scale * 0.5 + 1e-6
    # the engine's logical view (ingest) is the same bits
    got = ingest.fixed_size_list_to_numpy(arr)
    np.testing.assert_array_equal(got.view(np.uint32), jingest.fixed_size_list_to_numpy(want).view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), deq.view(np.uint32))


def test_quint8_like_clips_appends_as_jax(rng):
    x = rng.standard_normal((30, 8)).astype(np.float32)
    base = jtypes.quint8.from_numpy(x)
    extra = rng.standard_normal((12, 8)).astype(np.float32) * 4  # past the base's range: clipped
    got = types.quint8.QUInt8TensorArray.from_numpy(extra, like=base.type)
    want = jtypes.quint8.QUInt8TensorArray.from_numpy(extra, like=base.type)
    assert got.type == base.type and got.storage.equals(want.storage)
    assert np.asarray(got.storage.values).max() <= base.type.qmax


def test_quint8_ipc_roundtrip(tmp_path, rng):
    x = rng.standard_normal((10, 8)).astype(np.float32)
    arr = types.quint8.from_numpy(x)
    out = arrow.make(str(tmp_path / "q.arrow"), pa.table({"q": arr}).to_reader())
    col = out.column("q").combine_chunks()
    assert isinstance(col.type, jtypes.QUInt8TensorType)
    np.testing.assert_allclose(col.dequantize(), x, atol=col.type.scale * 0.5 + 1e-6)
    assert ipc_bytes(pa.table({"q": arr})) == ipc_bytes(pa.table({"q": jtypes.quint8.from_numpy(x)}))


def test_quint8_torch_bridge(rng):
    x = rng.standard_normal((10, 8)).astype(np.float32)
    arr = types.quint8.from_numpy(x)
    q, scale, shift = arr.to_torch_quantized()
    assert q.dtype == torch.uint8
    jq, jscale, jshift = jtypes.quint8.from_numpy(x).to_jax_quantized()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert (scale, shift) == (jscale, jshift)
    deq = scale * (q.numpy().astype(np.float32) - shift)
    np.testing.assert_allclose(deq, arr.dequantize(), atol=1e-6)


# -- recognition by name, both forms ------------------------------------------


@pytest.mark.parametrize("kind", ["tensor", "quint8"])
def test_logical_vector_reads_both_forms(rng, kind):
    x = rng.standard_normal((40, 8)).astype(np.float32)
    arr = (jtypes.tensor if kind == "tensor" else jtypes.quint8).from_numpy(x)
    registered = pa.table({"vector": arr})
    unregistered = storage_form(arr)
    assert unregistered.schema.field("vector").type == arr.storage.type
    want_type = pa.list_(pa.float32(), 8)
    for data in (registered, unregistered):
        field = data.schema.field("vector")
        lv = types.logical_vector(field)
        assert lv.kind == kind and lv.storage == arr.storage.type
        assert ingest.vector_field_type(field) == want_type
        np.testing.assert_array_equal(
            ingest.vector_matrix(data, "vector").view(np.uint32),
            jingest.fixed_size_list_to_numpy(arr).view(np.uint32),
        )
        typed = types.typed_column(data, "vector")
        assert types.logical_vector(typed).kind == kind
    assert types.logical_vector(pa.list_(pa.float32(), 8)).kind is None
    with pytest.raises(AssertionError):
        ingest.vector_field_type(pa.field("n", types.nested.from_numpy({"a": x}).type))


def test_device_dequantization_is_the_host_bits(rng):
    x = rng.standard_normal((3000, 24)).astype(np.float32) * 5
    arr = types.quint8.from_numpy(x)
    chunked = pa.chunked_array([arr[:1000], arr[1000:]])
    want = ingest.fixed_size_list_to_numpy(chunked)
    for col in (arr, chunked, types.typed_column(storage_form(arr), "vector")):
        got = ingest.to_device_matrix(col, block=1024, device="cpu")
        assert got.rows == 3000 and got.data.shape == (3072, 24)
        np.testing.assert_array_equal(got.data[:3000].numpy().view(np.uint32), want.view(np.uint32))
        assert not got.data[3000:].any()


@pytest.mark.parametrize("kind", ["tensor", "quint8", "jax_quint8"])
@pytest.mark.parametrize("registered", [True, False])
def test_typed_columns_gather_with_their_type(tmp_path, rng, kind, registered):
    """The result gather's fast path takes a typed column's storage (raw
    codes for quint8) and puts its type back: its result equals Arrow
    take's, the registered type kept, the unregistered form's extension
    metadata kept, so the IPC form is typed either way."""
    x = rng.standard_normal((300, 8)).astype(np.float32)
    arr = {"tensor": types.tensor.from_numpy, "quint8": types.quint8.from_numpy,
           "jax_quint8": jtypes.quint8.from_numpy}[kind](x)
    chunked = pa.chunked_array([arr[:100], arr[100:]])
    data = pa.table({"vector": chunked}) if registered else pa.Table.from_arrays(
        [pa.chunked_array([c.storage for c in chunked.chunks])], schema=storage_form(arr).schema)
    data = data.append_column("id", pa.array(np.arange(300)))
    views = DeviceCache(str(tmp_path), device="cpu").host_column_views("t", data, ("token", kind, registered))
    assert "vector" in views and "id" in views
    ids = np.array([[3, 170, -1], [299, 0, 101]])
    args = (data, ["vector", "id", "__DISTANCE__"], np.zeros((2, 3), np.float32), ids, np.float32)
    fast, taken = executor.gather_results(*args, views=views), executor.gather_results(*args)
    assert fast.equals(taken) and fast.schema == taken.schema
    assert fast.schema.field("vector").metadata == (None if registered else data.schema.field("vector").metadata)
    back = pa.ipc.open_stream(ipc_bytes(fast)).read_all()
    assert isinstance(back.column("vector").type, pa.ExtensionType)
    assert back.column("vector").type.extension_name == arr.type.extension_name
    assert back.column("vector").combine_chunks().storage.equals(arr.storage.take(pa.array([3, 170, 299, 0, 101])))


def _unregister() -> None:
    for name in (types.tensor.NAME, types.nested.NAME, types.quint8.NAME):
        try:
            pa.unregister_extension_type(name)
        except KeyError:
            pass


@pytest.fixture
def port_only():
    """This process as a port-only one sees typed columns: the three
    extension names unregistered (the JAX package's classes come back
    after the test)."""
    _unregister()
    yield
    jtypes.register_all()


def _routes(root, target):
    """The port's answers on every route over table "t" with coder "c"."""
    cache = DeviceCache(root, device="cpu")
    out = {}
    for name, kw in {
        "fp32": dict(metric="l2", maxval=6, select=["id", "vector"]),
        "bf16": dict(metric="cosine", maxval=6, precision="bf16"),
        "int8": dict(metric="l2", maxval=6, precision="int8"),
        "clustered": dict(metric="l2", maxval=6, coding="c", probes=3, select=["id", "vector"]),
        "scan": dict(metric="l2", maxval=6, coding="c", probes=3, precision="int8"),
        "read": dict(metric="l2", maxval=None, filter=None, coding="c", probes=1),
    }.items():
        out[name] = executor.execute_search(cache, executor.SearchRequest("t", "vector", target, **kw))
    return out


def test_port_only_process_serves_quint8_on_every_route(tmp_path, rng, port_only):
    """With no extension type registered (a port-only process, as the
    server and chip_smoke.py are), a quint8 table is searched dequantized
    on every route (exact fp32 / bf16 / int8, both IVF routes, a read), a
    coded read and every result keep the column's extension metadata, and
    each answer equals the same request's with the JAX package's types
    registered."""
    root = str(tmp_path)
    vecs = rng.standard_normal((3000, 16)).astype(np.float32)
    vecs[1500:] += 3.0
    arr = types.quint8.from_numpy(vecs)
    table.make(root, "t", pa.table({"id": pa.array(np.arange(3000)), "vector": arr}).to_reader(max_chunksize=700))
    deq = arr.dequantize()
    field = table.load(root, "t").schema.field("vector")
    assert not isinstance(field.type, pa.ExtensionType) and types.logical_vector(field).kind == "quint8"
    coder.make(root, "c", "t", "vector", {"metric": "l2", "codebook_size": 8, "num_codebooks": 1,
                                          "batch_size": 512, "num_epochs": 2}, seed=0, device="cpu")
    index.make(root, "c", "t", "vector", device="cpu")
    coded = index.load(root, "c", "t", "vector")
    assert coded.schema.field("vector").metadata == field.metadata
    target = deq[[5, 2000, 2999]] + 0.01
    got = _routes(root, target)
    for name, result in got.items():
        assert result.schema.field("__DISTANCE__").type == pa.float32(), name
        if "vector" in result.column_names:
            assert result.schema.field("vector").metadata == field.metadata, name
    ids = got["fp32"].column("id").to_numpy().reshape(3, 6)
    d64 = ((deq.astype(np.float64)[None] - target.astype(np.float64)[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ids, np.argsort(d64, axis=1, kind="stable")[:, :6])
    np.testing.assert_allclose(got["fp32"].column("__DISTANCE__").to_numpy(),
                               np.sqrt(np.sort(d64, axis=1)[:, :6]).reshape(-1), rtol=1e-5, atol=1e-5)
    # the same requests with the JAX package's classes registered
    jtypes.register_all()
    want = _routes(root, target)
    for name in got:
        assert got[name].column("id").equals(want[name].column("id")), name
        np.testing.assert_array_equal(got[name].column("__DISTANCE__").to_numpy(),
                                      want[name].column("__DISTANCE__").to_numpy())
    _unregister()
    # an append typed like the table, the port's class restored from the field
    like = types.typed_column(table.load(root, "t"), "vector").type
    new = types.quint8.QUInt8TensorArray.from_numpy(rng.standard_normal((40, 16)).astype(np.float32), like=like)
    extra = pa.table({"id": pa.array(np.arange(3000, 3040)), "vector": new})
    table.append(root, "t", extra)
    index.extend_for_source(root, "t", extra, device="cpu")
    got_after = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(
        "t", "vector", new.dequantize()[7], metric="l2", maxval=1))
    assert got_after.column("id").to_pylist() == [3007]


# -- searches through both packages (twins of the search cases) --------------


def test_tensor_column_searchable_end_to_end(tmp_path, rng):
    root = str(tmp_path)
    vecs = rng.standard_normal((500, 16)).astype(np.float32)
    jtable.make(root, "t", pa.table({"id": pa.array(np.arange(500)),
                                     "vector": jtypes.tensor.TensorArray.from_numpy(vecs)}).to_reader())
    out = index.call(root, None, "t", "vector", vecs[3], metric="l2", maxval=3, device="cpu")
    assert out.column("id").to_pylist()[0] == 3 and out.column(index.DIST_COL).to_numpy()[0] < 1e-4
    for metric in ("l2", "cosine"):
        got, want = search_both(root, vecs[3:7] + 0.01, metric=metric, maxval=5, select=["id", "vector"])
        assert_same_answer(got, want, vecs, vecs[3:7] + 0.01, metric)
        assert isinstance(got.column("vector").type, jtypes.TensorType)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_quint8_column_searchable_dequantized(tmp_path, rng, precision):
    root = str(tmp_path)
    vecs = rng.standard_normal((400, 8)).astype(np.float32)
    arr = jtypes.quint8.QUInt8TensorArray.from_numpy(vecs)
    scale, shift = arr.type.scale, arr.type.shift
    deq = (np.asarray(arr.storage.values).reshape(400, 8).astype(np.float32) - shift) * scale
    jtable.make(root, "t", pa.table({"id": pa.array(np.arange(400)), "vector": arr}).to_reader())
    q = deq[7]
    req = executor.SearchRequest("t", "vector", q, metric="l2", maxval=4, precision=precision)
    out = executor.execute_search(DeviceCache(root, device="cpu"), req)
    oracle = np.argsort(((deq - q) ** 2).sum(1), kind="stable")[:4]
    assert out.column("id").to_pylist() == oracle.tolist()
    dists = out.column("__DISTANCE__").to_numpy()
    assert dists.dtype == np.float32 and dists[0] < 1e-5
    targets = deq[[3, 50, 99]] + 0.02
    got, want = search_both(root, targets, metric="l2", maxval=6, precision=precision)
    assert_same_answer(got, want, deq, targets, "l2")
    got, want = search_both(root, targets, metric="cosine", maxval=6, precision=precision, select=["vector", "id"])
    assert_same_answer(got, want)
    assert isinstance(got.column("vector").type, jtypes.QUInt8TensorType)


def test_quint8_column_full_lifecycle(tmp_path, rng, monkeypatch):
    """Coder training, probed search and appends with ``like=`` over a
    quint8 column, through both packages on one root."""
    import fenix_tpu.parallel.mesh as jmesh

    monkeypatch.setattr(jmesh, "_SERVING_MESH", None)  # the JAX trainer on one device
    root = str(tmp_path)
    vecs = rng.standard_normal((600, 8)).astype(np.float32)
    vecs[300:] += 4.0
    arr = types.quint8.QUInt8TensorArray.from_numpy(vecs)
    table.make(root, "t", pa.table({"id": pa.array(np.arange(600)), "vector": arr}).to_reader())
    deq = arr.dequantize().reshape(600, 8)

    cfg = {"metric": "l2", "codebook_size": 2, "num_codebooks": 2, "batch_size": 128, "num_epochs": 1}
    made = coder.make(root, "c", "t", "vector", cfg, seed=0, device="cpu")
    assert made["column"] == pa.list_(pa.float32(), 8)  # dequantized view
    jmade = jcoder.make(root, "jc", "t", "vector", cfg, seed=0)
    np.testing.assert_allclose(made["tensor"], jmade["tensor"], rtol=0, atol=3.3e-7 * np.abs(jmade["tensor"]).max())
    index.make(root, "c", "t", "vector", device="cpu")
    jindex.make(root, "jc", "t", "vector")
    out = index.call(root, "c", "t", "vector", deq[5], metric="l2", maxval=3, probes=2, device="cpu")
    assert out.column("id").to_pylist()[0] == 5
    got, want = search_both(root, deq[[5, 400]], coding="jc", metric="l2", maxval=3, probes=2)
    assert_same_answer(got, want, deq, deq[[5, 400]], "l2")

    # an append with the TABLE's affine parameters, through the port: its
    # type as loaded (here the JAX package's registered class)
    extra = rng.standard_normal((32, 8)).astype(np.float32)
    like = types.typed_column(table.load(root, "t"), "vector").type
    new = types.quint8.QUInt8TensorArray.from_numpy(extra, like=like)
    table.append(root, "t", pa.table({"id": pa.array(np.arange(600, 632)), "vector": new}))
    index.extend_for_source(root, "t", pa.table({"id": pa.array(np.arange(600, 632)), "vector": new}), device="cpu")
    assert table.load(root, "t").num_rows == 632 and jtable.load(root, "t").num_rows == 632
    deq_new = new.dequantize().reshape(32, 8)
    out = index.call(root, "c", "t", "vector", deq_new[4], metric="l2", maxval=3, probes=4, device="cpu")
    assert out.column("id").to_pylist()[0] == 604
    got, want = search_both(root, deq_new[[4, 9]], metric="l2", maxval=4)
    assert_same_answer(got, want, np.concatenate([deq, deq_new]), deq_new[[4, 9]], "l2")


def test_extension_array_as_search_target(tmp_path, rng):
    root = str(tmp_path)
    vecs = rng.standard_normal((200, 8)).astype(np.float32)
    jtable.make(root, "t", pa.table({"id": pa.array(np.arange(200)),
                                     "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32())}).to_reader())
    for tensor_mod in (types.tensor, jtypes.tensor):
        t_target = tensor_mod.TensorArray.from_numpy(vecs[10:12])
        got, want = search_both(root, t_target, metric="l2", maxval=1)
        assert got.column("id").to_pylist() == [10, 11]
        assert_same_answer(got, want, vecs, vecs[10:12], "l2")
    # quint8 targets dequantize; the JAX package knows its own class only
    jq_target = jtypes.quint8.QUInt8TensorArray.from_numpy(vecs[33:34])
    got, want = search_both(root, jq_target, metric="l2", maxval=1)
    assert got.column("id").to_pylist() == [33]
    assert_same_answer(got, want, vecs, jq_target.dequantize(), "l2")
    q_target = types.quint8.QUInt8TensorArray.from_numpy(vecs[33:34])
    assert q_target.storage.equals(jq_target.storage)
    req = executor.SearchRequest("t", "vector", q_target, metric="l2", maxval=1)
    assert_same_answer(executor.execute_search(DeviceCache(root, device="cpu"), req), want, vecs,
                       q_target.dequantize(), "l2")
    # the unregistered form, as a wire table carries it
    got = executor.normalize_target(storage_form(q_target, "target"), 8)
    np.testing.assert_array_equal(got, q_target.dequantize())


def test_nested_projection_feeds_search(tmp_path, rng):
    text = rng.standard_normal((150, 8)).astype(np.float32)
    image = rng.standard_normal((150, 4)).astype(np.float32)
    col = types.nested.NestedTensorArray.from_numpy({"text": text, "image": image})
    root = str(tmp_path)
    table.make(root, "t", pa.table({"id": pa.array(np.arange(150)), "vector": col.to_field("text")}).to_reader())
    got, want = search_both(root, text[9], metric="cosine", maxval=3)
    assert got.column("id").to_pylist()[0] == 9
    assert_same_answer(got, want)
    # the whole nested column is no vector column, in either package
    table.make(root, "n", pa.table({"id": pa.array(np.arange(150)), "vector": col}).to_reader())
    with pytest.raises(AssertionError):
        executor.execute_search(DeviceCache(root, device="cpu"),
                                executor.SearchRequest("n", "vector", text[9], metric="cosine", maxval=3))


@pytest.mark.parametrize("kind", ["tensor", "quint8", "nested_leaf"])
def test_port_written_tables_read_as_jax_types(tmp_path, rng, kind):
    """A table the port wrote reads back in the JAX package as its own
    extension type, with equal search answers."""
    root = str(tmp_path)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    arr = {
        "tensor": lambda: types.tensor.from_numpy(vecs),
        "quint8": lambda: types.quint8.from_numpy(vecs),
        "nested_leaf": lambda: types.nested.from_numpy({"v": vecs, "w": vecs[:, :2]}).to_field("v"),
    }[kind]()
    table.make(root, "t", pa.table({"id": pa.array(np.arange(300)), "vector": arr}).to_reader())
    jcol = jtable.load(root, "t").column("vector").chunk(0)
    assert isinstance(jcol.type, jtypes.QUInt8TensorType if kind == "quint8" else jtypes.TensorType)
    matrix = jingest.fixed_size_list_to_numpy(jcol)
    targets = matrix[[1, 2, 250]] + 0.01
    got, want = search_both(root, targets, metric="l2", maxval=5, select=["id", "vector"])
    assert_same_answer(got, want, matrix, targets, "l2")


# -- the registration hazard, in fresh processes -----------------------------


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "HOME": os.environ.get("HOME", "/tmp")}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                          timeout=240, env=env, cwd=REPO)


@pytest.fixture
def jax_quint8_root(tmp_path, rng):
    root = str(tmp_path)
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    arr = jtypes.quint8.QUInt8TensorArray.from_numpy(vecs)
    jtable.make(root, "t", pa.table({"id": pa.array(np.arange(300)), "vector": arr}).to_reader())
    np.save(f"{root}/deq.npy", arr.dequantize().reshape(300, 8))
    return root


def test_port_imported_first_leaves_the_jax_package_dequantizing(jax_quint8_root):
    root = jax_quint8_root
    out = _fresh(f"""
        import numpy as np, pyarrow as pa
        import fenix_tpu_torch
        for name in ("fenix_tpu.tensor", "fenix_tpu.nested", "fenix_tpu.quint8"):
            try:
                pa.unregister_extension_type(name)
            except (KeyError, pa.ArrowKeyError):
                continue
            raise AssertionError(name + " registered by importing the port")
        import jax; jax.config.update("jax_platforms", "cpu")
        import fenix_tpu
        from fenix_tpu import index
        deq = np.load({root!r} + "/deq.npy")
        q = deq[7]
        out = index.call({root!r}, None, "t", "vector", q, metric="l2", maxval=3)
        oracle = np.argsort(((deq - q) ** 2).sum(1), kind="stable")[:3]
        ids = np.asarray(out.column("id"))
        assert ids.tolist() == oracle.tolist(), (ids, oracle)
        d = np.asarray(out.column("__DISTANCE__"))
        assert d.dtype == np.float32 and d[0] < 1e-5, d
        print("OK")
    """)
    assert out.returncode == 0 and "OK" in out.stdout, (out.stdout, out.stderr)


def test_port_alone_serves_a_jax_written_quint8_table(jax_quint8_root):
    root = jax_quint8_root
    out = _fresh(f"""
        import sys
        import numpy as np, pyarrow as pa
        from fenix_tpu_torch import index
        from fenix_tpu_torch.io import table
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "fenix_tpu" or m.startswith("fenix_tpu."))
        assert not bad, bad
        field = table.load({root!r}, "t").schema.field("vector")
        assert not isinstance(field.type, pa.ExtensionType), field  # the storage form
        assert field.metadata[b"ARROW:extension:name"] == b"fenix_tpu.quint8", field.metadata
        deq = np.load({root!r} + "/deq.npy")
        q = deq[7:9] + 0.01
        out = index.call({root!r}, None, "t", "vector", q, metric="l2", maxval=5, select=["id", "vector"],
                         device="cpu")
        d64 = ((deq.astype(np.float64)[None] - q.astype(np.float64)[:, None]) ** 2).sum(-1)
        oracle = np.argsort(d64, axis=1, kind="stable")[:, :5].reshape(-1)
        assert out.column("id").to_pylist() == oracle.tolist(), (out.column("id"), oracle)
        d = out.column("__DISTANCE__").to_numpy()
        assert d.dtype == np.float32
        np.testing.assert_allclose(d, np.sqrt(np.sort(d64, axis=1)[:, :5]).reshape(-1), rtol=1e-5, atol=1e-5)
        assert out.schema.field("vector").metadata[b"ARROW:extension:name"] == b"fenix_tpu.quint8"
        print("OK")
    """)
    assert out.returncode == 0 and "OK" in out.stdout, (out.stdout, out.stderr)
