"""fenix_tpu_torch.ops (topk2 + the phase-1 kernel's plain twin) against
the JAX package's fenix_tpu.ops.topk2 on the same numpy inputs.

Tolerances: elementwise ops rtol 1e-6; int8 codes equal except where the
scaled value sits within 1 ulp of a half-integer (XLA folds /127 into a
reciprocal multiply); phase-1 maxima rtol/atol 1e-5 against fp32 JAX
(bf16: see the test); search ids exact and distances within 1e-5.
The JAX Pallas kernel runs in interpret mode, as its own tests run it.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenix_tpu.ops import topk2 as jtopk2
from fenix_tpu_torch.ops import kernels
from fenix_tpu_torch.ops import topk2
from tests.test_topk_adversarial import N as ADV_N
from tests.test_topk_adversarial import _tied_levels_corpus

torch.set_num_threads(2)

METRICS = ["cosine", "dot", "inner_product", "l2", "euclidean"]


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def build(rng, n, d, q):
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal((q, d)).astype(np.float32),
    )


# -- metric preparation and quantization ---------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_prepare_queries_and_aux_match_jax(rng, metric):
    corpus, queries = build(rng, 1024, 32, 7)
    mask = rng.random(1024) < 0.7
    got_q = topk2.prepare_queries(t(queries), metric).numpy()
    want_q = np.asarray(jtopk2.prepare_queries(jnp.asarray(queries), metric))
    np.testing.assert_allclose(got_q, want_q, rtol=1e-6, atol=1e-7)

    got_m, got_a = topk2.prepare_aux(t(corpus), t(mask), metric)
    want_m, want_a = jtopk2.prepare_aux(jnp.asarray(corpus), jnp.asarray(mask), metric)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6)
    assert np.isneginf(got_a.numpy()[~mask]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_scores_to_distances_matches_jax(rng, metric):
    queries = rng.standard_normal((5, 16)).astype(np.float32)
    scores = rng.standard_normal((5, 9)).astype(np.float32)
    if topk2.canonical_metric(metric) == "l2":
        scores -= 40.0  # uu - s stays positive, as real l2 scores do
    got = topk2.scores_to_distances(t(scores), t(queries), metric).numpy()
    want = np.asarray(jtopk2.scores_to_distances(jnp.asarray(scores), jnp.asarray(queries), metric))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _assert_codes_match(got8, want8, values, scale):
    """int8 codes equal, except where value/scale sits within 1 ulp of a
    half-integer, where a 1-ulp scale difference may round either way."""
    diff = got8.astype(np.int32) != want8.astype(np.int32)
    if diff.any():
        x = values / scale[:, None]
        frac = np.abs(np.abs(x - np.trunc(x)) - 0.5)
        near_half = frac <= 4 * np.spacing(np.abs(x).astype(np.float32))
        assert near_half[diff].all()
        assert (np.abs(got8.astype(np.int32) - want8.astype(np.int32))[diff] == 1).all()


def test_quantize_int8_matches_jax(rng):
    corpus = rng.standard_normal((4096, 64)).astype(np.float32) * 3
    corpus[5] = 0.0  # zero rows quantize to zeros
    v8, sv = topk2.quantize_corpus_int8(t(corpus))
    jv8, jsv = jtopk2.quantize_corpus_int8(jnp.asarray(corpus))
    np.testing.assert_allclose(sv.numpy(), np.asarray(jsv), rtol=1e-6)
    _assert_codes_match(v8.numpy(), np.asarray(jv8), corpus, sv.numpy())
    assert (v8.numpy()[5] == 0).all() and v8.dtype == torch.int8

    qp = rng.standard_normal((33, 64)).astype(np.float32)
    q8, inv_sq = topk2.quantize_queries_int8(t(qp))
    jq8, jinv = jtopk2.quantize_queries_int8(jnp.asarray(qp))
    np.testing.assert_allclose(inv_sq.numpy(), np.asarray(jinv), rtol=1e-6)
    _assert_codes_match(q8.numpy(), np.asarray(jq8), qp, 1.0 / inv_sq.numpy())


def test_quantize_corpus_chunks_match_one_pass(rng, monkeypatch):
    corpus = t(rng.standard_normal((1000, 16)).astype(np.float32))
    whole = topk2.quantize_corpus_int8(corpus)
    monkeypatch.setattr(topk2, "_QUANTIZE_CHUNK_ROWS", 96)
    chunked = topk2.quantize_corpus_int8(corpus)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_bucket_for_matches_jax():
    for q in (1, 8, 33, 64, 65, 100, 256, 1024):
        for n in (16384, 4096, 96, 8, 3):
            assert topk2.bucket_for(q, n) == jtopk2.bucket_for(q, n), (q, n)


# -- phase 1: the plain twin of the CUDA kernel ---------------------------------


@pytest.mark.parametrize("bucket", [128, 32])
def test_plain_phase1_matches_xla(rng, bucket):
    corpus, queries = build(rng, 4096, 64, 16)
    aux_mul, aux_add = jtopk2.prepare_aux(jnp.asarray(corpus), None, "cosine")
    qp = jtopk2.prepare_queries(jnp.asarray(queries), "cosine")
    want = np.asarray(jtopk2.bucket_scores_xla(qp, jnp.asarray(corpus), aux_mul, aux_add, bucket))
    got = kernels.bucket_scores(t(qp), t(corpus), t(aux_mul), t(aux_add), bucket)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_phase1_bf16_matches_xla(rng):
    """JAX's bf16 phase 1 accumulates and stores bf16 (8 significant
    bits); the port widens the same bf16 inputs to f32. They agree to bf16
    rounding of the dot: 2^-7 relative of |q|·|v|."""
    corpus, queries = build(rng, 2048, 32, 8)
    c16 = jnp.asarray(corpus, jnp.bfloat16)
    q16 = jnp.asarray(queries, jnp.bfloat16)
    ones, zeros = jnp.ones(2048, jnp.float32), jnp.zeros(2048, jnp.float32)
    want = np.asarray(jtopk2.bucket_scores_xla(q16, c16, ones, zeros, 128))
    got = kernels.bucket_scores(
        t(q16.astype(jnp.float32)).to(torch.bfloat16),
        t(c16.astype(jnp.float32)).to(torch.bfloat16),
        t(ones), t(zeros), 128,
    ).numpy()
    bound = 2.0**-7 * np.linalg.norm(queries, axis=1)[:, None] * np.linalg.norm(corpus, axis=1).max()
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize(
    "dtype,bucket,metric,qt",
    [("f32", 128, "l2", 256), ("f32", 32, "cosine", 256), ("bf16", 32, "dot", 256),
     ("bf16", 32, "dot", 8), ("bf16", 128, "cosine", 64)],
    ids=["f32-128-l2", "f32-32-cosine", "bf16-32-dot", "bf16-32-dot-q8", "bf16-128-cosine-q64"],
)
def test_plain_phase1_matches_pallas_interpret(rng, dtype, bucket, metric, qt):
    """The JAX Pallas kernel (interpret mode) against the port's phase 1 on
    the same inputs: the f32 body, and the bf16 body at the query counts
    the port sends to ``tensor_bf16`` (on the card; its plain version
    here). The kernel tiles 256 queries, so a smaller batch is padded with
    zero queries and its first rows compared. Both sides sum exact bf16
    products in f32: rtol/atol 1e-5."""
    n, d = 2048, 128
    corpus, queries = build(rng, n, d, qt)
    aux_mul, aux_add = jtopk2.prepare_aux(jnp.asarray(corpus), None, metric)
    qp = jtopk2.prepare_queries(jnp.asarray(queries), metric)
    c, q = jnp.asarray(corpus), qp
    if dtype == "bf16":
        c, q = c.astype(jnp.bfloat16), q.astype(jnp.bfloat16)
    q_tiled = jnp.pad(q, ((0, -qt % 256), (0, 0)))
    want = np.asarray(
        jtopk2.bucket_scores_pallas_bigq(q_tiled, c, aux_mul, aux_add, interpret=True, bucket=bucket)
    )[:qt]
    tq, tc = t(q.astype(jnp.float32)), t(c.astype(jnp.float32))
    if dtype == "bf16":
        tq, tc = tq.to(torch.bfloat16), tc.to(torch.bfloat16)
        assert kernels.kernel_for(torch.bfloat16, qt, d) == "tensor_bf16"
    got = kernels.bucket_scores(tq, tc, t(aux_mul), t(aux_add), bucket).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_phase1_int8_matches_pallas_interpret_and_scan(rng):
    n, d, qt = 2048, 128, 256
    corpus, queries = build(rng, n, d, qt)
    aux_mul, aux_add = jtopk2.prepare_aux(jnp.asarray(corpus), None, "l2")
    v8, sv = jtopk2.quantize_corpus_int8(jnp.asarray(corpus))
    q8, inv_sq = jtopk2.quantize_queries_int8(jtopk2.prepare_queries(jnp.asarray(queries), "l2"))
    ams = aux_mul * sv
    got = kernels.bucket_scores(t(q8), t(v8), t(ams), t(aux_add), 32, inv_sq=t(inv_sq)).numpy()
    want = np.asarray(
        jtopk2.bucket_scores_pallas_bigq(q8, v8, ams, aux_add, inv_sq=inv_sq, interpret=True, bucket=32)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the small-Q XLA int8 form (JAX's one-shot dot) agrees too
    small = np.asarray(jtopk2.bucket_scores_scan_int8(q8[:8], v8, ams, aux_add, inv_sq[:8], 128))
    got_small = kernels.bucket_scores(t(q8[:8]), t(v8), t(ams), t(aux_add), 128, inv_sq=t(inv_sq[:8]))
    np.testing.assert_allclose(got_small.numpy(), small, rtol=1e-5, atol=1e-5)


def test_plain_phase1_edges(rng):
    """-inf rows give -inf buckets, never NaN; zero int8 queries carry
    inv_sq = 1e30 and must not turn -inf into NaN either."""
    corpus, queries = build(rng, 1024, 16, 4)
    queries[3] = 0.0
    aux_add = np.zeros(1024, np.float32)
    aux_add[:256] = -np.inf
    aux_add[300:310] = -1e30
    v8, sv = topk2.quantize_corpus_int8(t(corpus))
    q8, inv_sq = topk2.quantize_queries_int8(t(queries))
    assert float(inv_sq[3]) == pytest.approx(1e30)
    out = kernels.bucket_scores(q8, v8, sv, t(aux_add), 128, inv_sq=inv_sq)
    assert not torch.isnan(out).any()
    assert torch.isneginf(out[:, :2]).all()
    out32 = kernels.bucket_scores(t(queries), t(corpus), torch.ones(1024), t(aux_add), 32)
    assert not torch.isnan(out32).any() and torch.isneginf(out32[:, :8]).all()


@pytest.mark.parametrize(
    "dtype,q,d,design",
    [(torch.float32, q, d, "stream") for d in (128, 100) for q in (1, 8, 9, 32, 33, 64)]
    + [(torch.float32, q, d, "tiled") for d in (128, 100) for q in (65, 128, 1024)]
    + [(torch.bfloat16, q, d, "tensor_bf16") for d in (96, 128, 768) for q in (1, 8, 16, 32, 33, 64, 256, 1024)]
    + [(torch.bfloat16, q, d, "generic_bf16") for d in (25, 100, 130) for q in (1, 16, 32, 33, 64, 1024)]
    + [(torch.int8, q, d, "tensor_int8") for d in (128, 768) for q in (1, 8, 256, 1024)]
    + [(torch.int8, q, d, "generic_int8") for d in (25, 100, 130, 301) for q in (1, 8, 256, 1024)],
)
def test_kernel_for_picks_by_dtype_and_q(dtype, q, d, design):
    """The dispatcher: int8 and bf16 rows go to the tensor cores at every Q
    and D: rows of a multiple of 16 bytes (int8 D % 16 == 0, bf16 D % 8 ==
    0) to the TMA-fed designs, every other width to the generic ones; f32
    rows stream up to the measured threshold (64 queries), tiled above."""
    assert kernels.STREAM_MAX_Q == 64
    assert kernels.kernel_for(dtype, q, d) == design


@pytest.mark.parametrize("design", [None, "stream", "tiled", "tensor_int8", "generic_int8", "tensor_bf16",
                                    "generic_bf16"])
@pytest.mark.parametrize("scan", ["f32", "bf16", "int8"])
def test_wrapper_counts_only_kernel_launches(rng, scan, design):
    """On CPU tensors the wrapper runs the plain version (bit-equal) for
    every scan type, whatever design is forced, and counts no launch under
    a route or a design; a device it has no kernel for raises."""
    corpus, queries = build(rng, 512, 16, 3)
    v, q, isq = t(corpus), t(queries), None
    mul, add = torch.ones(512), torch.zeros(512)
    if scan == "bf16":
        v, q = v.to(torch.bfloat16), q.to(torch.bfloat16)
    elif scan == "int8":
        v, sv = topk2.quantize_corpus_int8(v)
        q, isq = topk2.quantize_queries_int8(q)
        mul = sv
    before = dict(kernels.LAUNCHES)
    got = kernels.bucket_scores(q, v, mul, add, 32, inv_sq=isq, _kernel=design)
    assert torch.equal(got, kernels.bucket_scores_plain(q, v, mul, add, 32, isq))
    assert kernels.LAUNCHES == before
    designs = ("stream", "tiled", "tensor_int8", "generic_int8", "tensor_bf16", "generic_bf16")
    assert {f"bucket_scores.kernel.{k}" for k in designs} <= set(before)
    args = (q, v, mul, add, 32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.bucket_scores(*(a.to("meta") if torch.is_tensor(a) else a for a in args), inv_sq=isq)


def test_build_dir_in_checkout_and_installed(tmp_path, monkeypatch):
    """A source checkout builds under its own build/; an installed
    package builds in the user cache; the variable overrides both."""
    monkeypatch.delenv("FENIX_TORCH_BUILD_DIR", raising=False)
    repo = Path(kernels.__file__).resolve().parents[2]
    assert kernels.build_dir() == repo / "build" / "fenix_tpu_torch"
    site = tmp_path / "site-packages" / "fenix_tpu_torch" / "ops" / "kernels.py"
    monkeypatch.setattr(kernels, "__file__", str(site))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert kernels.build_dir() == tmp_path / "cache" / "fenix_tpu_torch"
    monkeypatch.setenv("FENIX_TORCH_BUILD_DIR", str(tmp_path / "elsewhere"))
    assert kernels.library_path().parent == tmp_path / "elsewhere"


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["auto", "stream", "tiled", "tensor_int8", "generic_int8", "tensor_bf16",
                                    "generic_bf16"])
def test_kernel_matches_plain_on_card(design):
    """The CUDA kernels against their plain version, on the card: each
    design forced ("auto": the dispatcher's pick for every scan type) over
    ragged Q (int8 and bf16 also past the 128- and 256-query tiles), D not
    a multiple of 16 bytes (the TMA-fed tensor-core designs take only D
    that is; 25 and 301 not even of 4 bytes of int8), buckets 1..128, N not
    a multiple of the 128-row tile where the bucket allows, -inf rows and
    whole -inf buckets. Runs where a CUDA card is present. Tolerance rtol
    1e-5, atol 1e-3 at D=128, atol growing with D (|q|·|v| ~ D)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    forced = None if design == "auto" else design
    int8_only = design in ("tensor_int8", "generic_int8")
    for d in (25, 96, 100, 128, 130, 301, 768):
        if design == "tensor_int8" and d % 16 or design == "tensor_bf16" and d % 8:
            continue
        for bucket in (1, 2, 32, 128):
            n = 16_384 + (96 if bucket <= 32 else 128)
            v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
            mul = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).cuda()
            add = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
            add[::7] = float("-inf")
            add[: 2 * bucket] = float("-inf")
            v8, sv = topk2.quantize_corpus_int8(v)
            for qn in (1, 2, 7, 8, 9, 16, 17, 32, 33, 64, 65, 100, 200, 257, 1024):
                q = torch.from_numpy(rng.standard_normal((qn, d), dtype=np.float32)).cuda()
                cases = []
                if forced in (None, "stream", "tiled"):  # the f32 designs
                    cases.append((q, v, mul, add, bucket, None))
                if forced is None or forced in ("tensor_bf16", "generic_bf16"):
                    cases.append((q.bfloat16(), v.bfloat16(), mul, add, bucket, None))
                if forced is None or int8_only:
                    q8, inv_sq = topk2.quantize_queries_int8(q)
                    cases.append((q8, v8, mul * sv, add, bucket, inv_sq))
                for args in cases:
                    got = kernels.bucket_scores(*args[:5], inv_sq=args[5], _kernel=forced)
                    want = kernels.bucket_scores_plain(*args)
                    assert not torch.isnan(got).any()
                    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
                    assert torch.isneginf(got[:, :2]).all()
                    fin = torch.isfinite(want)
                    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-3 * max(1.0, d / 128))


# -- bucket selection ---------------------------------------------------------


def test_topk_buckets_matches_jax_with_ties(rng):
    """Flat selection picks the set the JAX hierarchies pick, including
    under heavy ties (stable → smallest bucket id), in ascending order."""
    cases = [
        (rng.integers(0, 7, (16, 4096)).astype(np.float32), 4),  # hierarchical in JAX
        (rng.standard_normal((4, 256)).astype(np.float32), 8),  # flat in JAX
        (rng.standard_normal((8, 8 * 128 + 96)).astype(np.float32), 4),  # padded groups
    ]
    cases[0][0][0, :] = 3.0  # one row all ties
    cases[0][0][1, -4:] = 100.0  # winners at the very end
    for bm, kp in cases:
        got = topk2.topk_buckets(t(bm), kp).numpy()
        assert (np.diff(got, axis=1) > 0).all()
        want = np.sort(np.asarray(jtopk2.topk_buckets(jnp.asarray(bm), kp)), axis=1)
        want_nbq = np.sort(np.asarray(jtopk2.topk_buckets_nbq(jnp.asarray(bm.T), kp)), axis=1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, want_nbq)


def test_topk_buckets_all_masked_keeps_lowest():
    bm = np.full((2, 64), -np.inf, np.float32)
    bm[1, 40] = 1.0
    got = topk2.topk_buckets(t(bm), 3).numpy()
    np.testing.assert_array_equal(got, [[0, 1, 2], [0, 1, 40]])


# -- two-phase search ----------------------------------------------------------


def _both(corpus, queries, k, metric, scan="fp32", mask=None):
    aux_mul, aux_add = jtopk2.prepare_aux(
        jnp.asarray(corpus), None if mask is None else jnp.asarray(mask), metric
    )
    jkw, v8, sv = {}, None, None
    if scan == "bf16":
        jkw["corpus_scan"] = jnp.asarray(corpus, jnp.bfloat16)
    elif scan == "int8":
        v8, sv = jtopk2.quantize_corpus_int8(jnp.asarray(corpus))
        jkw["corpus_scan_int8"] = (v8, sv)
    jd, ji = jtopk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=k, metric=metric, **jkw
    )
    c, m, a, scan_int8 = topk2.state_from_numpy(
        np.asarray(corpus), np.asarray(aux_mul), np.asarray(aux_add),
        None if v8 is None else np.asarray(v8), None if sv is None else np.asarray(sv),
        device="cpu",
    )
    tkw = {}
    if scan == "bf16":
        tkw["corpus_scan"] = c.to(torch.bfloat16)
    elif scan == "int8":
        tkw["corpus_scan_int8"] = scan_int8
    td, ti = topk2.topk_two_phase(c, t(queries), m, a, k=k, metric=metric, **tkw)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


def _assert_same(jax_out, torch_out):
    (jd, ji), (td, ti) = jax_out, torch_out
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


TWO_PHASE_CASES = (
    [(m, "fp32", 8) for m in METRICS]
    + [(m, s, 8) for s in ("bf16", "int8") for m in ("l2", "cosine", "dot")]
    + [("cosine", "fp32", q) for q in (1, 33, 100, 256)]
    + [("l2", "int8", q) for q in (33, 256)]
    + [("euclidean", "bf16", 100)]
)


@pytest.mark.parametrize("metric,scan,q", TWO_PHASE_CASES)
def test_two_phase_matches_jax(rng, metric, scan, q):
    corpus, queries = build(rng, 4096, 32, q)
    _assert_same(*_both(corpus, queries, 10, metric, scan))


@pytest.mark.parametrize("scan", ["bf16", "int8"])
@pytest.mark.parametrize("q", [8, 100])
def test_two_phase_narrow_rows_match_jax(rng, scan, q):
    """A 100-wide table, GloVe-100's width: 100 bf16 or int8 values are not
    a multiple of 16 bytes, so on the card the generic designs scan it.
    Both packages' two-phase search, cosine: ids exact, distances within
    1e-5."""
    corpus, queries = build(rng, 4096, 100, q)
    assert kernels.kernel_for({"bf16": torch.bfloat16, "int8": torch.int8}[scan], q, 100) == f"generic_{scan}"
    _assert_same(*_both(corpus, queries, 10, "cosine", scan))


def test_two_phase_respects_mask_like_jax(rng):
    corpus, queries = build(rng, 2048, 16, 3)
    mask = rng.random(2048) < 0.2
    jax_out, torch_out = _both(corpus, queries, 8, "l2", mask=mask)
    _assert_same(jax_out, torch_out)
    assert mask[torch_out[1]].all()


def test_two_phase_fewer_valid_than_k(rng):
    corpus, queries = build(rng, 1024, 16, 2)
    mask = np.zeros(1024, bool)
    mask[:3] = True
    jax_out, (td, ti) = _both(corpus, queries, 10, "dot", mask=mask)
    _assert_same(jax_out, (td, ti))
    assert ((ti >= 0).sum(axis=1) == 3).all() and np.isinf(td[ti < 0]).all()


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("scan", ["fp32", "bf16", "int8"])
def test_tied_mass_matches_jax(rng, metric, scan):
    """Exact duplicates tied across far more buckets than the candidate
    window: both packages must return the smallest ids."""
    corpus, query = _tied_levels_corpus(rng, metric)
    _assert_same(*_both(corpus, query[None, :], 16, metric, scan))


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("q", [4, 256])
def test_near_tied_maxima_match_jax(rng, metric, q):
    """Bucket maxima ~3e-6 apart with the true order reversed against
    bucket order (tests/test_topk_adversarial.py's corpus)."""
    d = 32
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    corpus = (rng.standard_normal((ADV_N, d)) * 0.05).astype(np.float32)
    ids = np.sort(rng.choice(ADV_N, size=64, replace=False))
    scale = 2.0 * (1.0 - np.arange(64)[::-1] * 3e-6)
    corpus[ids] = (scale[:, None] * u[None, :]).astype(np.float32)
    queries = np.tile(u.astype(np.float32)[None, :], (q, 1))
    queries *= 1.0 + np.arange(q, dtype=np.float32)[:, None] * 1e-3
    _assert_same(*_both(corpus, queries, 16, metric))


def test_k3_bucket_scores_pallas_matches_the_port(rng):
    """K3, the round-1 fp32 phase-1 Pallas kernel (``bucket_scores_pallas``,
    1024-row blocks, 128-row bucket maxima), in interpret mode against the
    port's phase-1 wrapper at bucket 128 — the K1 kernel on the card, its
    plain version here. rtol 1e-5, atol 1e-6 (as tests/test_topk2.py holds
    K3 against XLA)."""
    from jax.experimental.pallas import tpu as pltpu

    n, d, qt = 4096, 64, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((qt, d)).astype(np.float32)
    mask = rng.random(n) < 0.9
    mul, add = (np.asarray(a) for a in jtopk2.prepare_aux(jnp.asarray(corpus), jnp.asarray(mask), "cosine"))
    qp = np.asarray(jtopk2.prepare_queries(jnp.asarray(queries), "cosine"))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jtopk2.bucket_scores_pallas(qp, corpus, mul, add, 1024))
    got = kernels.bucket_scores(t(qp), t(corpus), t(mul), t(add), 128).numpy()
    assert got.shape == want.shape == (qt, n // 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
