"""Sparse aggregation ops vs dense ground truth (SURVEY.md §4.2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.graph import from_edges, to_dense
from graph_odenet_tpu.ops import (
    attention_aggregate,
    edge_scores,
    segment_softmax,
    segment_sum,
    spmm,
)


def random_graph(rng, n=50, p=0.1):
    a = rng.random((n, n)) < p
    s, r = np.nonzero(a)
    return from_edges(s, r, n_node=n, normalize="row")


def test_spmm_matches_dense():
    rng = np.random.default_rng(0)
    g = random_graph(rng)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, 13)), jnp.float32)
    sparse = spmm(g, x)
    dense = spmm(to_dense(g), x)
    np.testing.assert_allclose(np.asarray(sparse), np.asarray(dense), atol=1e-5)


def test_spmm_grad_matches_dense():
    rng = np.random.default_rng(1)
    g = random_graph(rng, n=20)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, 7)), jnp.float32)
    a = to_dense(g)
    f_sparse = lambda x: jnp.sum(jnp.sin(spmm(g, x)))
    f_dense = lambda x: jnp.sum(jnp.sin(spmm(a, x)))
    np.testing.assert_allclose(
        np.asarray(jax.grad(f_sparse)(x)),
        np.asarray(jax.grad(f_dense)(x)),
        atol=1e-5,
    )


def test_segment_softmax_rows_sum_to_one():
    rng = np.random.default_rng(2)
    g = random_graph(rng, n=30)
    logits = jnp.asarray(rng.standard_normal(g.n_edge_pad), jnp.float32)
    alpha = segment_softmax(
        logits, g.receivers, g.n_node_pad, mask=g.edge_mask()
    )
    sums = np.asarray(
        segment_sum(alpha, g.receivers, g.n_node_pad)
    )
    # Rows with at least one real incoming edge sum to 1 (every node has a
    # self loop here), padding rows to 0.
    np.testing.assert_allclose(sums[: g.n_node], 1.0, atol=1e-6)
    np.testing.assert_allclose(sums[g.n_node :], 0.0, atol=1e-6)


def test_attention_aggregate_matches_dense_masked_softmax():
    """The edge-list GAT sandwich equals the reference's dense −∞-masked
    softmax formulation (SURVEY.md §3.3)."""
    rng = np.random.default_rng(3)
    n, h, f = 12, 2, 5
    g = random_graph(rng, n=n)
    s_src = jnp.asarray(rng.standard_normal((g.n_node_pad, h)), jnp.float32)
    s_dst = jnp.asarray(rng.standard_normal((g.n_node_pad, h)), jnp.float32)
    values = jnp.asarray(
        rng.standard_normal((g.n_node_pad, h, f)), jnp.float32
    )

    logits = edge_scores(g, s_src, s_dst)
    out = attention_aggregate(g, logits, values)

    # Dense reference computation.
    adj = np.asarray(to_dense(g)) != 0  # [N,N] receiver-major
    se = np.asarray(s_src)[None, :, :] + np.asarray(s_dst)[:, None, :]  # [r,s,H]
    se = np.where(se > 0, se, 0.2 * se)
    se = np.where(adj[:, :, None], se, -np.inf)
    m = se.max(axis=1, keepdims=True)
    m[~np.isfinite(m)] = 0.0
    se = se - m
    num = np.exp(se)
    num[~adj] = 0.0
    alpha = num / np.maximum(num.sum(axis=1, keepdims=True), 1e-30)
    expected = np.einsum("rsh,shf->rhf", alpha, np.asarray(values))
    np.testing.assert_allclose(
        np.asarray(out)[: g.n_node], expected[: g.n_node], atol=1e-5
    )


def test_ops_jit_and_vmap_compose():
    rng = np.random.default_rng(4)
    g = random_graph(rng, n=16)
    xs = jnp.asarray(rng.standard_normal((3, g.n_node_pad, 6)), jnp.float32)
    batched = jax.jit(jax.vmap(lambda x: spmm(g, x)))(xs)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(batched[i]), np.asarray(spmm(g, xs[i])), atol=1e-6
        )


# --- spmm_segment against scipy.sparse (float64) --------------------------


def _scipy_case(rng, s, r, n, **kw):
    """Graph, float64 features and the scipy reference ``Â x``."""
    from graph_odenet_tpu.ops.reference import spmm_reference

    g = from_edges(s, r, n_node=n, **kw)
    x = rng.standard_normal((g.n_node_pad, 24))
    return g, x, spmm_reference


def test_spmm_segment_skewed_degrees_matches_scipy():
    """A hub receiving most edges next to degree-1 nodes."""
    from graph_odenet_tpu.ops.reference import rel_err
    from graph_odenet_tpu.ops.spmm import spmm_segment

    rng = np.random.default_rng(10)
    n = 300
    s = rng.integers(0, n, 3000)
    r = np.where(rng.random(3000) < 0.7, 7, rng.integers(0, n, 3000))
    g, x, ref = _scipy_case(rng, s, r, n, normalize="sym")
    got = spmm_segment(g, jnp.asarray(x, jnp.float32))
    assert rel_err(got, ref(g, x)) < 1e-5


def test_spmm_segment_empty_rows_match_scipy():
    """Rows with no incoming edge (no self loops) and padding rows are 0."""
    from graph_odenet_tpu.ops.spmm import spmm_segment

    rng = np.random.default_rng(11)
    n = 200
    s = rng.integers(0, n, 400)
    r = rng.integers(0, 50, 400)          # only rows < 50 receive
    g, x, ref = _scipy_case(
        rng, s, r, n, normalize="row", add_self_loops=False,
        symmetrize=False,
    )
    got = np.asarray(spmm_segment(g, jnp.asarray(x, jnp.float32)))
    np.testing.assert_array_equal(got[50:], 0.0)
    np.testing.assert_allclose(got, ref(g, x), atol=1e-5)


def test_spmm_segment_bf16_input_matches_scipy():
    """bf16 features aggregate in bf16: error within bf16's 8-bit mantissa
    of the float64 result of the same (rounded) inputs."""
    from graph_odenet_tpu.ops.reference import rel_err
    from graph_odenet_tpu.ops.spmm import spmm_segment

    rng = np.random.default_rng(12)
    n = 256
    g, x, ref = _scipy_case(
        rng, rng.integers(0, n, 2000), rng.integers(0, n, 2000), n,
        normalize="row",
    )
    xb = jnp.asarray(x, jnp.bfloat16)
    got = spmm_segment(g, xb)
    assert got.dtype == jnp.bfloat16
    assert rel_err(got, ref(g, np.asarray(xb, np.float64))) < 2e-2


def test_spmm_segment_grad_matches_scipy():
    """The vjp is Âᵀ·cotangent."""
    from graph_odenet_tpu.ops.reference import rel_err, spmm_vjp_reference
    from graph_odenet_tpu.ops.spmm import spmm_segment

    rng = np.random.default_rng(13)
    n = 300
    s = rng.integers(0, n, 3000)
    r = np.where(rng.random(3000) < 0.5, 3, rng.integers(0, n, 3000))
    g, x, _ = _scipy_case(rng, s, r, n, normalize="row")
    cot = rng.standard_normal(x.shape)
    _, vjp = jax.vjp(
        lambda v: spmm_segment(g, v), jnp.asarray(x, jnp.float32)
    )
    (dx,) = vjp(jnp.asarray(cot, jnp.float32))
    assert rel_err(dx, spmm_vjp_reference(g, cot)) < 1e-5


# --- counter-based attention dropout --------------------------------------


def test_dropmask_deterministic_and_rate():
    from graph_odenet_tpu.ops.dropmask import attention_dropout_scale

    rng = np.random.default_rng(3)
    s = jnp.asarray(rng.integers(0, 5000, 20_000), jnp.int32)
    r = jnp.asarray(rng.integers(0, 5000, 20_000), jnp.int32)
    m1 = attention_dropout_scale(jnp.uint32(42), s, r, 8, 0.6)
    m2 = attention_dropout_scale(jnp.uint32(42), s, r, 8, 0.6)
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    # Empirical keep rate ~ 1-rate (binomial; 160k draws, ±1%).
    keep = float(jnp.mean((m1 > 0).astype(jnp.float32)))
    assert abs(keep - 0.4) < 0.01, keep
    # Different seeds give different masks; kept entries carry 1/(1-rate).
    m3 = attention_dropout_scale(jnp.uint32(43), s, r, 8, 0.6)
    assert np.any(np.asarray(m1) != np.asarray(m3))
    vals = np.unique(np.asarray(m1))
    np.testing.assert_allclose(vals, [0.0, 1.0 / 0.4], rtol=1e-6)
