"""Segment-path graph attention (``ops.attention_aggregate``) against the
float64 numpy reference (``ops.reference``): forward, gradients and the
post-softmax dropout, over the (heads, features) shapes of the GAT models
and over graphs with hubs, empty rows and extreme logit spreads.

Tolerance: ``max|err| ≤ 1e-5·max|ref|``.  The op has no matrix product, so
its error is float32 accumulation alone; on these sizes that is ~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.graph import from_edges
from graph_odenet_tpu.ops import attention_aggregate
from graph_odenet_tpu.ops.dropmask import attention_dropout_scale, seed_from_key
from graph_odenet_tpu.ops.reference import (
    attention_reference, attention_vjp_reference, dropmask_reference, rel_err,
)

TOL = 1e-5
SHAPES = [(1, 128), (2, 16), (2, 96), (4, 16), (8, 8), (1, 125)]


def random_case(heads, feat, seed=0, n=300, p=0.03, graph=None, scale=2.0):
    rng = np.random.default_rng(seed)
    if graph is None:
        a = rng.random((n, n)) < p
        s, r = np.nonzero(a)
        graph = from_edges(s, r, n_node=n, normalize=None)
    g = graph
    logits = jnp.asarray(
        rng.standard_normal((g.n_edge_pad, heads)) * scale, jnp.float32
    )
    values = jnp.asarray(
        rng.standard_normal((g.n_node_pad, heads, feat)), jnp.float32
    )
    cot = jnp.asarray(
        rng.standard_normal((g.n_node_pad, heads, feat)), jnp.float32
    )
    return g, logits, values, cot


def check(g, logits, values, cot, rng_key=None, rate=0.0):
    """Forward and both gradients against the reference."""
    kw = {}
    drop = None
    if rng_key is not None:
        kw = dict(edge_dropout_rng=rng_key, edge_dropout_rate=rate)
        e = g.n_edge
        drop = dropmask_reference(
            int(seed_from_key(rng_key)), np.asarray(g.senders)[:e],
            np.asarray(g.receivers)[:e], logits.shape[1], rate,
        )
    out, vjp = jax.vjp(
        lambda lg, v: attention_aggregate(g, lg, v, **kw), logits, values
    )
    dlogits, dvalues = vjp(cot)
    ref = attention_reference(g, logits, values, drop)
    rdl, rdv = attention_vjp_reference(g, logits, values, cot, drop)
    assert rel_err(out, ref) < TOL
    assert rel_err(dlogits, rdl) < TOL
    assert rel_err(dvalues, rdv) < TOL
    # Padding edges take no part: zero gradient.
    np.testing.assert_array_equal(np.asarray(dlogits)[g.n_edge:], 0.0)


@pytest.mark.parametrize("heads,feat", SHAPES)
def test_forward_matches_reference(heads, feat):
    g, logits, values, _ = random_case(heads, feat, seed=1)
    out = attention_aggregate(g, logits, values)
    assert out.shape == values.shape and out.dtype == jnp.float32
    assert rel_err(out, attention_reference(g, logits, values)) < TOL


@pytest.mark.parametrize("heads,feat", SHAPES)
def test_grads_match_reference(heads, feat):
    check(*random_case(heads, feat, seed=2))


@pytest.mark.parametrize("heads,feat", SHAPES)
def test_dropout_matches_reference(heads, feat):
    """Dropout 0.6, the GAT recipe's rate, on the post-softmax weights."""
    check(*random_case(heads, feat, seed=3), rng_key=jax.random.PRNGKey(4),
          rate=0.6)


def _hub_receiver():
    rng = np.random.default_rng(7)
    n = 200
    s = np.concatenate([rng.integers(0, n, 2500), rng.integers(0, n, 400)])
    r = np.concatenate([np.full(2500, 150), rng.integers(0, n, 400)])
    return from_edges(s, r, n_node=n, normalize=None, symmetrize=False)


def _hub_sender():
    rng = np.random.default_rng(8)
    n = 200
    s = np.concatenate([np.full(2500, 9), rng.integers(0, n, 400)])
    r = np.concatenate([rng.integers(0, n, 2500), rng.integers(0, n, 400)])
    return from_edges(s, r, n_node=n, normalize=None, symmetrize=False)


def _empty_block():
    """Rows 128–255 receive nothing (no self loops), and rows past 300
    are padding."""
    rng = np.random.default_rng(9)
    n = 300
    s = rng.integers(0, n, 1500)
    r = rng.integers(0, 128, 1500)
    return from_edges(s, r, n_node=n, normalize=None, add_self_loops=False,
                      symmetrize=False)


CASES = {
    "hub_receiver": lambda: random_case(2, 16, graph=_hub_receiver()),
    "hub_sender": lambda: random_case(2, 16, graph=_hub_sender()),
    "empty_block": lambda: random_case(8, 8, graph=_empty_block()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_graph_cases_match_reference(name):
    g, logits, values, cot = CASES[name]()
    check(g, logits, values, cot)
    check(g, logits, values, cot, rng_key=jax.random.PRNGKey(5), rate=0.6)
    if name == "empty_block":
        out = np.asarray(attention_aggregate(g, logits, values))
        np.testing.assert_array_equal(out[128:], 0.0)


def test_extreme_negative_spread_matches_reference():
    """Receivers whose logits sit ~300 below, or ~200 above, the rest keep
    their softmax: the per-receiver shift handles any offset."""
    g, logits, values, cot = random_case(8, 8, seed=3)
    rng = np.random.default_rng(4)
    rcv = np.asarray(g.receivers)
    lg = np.array(logits)
    low, high = np.isin(rcv, [5, 17]), rcv == 40
    lg[low] = -300.0 + rng.standard_normal((int(low.sum()), 8))
    lg[high] = 200.0 + rng.standard_normal((int(high.sum()), 8))
    check(g, jnp.asarray(lg), values, cot)


def test_dropmask_matches_numpy_hash():
    """``ops.dropmask`` and the reference's numpy uint32 hash agree bit for
    bit, for several rates and seeds."""
    rng = np.random.default_rng(6)
    s = rng.integers(0, 169_343, 50_000)
    r = rng.integers(0, 169_343, 50_000)
    for seed, rate, heads in [(0, 0.6, 8), (2**32 - 1, 0.5, 1), (12345, 0.1, 3)]:
        got = attention_dropout_scale(
            jnp.uint32(seed), jnp.asarray(s, jnp.int32),
            jnp.asarray(r, jnp.int32), heads, rate,
        )
        np.testing.assert_array_equal(
            np.asarray(got, np.float64),
            dropmask_reference(seed, s, r, heads, rate).astype(np.float32),
        )


def test_dropout_off_is_identity():
    """No key, or rate 0, leaves the softmax weights untouched."""
    g, logits, values, _ = random_case(2, 16, seed=5)
    plain = attention_aggregate(g, logits, values)
    for kw in (dict(edge_dropout_rate=0.6),
               dict(edge_dropout_rng=jax.random.PRNGKey(0))):
        np.testing.assert_array_equal(
            np.asarray(attention_aggregate(g, logits, values, **kw)),
            np.asarray(plain),
        )

