"""Edge-partitioned SpMM on the emulated 8-device mesh: bitwise-level parity
with the single-device path (SURVEY.md §4.5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.graph import from_edges
from graph_odenet_tpu.ops import spmm
from graph_odenet_tpu.parallel import (
    PartitionedGraph,
    make_mesh,
    partition_by_receiver,
    spmm_sharded,
)


pytestmark = pytest.mark.usefixtures("no_compile_cache")


def random_graph(rng, n=100, p=0.05):
    a = rng.random((n, n)) < p
    s, r = np.nonzero(a)
    return from_edges(s, r, n_node=n, normalize="row", node_multiple=8)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh(shape=(8,), axis_names=("edge",))


def test_partition_preserves_edges():
    rng = np.random.default_rng(0)
    g = random_graph(rng)
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    # Reconstruct the real edge set from buckets.
    sg = np.asarray(pg.senders_global())
    rr = np.asarray(pg.receivers_rel)
    w = np.asarray(pg.weight)
    got = set()
    for p in range(8):
        for b in range(8):
            for e in range(pg.e_bucket):
                if w[p, b, e] != 0.0:
                    got.add(
                        (int(sg[p, b, e]), int(rr[p, b, e] + p * pg.block_size))
                    )
    expect = set(
        zip(
            np.asarray(g.senders)[: g.n_edge].tolist(),
            np.asarray(g.receivers)[: g.n_edge].tolist(),
        )
    )
    assert got == expect


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_spmm_sharded_matches_single_device(mesh, mode):
    rng = np.random.default_rng(1)
    g = random_graph(rng)
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, 32)), jnp.float32)
    expected = spmm(g, x)
    got = spmm_sharded(pg, x, mesh, mode=mode)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), atol=1e-5)


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_spmm_sharded_under_jit_with_sharded_input(mesh, mode):
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(2)
    g = random_graph(rng, n=64)
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, 16)), jnp.float32)
    x_sharded = jax.device_put(x, NamedSharding(mesh, P("edge", None)))
    f = jax.jit(lambda x: spmm_sharded(pg, x, mesh, mode=mode))
    got = f(x_sharded)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(spmm(g, x)), atol=1e-5
    )


def test_spmm_sharded_grad(mesh):
    """Sharded aggregation stays differentiable end to end."""
    rng = np.random.default_rng(3)
    g = random_graph(rng, n=64)
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, 8)), jnp.float32)

    def loss_sharded(x):
        return jnp.sum(jnp.sin(spmm_sharded(pg, x, mesh, mode="allgather")))

    def loss_ref(x):
        return jnp.sum(jnp.sin(spmm(g, x)))

    np.testing.assert_allclose(
        np.asarray(jax.grad(loss_sharded)(x)),
        np.asarray(jax.grad(loss_ref)(x)),
        atol=1e-5,
    )


def test_gat_sharded_matches_single_device(mesh):
    """Ring-halo online-softmax attention == single-device sddmm path."""
    from graph_odenet_tpu.ops.sddmm import attention_aggregate, edge_scores
    from graph_odenet_tpu.parallel import gat_sharded

    rng = np.random.default_rng(3)
    n, heads, feat = 96, 2, 8
    a = rng.random((n, n)) < 0.08
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize=None, node_multiple=8)
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    s_src = jnp.asarray(rng.standard_normal((g.n_node_pad, heads)), jnp.float32)
    s_dst = jnp.asarray(rng.standard_normal((g.n_node_pad, heads)), jnp.float32)
    wh = jnp.asarray(
        rng.standard_normal((g.n_node_pad, heads, feat)), jnp.float32
    )
    expected = attention_aggregate(g, edge_scores(g, s_src, s_dst), wh)
    got = gat_sharded(pg, s_src, s_dst, wh, mesh)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expected), atol=1e-5, rtol=1e-5
    )


def test_gat_sharded_grad_matches_single_device(mesh):
    from graph_odenet_tpu.ops.sddmm import attention_aggregate, edge_scores
    from graph_odenet_tpu.parallel import gat_sharded

    rng = np.random.default_rng(4)
    n, heads, feat = 64, 2, 4
    a = rng.random((n, n)) < 0.1
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize=None, node_multiple=8)
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    s_src = jnp.asarray(rng.standard_normal((g.n_node_pad, heads)), jnp.float32)
    s_dst = jnp.asarray(rng.standard_normal((g.n_node_pad, heads)), jnp.float32)
    wh = jnp.asarray(
        rng.standard_normal((g.n_node_pad, heads, feat)), jnp.float32
    )

    def loss_sh(ss, sd, w):
        return jnp.sum(jnp.sin(gat_sharded(pg, ss, sd, w, mesh)))

    def loss_ref(ss, sd, w):
        return jnp.sum(jnp.sin(attention_aggregate(g, edge_scores(g, ss, sd), w)))

    gs = jax.grad(loss_sh, argnums=(0, 1, 2))(s_src, s_dst, wh)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(s_src, s_dst, wh)
    for a_, b_, name in zip(gs, gr, ("ds_src", "ds_dst", "dwh")):
        np.testing.assert_allclose(
            np.asarray(a_), np.asarray(b_), atol=2e-5, rtol=2e-5, err_msg=name
        )


def test_spmm_sharded_2d_mesh_data_by_edge():
    """DP × edge parallelism: a batch axis composed with the halo ring via
    jax.vmap(spmd_axis_name) on a (data=4, edge=2) mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(7)
    n = 96
    a = rng.random((n, n)) < 0.06
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize="row", node_multiple=8)
    mesh2d = make_mesh(shape=(4, 2), axis_names=("data", "edge"))
    pg = partition_by_receiver(g, 2, edge_multiple=8)
    xb = jnp.asarray(
        rng.standard_normal((8, g.n_node_pad, 16)), jnp.float32
    )
    xb = jax.device_put(xb, NamedSharding(mesh2d, P("data", "edge", None)))

    f = jax.jit(jax.vmap(
        lambda x: spmm_sharded(pg, x, mesh2d, mode="ring", check_vma=False),
        spmd_axis_name="data",
    ))
    got = f(xb)
    ref = jax.vmap(lambda x: spmm(g, x))(xb)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), atol=1e-5, rtol=1e-5
    )


def test_spmm_sharded_feature_tp():
    """2-D edge × feat mesh: feature-dimension tensor parallelism
    (SURVEY §2.2 T7 'TP over feature dim for wide layers') matches the
    single-device SpMM bitwise-tolerably."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from graph_odenet_tpu.graph import from_edges
    from graph_odenet_tpu.ops import spmm
    from graph_odenet_tpu.parallel import make_mesh, partition_by_receiver
    from graph_odenet_tpu.parallel.halo import spmm_sharded

    rng = np.random.default_rng(3)
    n, f = 64, 32
    a = rng.random((n, n)) < 0.3
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize="row", node_multiple=4)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, f)), jnp.float32)
    ref = spmm(g, x)

    mesh = make_mesh(shape=(4, 2), axis_names=("edge", "feat"))
    pg = partition_by_receiver(g, 4, edge_multiple=8)
    for mode in ("ring", "allgather"):
        out = jax.jit(
            lambda xx: spmm_sharded(
                pg, xx, mesh, mode=mode, feat_axis="feat"
            )
        )(x)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=1e-6, atol=1e-6
        )

    # Gradients flow through the 2-D sharding too.
    def loss(xx):
        return jnp.sum(
            spmm_sharded(pg, xx, mesh, mode="ring", feat_axis="feat") ** 2
        )

    gref = jax.grad(lambda xx: jnp.sum(spmm(g, xx) ** 2))(x)
    gout = jax.jit(jax.grad(loss))(x)
    np.testing.assert_allclose(
        np.asarray(gout), np.asarray(gref), rtol=1e-5, atol=1e-6
    )


# --- Dropout parity on the sharded path (VERDICT r2 #4) -------------------


def test_gat_sharded_attn_dropout_matches_counter_reference(mesh):
    """Sharded attention dropout == segment reference with the SAME
    counter-based mask (ops.dropmask keyed on global sender/receiver)."""
    from graph_odenet_tpu.ops.dropmask import attention_dropout_scale
    from graph_odenet_tpu.ops.sddmm import edge_scores
    from graph_odenet_tpu.ops.segment import gather, segment_softmax, segment_sum
    from graph_odenet_tpu.parallel import gat_sharded

    rng = np.random.default_rng(11)
    n, heads, feat = 96, 2, 8
    a = rng.random((n, n)) < 0.08
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize=None, node_multiple=8)
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    s_src = jnp.asarray(rng.standard_normal((g.n_node_pad, heads)), jnp.float32)
    s_dst = jnp.asarray(rng.standard_normal((g.n_node_pad, heads)), jnp.float32)
    wh = jnp.asarray(
        rng.standard_normal((g.n_node_pad, heads, feat)), jnp.float32
    )
    seed, rate = jnp.uint32(99), 0.5

    # Reference: segment softmax, counter mask on numerators only.
    logits = edge_scores(g, s_src, s_dst)
    alpha = segment_softmax(
        logits, g.receivers, g.n_node_pad, mask=g.edge_mask()[:, None]
    )
    d = attention_dropout_scale(seed, g.senders, g.receivers, heads, rate)
    msgs = gather(wh, g.senders) * (alpha * d)[..., None]
    expected = segment_sum(msgs, g.receivers, num_segments=g.n_node_pad)

    got = gat_sharded(
        pg, s_src, s_dst, wh, mesh, attn_rate=rate, attn_seed=seed
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expected), atol=1e-5, rtol=1e-5
    )


def test_gatode_forward_dropout_mesh_invariant(mesh):
    """The full training-mode sharded GAT-ODE forward (feature + attention
    dropout) must give identical results on 1-part and 8-part meshes."""
    from graph_odenet_tpu.parallel import sharded_gat
    from graph_odenet_tpu.parallel.mesh import make_mesh as mk

    rng = np.random.default_rng(12)
    n, f_in = 96, 12
    a = rng.random((n, n)) < 0.08
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize=None, node_multiple=8)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, f_in)), jnp.float32)
    params = sharded_gat.init_gatode_params(
        jax.random.PRNGKey(0), f_in, hidden=6, heads=2, n_class=5
    )
    key = jax.random.PRNGKey(7)

    outs = []
    for parts in (1, 8):
        pg = partition_by_receiver(g, parts, edge_multiple=8)
        m = mk(shape=(parts,), axis_names=("edge",),
               devices=jax.devices()[:parts])
        outs.append(np.asarray(sharded_gat.gatode_forward(
            params, pg, x, m, steps=2, dropout=0.4, rng=key
        )))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_gcn_forward_dropout_mesh_invariant(mesh):
    from graph_odenet_tpu.parallel import sharded_gcn
    from graph_odenet_tpu.parallel.mesh import make_mesh as mk

    rng = np.random.default_rng(13)
    n, f_in = 96, 10
    a = rng.random((n, n)) < 0.08
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize="row", node_multiple=8)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, f_in)), jnp.float32)
    params = sharded_gcn.init_params(
        jax.random.PRNGKey(0), f_in, hidden=8, n_class=4
    )
    key = jax.random.PRNGKey(3)
    outs = []
    for parts in (1, 8):
        pg = partition_by_receiver(g, parts, edge_multiple=8)
        m = mk(shape=(parts,), axis_names=("edge",),
               devices=jax.devices()[:parts])
        outs.append(np.asarray(sharded_gcn.forward(
            params, pg, x, m, steps=2, dropout=0.5, rng=key
        )))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_sharded_trainer_with_dropout_converges(mesh):
    """R7 recipe with its regularisation live on the mesh: loss falls and
    accuracy beats chance on a small twin."""
    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.parallel.trainer import (
        ShardedTrainConfig, fit_sharded_node_classifier,
    )

    data = synthetic_planetoid("cora", seed=0, scale=0.1)
    cfg = ShardedTrainConfig(
        model="gcnode", hidden=16, epochs=30, dropout=0.5,
        edge_multiple=8, eval_every=3,
    )
    res = fit_sharded_node_classifier(cfg, data)
    assert res["loss_final"] < res["loss_first"]
    assert res["test_acc"] > 0.3, res


def test_sharded_gatode_rejects_allgather(mesh):
    """The sharded GAT path is the ring alone; asking for another halo mode
    fails before any work."""
    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.parallel.trainer import (
        ShardedTrainConfig, fit_sharded_node_classifier,
    )

    data = synthetic_planetoid("cora", seed=0, scale=0.05)
    cfg = ShardedTrainConfig(model="gatode", mode="allgather", epochs=1,
                             edge_multiple=8)
    with pytest.raises(ValueError, match="ring"):
        fit_sharded_node_classifier(cfg, data)
