"""Model zoo: init/forward shapes, log-prob validity, parameter trees,
init determinism, gradient flow, and the dense-Â vs sparse-Graph
equivalence for the GCN family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.graph import from_edges, to_dense
from graph_odenet_tpu.models import (
    GAT,
    GCN,
    GATODE,
    GCNODE,
    INODE,
    InteractionNetwork,
    ResGAT,
    ResGCN,
)

N, F, C = 20, 12, 3


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    a = rng.random((N, N)) < 0.2
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=N, normalize="row")
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, F)), jnp.float32)
    return g, x


MODELS = {
    "gcn": lambda: GCN(hidden=8, n_class=C),
    "resgcn": lambda: ResGCN(hidden=8, n_class=C, n_blocks=2),
    "gcnode_rk4": lambda: GCNODE(hidden=8, n_class=C, method="rk4", steps=4),
    "gcnode_dopri": lambda: GCNODE(
        hidden=8, n_class=C, method="dopri5_scan", steps=16
    ),
    "gcnode_adjoint": lambda: GCNODE(
        hidden=8, n_class=C, method="dopri5", adjoint=True
    ),
    "gat": lambda: GAT(hidden=4, heads=2, n_class=C),
    "resgat": lambda: ResGAT(hidden=4, heads=2, n_class=C, n_blocks=1),
    "gatode": lambda: GATODE(hidden=4, heads=2, n_class=C, method="rk4", steps=2),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_shape_and_logprobs(setup, name):
    g, x = setup
    model = MODELS[name]()
    params = model.init(jax.random.PRNGKey(0), g, x)
    out, stats = model.apply(params, g, x)
    assert out.shape == (g.n_node_pad, C)
    # Continuous models report their solver's evaluations; discrete none.
    assert ("nfe" in stats) == name.startswith(("gcnode", "gatode"))
    np.testing.assert_allclose(
        np.asarray(jnp.exp(out).sum(-1))[: g.n_node], 1.0, atol=1e-5
    )
    assert np.all(np.isfinite(np.asarray(out)[: g.n_node]))


@pytest.mark.parametrize(
    "name",
    ["gcn", "resgcn", "gcnode_rk4", "gcnode_adjoint", "gat", "resgat",
     "gatode"],
)
def test_gradients_flow(setup, name):
    g, x = setup
    model = MODELS[name]()
    params = model.init(jax.random.PRNGKey(0), g, x)

    def loss(p):
        return -jnp.mean(model.apply(p, g, x)[0][: N, 0])

    grads = jax.grad(loss)(params)
    norms = [float(jnp.abs(l).max()) for l in jax.tree_util.tree_leaves(grads)]
    assert all(np.isfinite(norms))
    assert max(norms) > 0.0


def test_gcn_dense_equals_sparse(setup):
    g, x = setup
    model = GCN(hidden=8, n_class=C)
    params = model.init(jax.random.PRNGKey(0), g, x)
    out_sparse, _ = model.apply(params, g, x)
    out_dense, _ = model.apply(params, to_dense(g), x)
    np.testing.assert_allclose(
        np.asarray(out_sparse), np.asarray(out_dense), atol=1e-5
    )


def test_dropout_rngs_change_training_output(setup):
    g, x = setup
    model = GCN(hidden=8, n_class=C, dropout=0.5)
    params = model.init(jax.random.PRNGKey(0), g, x)
    o1, _ = model.apply(
        params, g, x, deterministic=False, rng=jax.random.PRNGKey(1)
    )
    o2, _ = model.apply(
        params, g, x, deterministic=False, rng=jax.random.PRNGKey(2)
    )
    assert not np.allclose(np.asarray(o1), np.asarray(o2))
    with pytest.raises(ValueError, match="rng"):
        model.apply(params, g, x, deterministic=False)


# --- interaction networks -------------------------------------------------


def fc_edges(n):
    s, r = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    m = s != r
    return jnp.asarray(s[m], jnp.int32), jnp.asarray(r[m], jnp.int32)


def test_interaction_network_shapes():
    n, do = 5, 5  # mass + 2D pos + 2D vel
    s, r = fc_edges(n)
    objs = jnp.asarray(np.random.default_rng(0).standard_normal((n, do)), jnp.float32)
    model = InteractionNetwork(out_dim=2, relation_hidden=(32,), object_hidden=(32,))
    params = model.init(jax.random.PRNGKey(0), objs, s, r)
    out = model.apply(params, objs, s, r)
    assert out.shape == (n, 2)
    # Batched via vmap.
    batch = jnp.stack([objs] * 3)
    outs = jax.vmap(lambda o: model.apply(params, o, s, r))(batch)
    assert outs.shape == (3, n, 2)


def test_inode_trajectory():
    n = 4
    s, r = fc_edges(n)
    rng = np.random.default_rng(1)
    y0 = jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)  # pos+vel 2D
    mass = jnp.asarray(rng.uniform(0.5, 2, (n, 1)), jnp.float32)
    ts = jnp.linspace(0.0, 0.1, 5)
    model = INODE(
        dim=2, relation_hidden=(16,), object_hidden=(16,),
        method="rk4", steps=2,
    )
    params = model.init(jax.random.PRNGKey(0), y0, ts, mass, s, r)
    traj, stats = model.apply(params, y0, ts, mass, s, r)
    assert traj.shape == (5, n, 4)
    assert int(stats["nfe"]) == 4 * 2 * 4  # rk4 × 2 substeps × 4 intervals
    np.testing.assert_allclose(np.asarray(traj[0]), np.asarray(y0), atol=1e-6)
    # d pos/dt = vel at t=0: first interval position change ≈ vel * dt.
    dt = float(ts[1] - ts[0])
    np.testing.assert_allclose(
        np.asarray(traj[1, :, :2] - traj[0, :, :2]) / dt,
        np.asarray(y0[:, 2:]),
        atol=0.05,
    )


def test_odeblock_remat_matches_no_remat():
    """jax.checkpoint on the dynamics changes memory, not values/grads."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.models.odeblock import GCNDynamics, ODEBlock

    data = synthetic_planetoid("cora", seed=0, scale=0.1)
    adj = data.dense_adj()
    h = jnp.asarray(
        np.random.default_rng(0).standard_normal((data.graph.n_node_pad, 8)),
        jnp.float32,
    )
    outs, grads = [], []
    for remat in (False, True):
        block = ODEBlock(GCNDynamics(8), method="rk4", steps=2, remat=remat)
        params = block.init(jax.random.PRNGKey(0), adj, h)

        def loss(p):
            return jnp.sum(block.apply(p, adj, h)[0] ** 2)

        outs.append(np.asarray(block.apply(params, adj, h)[0]))
        grads.append(jax.grad(loss)(params))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
    for a, b in zip(
        jax.tree_util.tree_leaves(grads[0]), jax.tree_util.tree_leaves(grads[1])
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


# --- parameter trees and init ---------------------------------------------


def _inputs(name, setup):
    """(model, init args) for every model, node and physics."""
    g, x = setup
    if name in MODELS:
        return MODELS[name](), (g, x)
    s, r = fc_edges(4)
    rng = np.random.default_rng(2)
    if name == "in":
        objs = jnp.asarray(rng.standard_normal((4, 5)), jnp.float32)
        m = InteractionNetwork(
            out_dim=2, relation_hidden=(16, 16), object_hidden=(8,)
        )
        return m, (objs, s, r)
    y0 = jnp.asarray(rng.standard_normal((4, 4)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 2, (4, 1)), jnp.float32)
    m = INODE(dim=2, relation_hidden=(16,), object_hidden=(8,), method="rk4")
    return m, (y0, jnp.linspace(0.0, 0.1, 3), mass, s, r)


# Expected top-level parameter keys and the number of arrays in each tree.
TREES = {
    "gcn": ({"conv1", "conv2"}, 4),
    "resgcn": ({"input", "blocks", "output"}, 8),
    "gcnode_rk4": ({"encoder", "ode", "decoder"}, 6),
    "gcnode_dopri": ({"encoder", "ode", "decoder"}, 6),
    "gcnode_adjoint": ({"encoder", "ode", "decoder"}, 6),
    "gat": ({"att1", "att2"}, 6),
    "resgat": ({"input", "blocks", "output"}, 9),
    "gatode": ({"encoder", "ode", "decoder"}, 9),
    "in": ({"relation", "object"}, 10),
    "inode": ({"core"}, 8),
}


@pytest.mark.parametrize("name", list(TREES))
def test_param_tree(setup, name):
    """Plain dicts/lists of float32 arrays; glorot/lecun kernels, zero
    biases."""
    model, args = _inputs(name, setup)
    params = model.init(jax.random.PRNGKey(0), *args)
    keys, n_leaves = TREES[name]
    assert isinstance(params, dict) and set(params) == keys
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == n_leaves
    for path, leaf in flat:
        name_ = jax.tree_util.keystr(path)
        assert isinstance(leaf, jax.Array) and leaf.dtype == jnp.float32, name_
        if name_.endswith("['bias']"):
            np.testing.assert_array_equal(np.asarray(leaf), 0.0)
        else:
            assert float(jnp.std(leaf)) > 0.0, name_


@pytest.mark.parametrize("name", list(TREES))
def test_init_is_deterministic(setup, name):
    model, args = _inputs(name, setup)
    a = model.init(jax.random.PRNGKey(5), *args)
    b = model.init(jax.random.PRNGKey(5), *args)
    c = model.init(jax.random.PRNGKey(6), *args)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert any(
        not np.array_equal(np.asarray(x), np.asarray(z))
        for x, z in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(c))
    )
