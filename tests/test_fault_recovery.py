"""Failure detection / elastic recovery (SURVEY.md §5): checkpoint the
edge-parallel sharded trainer mid-run, simulate losing the live state, and
assert the resumed run continues bit-identically with an uninterrupted one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.graph import from_edges
from graph_odenet_tpu.parallel import make_mesh, partition_by_receiver
from graph_odenet_tpu.parallel.sharded_gcn import (
    init_params,
    shard_batch,
    train_step,
)
from graph_odenet_tpu.utils.checkpoint import Checkpointer


pytestmark = pytest.mark.usefixtures("no_compile_cache")


@pytest.fixture(scope="module")
def problem():
    nd = min(4, len(jax.devices()))
    if nd < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh(shape=(nd,), axis_names=("edge",), devices=jax.devices()[:nd])
    rng = np.random.default_rng(0)
    n, f, c = 16 * nd, 16, 4
    a = rng.random((n, n)) < 0.3
    s, r = np.nonzero(a)
    g = from_edges(s, r, n_node=n, normalize="row", node_multiple=nd)
    pg = partition_by_receiver(g, nd, edge_multiple=8)
    x = jnp.asarray(rng.standard_normal((g.n_node_pad, f)), jnp.float32)
    labels = jnp.asarray(
        np.eye(c, dtype=np.float32)[rng.integers(0, c, g.n_node_pad)]
    )
    weight = jnp.asarray((np.arange(g.n_node_pad) < g.n_node).astype(np.float32))
    x, labels, weight = shard_batch(mesh, "edge", x, labels, weight)
    step = jax.jit(
        lambda p, x, y, w: train_step(p, pg, x, y, w, mesh, steps=2, mode="ring")
    )
    params0 = init_params(jax.random.PRNGKey(0), f, 32, c)
    return step, params0, (x, labels, weight)


def test_resume_is_bit_identical(problem, tmp_path):
    step, params0, batch = problem

    # Uninterrupted run: 5 steps.
    p = params0
    losses_ref = []
    for _ in range(5):
        p, loss = step(p, *batch)
        losses_ref.append(float(loss))
    ref_final = p

    # Interrupted run: 3 steps, checkpoint, "crash" (drop state), resume.
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    p = params0
    for i in range(3):
        p, loss = step(p, *batch)
        assert float(loss) == losses_ref[i]  # deterministic up to the fault
    ckpt.save(3, dict(params=jax.device_get(p), step=3))
    del p  # the "failure": live state lost

    restored = ckpt.restore(dict(params=jax.device_get(params0), step=0))
    assert restored["step"] == 3
    p = jax.tree_util.tree_map(jnp.asarray, restored["params"])
    for i in range(3, 5):
        p, loss = step(p, *batch)
        assert float(loss) == losses_ref[i], "resume diverged"

    for a, b in zip(jax.tree_util.tree_leaves(ref_final),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
