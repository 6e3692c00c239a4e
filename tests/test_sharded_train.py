"""End-to-end edge-parallel training (SURVEY.md §7 step 7, §2 R7/T6/T7).

The reference trains every experiment to convergence; these tests pin that
the *sharded* trainers actually train (loss decreases, accuracy beats
chance) on the 8-virtual-device CPU mesh, and that the sharded GAT-ODE
forward/gradients are mesh-invariant (1 part ≡ 8 parts)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv
from graph_odenet_tpu.parallel import make_mesh, partition_by_receiver
from graph_odenet_tpu.parallel.sharded_gat import (
    gatode_forward, init_gatode_params,
)
from graph_odenet_tpu.parallel.sharded_gcn import shard_batch
from graph_odenet_tpu.parallel.trainer import (
    ShardedTrainConfig, fit_sharded_node_classifier,
)


pytestmark = pytest.mark.usefixtures("no_compile_cache")


@pytest.fixture(scope="module")
def tiny_arxiv():
    return synthetic_ogbn_arxiv(seed=0, scale=0.004)  # ~680 nodes


def test_sharded_gcnode_trains(tiny_arxiv):
    cfg = ShardedTrainConfig(
        model="gcnode", hidden=64, steps=2, epochs=60, n_parts=8,
        eval_every=5, lr=0.02,
    )
    res = fit_sharded_node_classifier(cfg, tiny_arxiv)
    assert res["loss_final"] < res["loss_first"], res
    # 40-way classification: clearly above the 2.5% chance level after a
    # short smoke run (2× chance; exact value shifts with x64 numerics).
    assert res["test_acc"] > 2.0 / tiny_arxiv.n_class, res
    assert res["step_ms"] is not None and res["step_ms"] > 0


def test_sharded_gatode_trains(tiny_arxiv):
    cfg = ShardedTrainConfig(
        model="gatode", hidden=16, heads=2, steps=2, epochs=8, n_parts=8,
        eval_every=2, lr=0.005,
    )
    res = fit_sharded_node_classifier(cfg, tiny_arxiv)
    assert res["loss_final"] < res["loss_first"], res


def test_sharded_trainer_checkpoint_resume(tmp_path, tiny_arxiv):
    """Kill-and-restart contract: a fresh call resumes from the latest
    checkpointed step instead of re-training from scratch."""
    ckpt = str(tmp_path / "ckpt")
    cfg = ShardedTrainConfig(
        model="gcnode", hidden=32, steps=2, epochs=4, n_parts=8,
        ckpt_dir=ckpt, ckpt_every=1,
    )
    fit_sharded_node_classifier(cfg, tiny_arxiv)
    # Restart with a higher epoch budget: must pick up after epoch 3.
    cfg2 = ShardedTrainConfig(
        model="gcnode", hidden=32, steps=2, epochs=6, n_parts=8,
        ckpt_dir=ckpt, ckpt_every=1,
    )
    res = fit_sharded_node_classifier(cfg2, tiny_arxiv)
    assert res["epochs_run"] == 6
    # Only epochs 4..5 ran in the second call.
    assert res["loss_first"] is not None


def test_gatode_forward_mesh_invariance(tiny_arxiv):
    """Sharded GAT-ODE value and parameter-gradient parity: the same model
    on a 1-device mesh vs the 8-device edge-partitioned mesh."""
    data = tiny_arxiv
    g = data.graph
    f_in, c = data.features.shape[1], data.n_class
    params = init_gatode_params(jax.random.PRNGKey(0), f_in, 8, 2, c)
    labels_1h = jax.nn.one_hot(data.labels, c, dtype=jnp.float32)
    w = (np.asarray(data.labels) >= 0).astype(np.float32)

    outs, grads = [], []
    for nd in (1, 8):
        mesh = make_mesh(
            shape=(nd,), axis_names=("edge",), devices=jax.devices()[:nd]
        )
        pg = partition_by_receiver(g, nd, edge_multiple=8)
        x, y1h, wt = shard_batch(
            mesh, "edge", data.features, labels_1h, jnp.asarray(w)
        )

        def loss(p):
            lp = gatode_forward(p, pg, x, mesh, steps=2)
            return jnp.sum(-jnp.sum(lp * y1h, axis=-1) * wt) / jnp.sum(wt)

        val, grad = jax.jit(jax.value_and_grad(loss))(params)
        outs.append(float(val))
        grads.append(jax.tree_util.tree_map(np.asarray, grad))

    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6),
        grads[0], grads[1],
    )


def test_gatode_forward_remat_parity(tiny_arxiv):
    """``remat=True`` (checkpoint the ODE dynamics — required for the
    full-scale arxiv GAT-ODE on one chip) must not change values or
    parameter gradients."""
    data = tiny_arxiv
    g = data.graph
    f_in, c = data.features.shape[1], data.n_class
    params = init_gatode_params(jax.random.PRNGKey(1), f_in, 8, 2, c)
    labels_1h = jax.nn.one_hot(data.labels, c, dtype=jnp.float32)
    w = (np.asarray(data.labels) >= 0).astype(np.float32)
    mesh = make_mesh(
        shape=(8,), axis_names=("edge",), devices=jax.devices()[:8]
    )
    pg = partition_by_receiver(g, 8, edge_multiple=8)
    x, y1h, wt = shard_batch(
        mesh, "edge", data.features, labels_1h, jnp.asarray(w)
    )

    outs, grads = [], []
    for remat in (False, True):

        def loss(p):
            lp = gatode_forward(p, pg, x, mesh, steps=2, remat=remat)
            return jnp.sum(-jnp.sum(lp * y1h, axis=-1) * wt) / jnp.sum(wt)

        val, grad = jax.jit(jax.value_and_grad(loss))(params)
        outs.append(float(val))
        grads.append(jax.tree_util.tree_map(np.asarray, grad))

    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-7),
        grads[0], grads[1],
    )


def test_run_config_4_is_a_training_run():
    """VERDICT r1: run_config(4) must return real training results, not a
    microbenchmark."""
    from graph_odenet_tpu.configs import ShardedConfig, get_config, run_config

    kind, cfg = get_config(4)
    assert kind == "sharded" and isinstance(cfg, ShardedConfig)
    res = run_config(4, scale=0.004)
    for key in ("test_acc", "step_ms", "epochs_run", "loss_final", "val_loss"):
        assert key in res, res
    assert res["epochs_run"] == cfg.epochs
    assert np.isfinite(res["loss_final"]) and res["step_ms"] > 0
    # The canonical lr (0.01, reference R7) oscillates the tiny smoke twin's
    # train loss, so "trains to convergence" is pinned by
    # test_sharded_gcnode_trains; here we pin that a full training run with
    # eval tracking actually happened.
    assert res["best_epoch"] >= 0 and 0.0 <= res["test_acc"] <= 1.0
