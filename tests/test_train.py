"""End-to-end training smoke tests (BASELINE configs 0/1/3 in miniature,
SURVEY.md §4.4): a few epochs must strictly improve over initialisation."""

import jax
import numpy as np
import pytest

from graph_odenet_tpu.data import SpringSystem, generate_trajectories, synthetic_planetoid
from graph_odenet_tpu.train import NodeClassConfig, fit_node_classifier
from graph_odenet_tpu.train.physics import (
    PhysicsConfig,
    fit_inode,
    fit_interaction_network,
    rollout_discrete,
    rollout_mse,
)


@pytest.fixture(scope="module")
def tiny_cora():
    return synthetic_planetoid("cora", seed=0, scale=0.08)


@pytest.mark.parametrize(
    "model,kw",
    [
        ("gcn", {}),
        ("gcnode", dict(method="rk4", steps=4)),
        ("gat", dict(hidden=4, heads=2)),
    ],
)
def test_node_classifier_learns(tiny_cora, model, kw):
    cfg = NodeClassConfig(model=model, epochs=30, patience=30, **kw)
    res = fit_node_classifier(cfg, tiny_cora)
    # Synthetic twin is easy: well above the 1/7 chance line in 30 epochs.
    # (threshold leaves margin for CPU scatter-order float jitter, which can
    # move a borderline run by ±a few points)
    assert res["best"]["test_acc"] > 0.42, res["best"]
    assert res["best"]["val_loss"] < 1.9


def test_interaction_network_one_step_and_rollout():
    cfg = PhysicsConfig(
        n_bodies=4, n_sims=24, n_steps=30, epochs=6, batch_size=128, seed=0
    )
    res = fit_interaction_network(cfg)
    assert np.isfinite(res["one_step_mse"])
    assert res["one_step_mse"] < 0.05, res["one_step_mse"]

    trajs = res["trajs"]
    horizon = 10
    pred = rollout_discrete(
        res["forward"], res["params"], res["system"], trajs[:, 0], horizon
    )
    assert pred.shape == (24, horizon + 1, 4, 5)
    curve = np.asarray(rollout_mse(pred, trajs[:, : horizon + 1]))
    assert np.all(np.isfinite(curve))
    assert curve[0] < 1e-9  # step 0 is the shared initial state


def test_physics_rollout_curves_deliverable():
    """Config 3's deliverable function: both curves finite, start at ~0,
    and carry the training summaries (SURVEY.md §2 R11)."""
    from graph_odenet_tpu.train.physics import physics_rollout_curves

    cfg = PhysicsConfig(
        n_bodies=3, n_sims=8, n_steps=20, epochs=1, batch_size=64,
        ode_method="rk4", ode_steps=2, ode_window=5,
        relation_hidden=(32,), object_hidden=(32,), seed=1,
    )
    out = physics_rollout_curves(cfg, horizon=6, n_test=4)
    disc = np.asarray(out["rollout_mse_discrete"])
    ode = np.asarray(out["rollout_mse_inode"])
    assert disc.shape == (7,) and ode.shape == (7,)
    assert np.all(np.isfinite(disc)) and np.all(np.isfinite(ode))
    assert disc[0] < 1e-9 and ode[0] < 1e-9
    assert np.isfinite(out["one_step_mse"]) and np.isfinite(out["window_mse"])


def test_inode_window_fit():
    cfg = PhysicsConfig(
        n_bodies=3, n_sims=8, n_steps=20, epochs=3, batch_size=64,
        ode_method="rk4", ode_steps=2, ode_window=5,
        relation_hidden=(32,), object_hidden=(32,), seed=1,
    )
    res = fit_inode(cfg)
    assert np.isfinite(res["window_mse"])
    # Fitting 5-step windows of a smooth spring system: MSE should be tiny
    # relative to state scale (positions O(1)).
    assert res["window_mse"] < 0.5, res["window_mse"]


def test_representation_defaults_to_edge_list(tiny_cora):
    """Every model aggregates over the edge list unless told otherwise."""
    from graph_odenet_tpu.train.node_classification import adjacency

    data = tiny_cora
    for model in ("gcn", "resgcn", "gcnode", "gat", "resgat", "gatode"):
        rep = NodeClassConfig(model=model).representation
        assert rep == "segment"
        assert adjacency(data, rep, model) is data.graph


def test_dense_representation_is_gcn_family_only(tiny_cora):
    """A dense Â serves the GCN family; attention scores edges, so the GAT
    family refuses it, and an unknown name is refused too."""
    from graph_odenet_tpu.train.node_classification import adjacency

    data = tiny_cora
    n = data.graph.n_node_pad
    for model in ("gcn", "resgcn", "gcnode"):
        assert adjacency(data, "dense", model).shape == (n, n)
    for model in ("gat", "resgat", "gatode"):
        with pytest.raises(ValueError, match="segment"):
            adjacency(data, "dense", model)
    with pytest.raises(ValueError, match="unknown representation"):
        adjacency(data, "auto", "gcn")
