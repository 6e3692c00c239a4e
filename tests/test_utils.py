"""Aux subsystems: checkpoint/resume determinism, metrics logging
(SURVEY.md §5)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.utils import MetricsLogger
from graph_odenet_tpu.utils.checkpoint import Checkpointer
from graph_odenet_tpu.utils.metrics import masked_accuracy, masked_nll


def test_checkpoint_save_restore_roundtrip(tmp_path):
    state = dict(
        params=dict(w=jnp.arange(6.0).reshape(2, 3), b=jnp.zeros(3)),
        step=jnp.asarray(7),
    )
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(7, state)
    ck.save(9, jax.tree_util.tree_map(lambda a: a + 1, state))
    assert ck.latest_step() == 9
    like = jax.tree_util.tree_map(np.zeros_like, state)
    restored = ck.restore(like)
    np.testing.assert_allclose(np.asarray(restored["params"]["w"]),
                               np.arange(6.0).reshape(2, 3) + 1)
    # Restore a specific earlier step — resume-from-step determinism.
    restored7 = ck.restore(like, step=7)
    np.testing.assert_allclose(np.asarray(restored7["params"]["w"]),
                               np.arange(6.0).reshape(2, 3))


def test_checkpoint_keeps_the_newest(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, dict(w=jnp.full((2,), float(step))))
    assert ck.steps() == [3, 4]
    assert sorted(os.listdir(ck.directory)) == [
        "step_0000000003.npz", "step_0000000004.npz",
    ]
    np.testing.assert_array_equal(
        ck.restore(dict(w=np.zeros(2)))["w"], [4.0, 4.0]
    )


def test_checkpoint_restore_rejects_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        ck.restore(dict(w=np.zeros(2)))
    ck.save(0, dict(w=jnp.zeros((2, 3))))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(dict(w=np.zeros((3, 2))))
    with pytest.raises(ValueError, match="tree paths"):
        ck.restore(dict(v=np.zeros((2, 3))))


def test_checkpoint_optimizer_state_and_failed_save(tmp_path):
    """An optax state (named tuples, integer counts) round-trips exactly;
    a save that fails part-way leaves the earlier steps and no partial
    file behind."""
    import optax

    params = dict(w=jnp.arange(4.0), b=jnp.ones(2))
    tx = optax.adam(0.1)
    opt = tx.init(params)
    _, opt = tx.update(params, opt)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(5, dict(params=params, opt_state=opt, epoch=5))
    got = ck.restore(dict(params=params, opt_state=tx.init(params), epoch=0))
    for a, b in zip(jax.tree_util.tree_leaves(got["opt_state"]),
                    jax.tree_util.tree_leaves(opt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert int(got["epoch"]) == 5

    class Unsaveable:
        def __array__(self, *a, **k):
            raise RuntimeError("disk full")

    with pytest.raises(RuntimeError, match="disk full"):
        ck.save(6, dict(params=params, bad=Unsaveable()))
    assert ck.steps() == [5]
    assert sorted(os.listdir(ck.directory)) == ["step_0000000005.npz"]


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path)
    log.write(epoch=0, loss=1.5)
    log.write(epoch=1, loss=jnp.asarray(0.75))
    log.close()
    recs = [json.loads(l) for l in open(path)]
    assert recs[0]["epoch"] == 0 and recs[1]["loss"] == 0.75
    assert all("t" in r for r in recs)


def test_masked_metrics():
    lp = jnp.log(jnp.asarray([[0.7, 0.3], [0.2, 0.8], [0.5, 0.5]]))
    labels = jnp.asarray([0, 1, 0])
    idx = jnp.asarray([0, 1])
    acc = masked_accuracy(lp, labels, idx)
    nll = masked_nll(lp, labels, idx)
    assert float(acc) == 1.0
    np.testing.assert_allclose(float(nll), -(np.log(0.7) + np.log(0.8)) / 2, rtol=1e-6)


def test_compile_cache_leaves_env_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the rule sets nothing."""
    from graph_odenet_tpu.utils.compile_cache import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from graph_odenet_tpu.utils.compile_cache import (
        DEFAULT_CACHE_DIR, configure_compile_cache,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(DEFAULT_CACHE_DIR) == os.path.join(repo, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert configure_compile_cache() == str(DEFAULT_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == str(DEFAULT_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
