"""Functional edge-parallel GCN-ODE training step (BASELINE config[4] shape).

A deliberately self-contained parameterisation of the flagship
model — encoder conv → rk4-integrated graph-conv dynamics → readout — whose
aggregations all go through ``spmm_sharded``, so the entire train step
(forward, backward, update) jits over a ``Mesh`` with:

  * node features, labels, and every intermediate [N, F] array sharded
    P("edge") by receiver block (the graph/tensor-parallel axis);
  * parameters replicated (they are tiny relative to activations);
  * XLA inserting psums for the parameter gradients automatically.

This is the multi-chip path the driver dry-runs; the losses/updates match
the single-device ``models.GCNODE`` semantically (same math, same solver).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graph_odenet_tpu.parallel.halo import spmm_sharded
from graph_odenet_tpu.parallel.partition import PartitionedGraph

__all__ = ["init_params", "forward", "train_step", "shard_batch"]


def init_params(rng, f_in: int, hidden: int, n_class: int, dtype=jnp.float32):
    k1, k2, k3 = jax.random.split(rng, 3)
    glorot = jax.nn.initializers.glorot_uniform()
    return dict(
        w_in=glorot(k1, (f_in, hidden), dtype),
        b_in=jnp.zeros((hidden,), dtype),
        w_dyn=glorot(k2, (hidden, hidden), dtype),
        b_dyn=jnp.zeros((hidden,), dtype),
        w_out=glorot(k3, (hidden, n_class), dtype),
        b_out=jnp.zeros((n_class,), dtype),
    )


def _feature_dropout(h, key, rate):
    """Inverted feature dropout.  ``jax.random`` is counter-based, so the
    mask drawn under jit is a pure function of (key, shape) — identical
    whatever the mesh partitioning (the sharded-vs-single-device parity
    tests rely on this)."""
    keep = jax.random.bernoulli(key, 1.0 - rate, h.shape)
    return jnp.where(keep, h / (1.0 - rate), 0.0)


def forward(params, pg: PartitionedGraph, x, mesh: Mesh, *, steps: int = 4,
            t1: float = 1.0, mode: str = "ring", dropout: float = 0.0,
            rng=None):
    """log-probs [N_pad, C], everything sharded P('edge').

    ``dropout``/``rng``: the R7 GCN-ODE recipe's feature dropout (after the
    encoder conv and after the ODE block, mirroring models.GCNODE); pass
    ``rng`` only on training steps — eval stays deterministic.
    """
    agg = partial(spmm_sharded, pg, mesh=mesh, mode=mode)
    drop = dropout > 0.0 and rng is not None
    if drop:
        k1, k2 = jax.random.split(rng)
    h = jax.nn.relu(agg(x @ params["w_in"]) + params["b_in"])
    if drop:
        h = _feature_dropout(h, k1, dropout)

    def dyn(h):
        return jnp.tanh(agg(h @ params["w_dyn"]) + params["b_dyn"])

    dt = t1 / steps

    def rk4_step(h, _):
        k1 = dyn(h)
        k2 = dyn(h + 0.5 * dt * k1)
        k3 = dyn(h + 0.5 * dt * k2)
        k4 = dyn(h + dt * k3)
        return h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None

    h, _ = jax.lax.scan(rk4_step, h, None, length=steps)
    if drop:
        h = _feature_dropout(h, k2, dropout)
    logits = agg(h @ params["w_out"]) + params["b_out"]
    return jax.nn.log_softmax(logits, axis=-1)


def loss_fn(params, pg, x, labels_1h, weight, mesh, **kw):
    """Masked NLL: ``weight`` is 1.0 on training nodes, 0 elsewhere."""
    lp = forward(params, pg, x, mesh, **kw)
    per_node = -jnp.sum(lp * labels_1h, axis=-1) * weight
    return jnp.sum(per_node) / jnp.maximum(jnp.sum(weight), 1.0)


def train_step(params, pg, x, labels_1h, weight, mesh, lr: float = 0.01, **kw):
    loss, grads = jax.value_and_grad(loss_fn)(
        params, pg, x, labels_1h, weight, mesh, **kw
    )
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


def shard_batch(mesh: Mesh, axis: str, *arrays):
    """device_put rows of each array onto the mesh axis."""
    out = []
    for a in arrays:
        spec = P(axis, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
