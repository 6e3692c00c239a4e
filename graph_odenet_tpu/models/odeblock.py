"""ODE-wrapped GNNs — continuous-depth models (SURVEY.md §2 R6).

Parity: the reference wraps a GNN layer as autonomous dynamics
(``ODEFunc.forward(t, h) = gnn_layer(h, adj)`` with the adjacency captured
as module state) and integrates it with ``odeint`` over t ∈ [0, 1]
(``ODEBlock``).  Here the adjacency is a closure argument, the dynamics'
parameters are one entry of the enclosing model's parameter dict, and the
integrator is the jittable ``ode.odeint`` / ``ode.odeint_adjoint``.

NFE (number of function evaluations — the reference keeps a counter
attribute on its func) and the other solver statistics are the second
value every ``apply`` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import jax
import jax.numpy as jnp

from graph_odenet_tpu.graph import Graph
from graph_odenet_tpu.models.common import dropout, like, split_rng
from graph_odenet_tpu.models.gat import GATLayer
from graph_odenet_tpu.models.gcn import GCNLayer
from graph_odenet_tpu.ode import odeint, odeint_adjoint

Adj = Union[Graph, jax.Array]


@dataclasses.dataclass(frozen=True)
class GCNDynamics:
    """dh/dt = σ(Â h W + b) — width-preserving graph-conv vector field."""

    hidden: int
    activation: str = "tanh"

    def init(self, key, adj: Adj, h) -> dict:
        return GCNLayer(self.hidden).init(key, adj, h)

    def apply(self, params, t, adj: Adj, h: jax.Array) -> jax.Array:
        del t  # autonomous, like the reference ODEFunc
        out = GCNLayer(self.hidden).apply(params, adj, h)
        return getattr(jax.nn, self.activation)(out)


@dataclasses.dataclass(frozen=True)
class GATDynamics:
    """dh/dt = σ(att(h)) — width-preserving single-head attention field."""

    hidden: int
    activation: str = "tanh"

    def _layer(self):
        return GATLayer(self.hidden, heads=1, concat=False)

    def init(self, key, g: Graph, h) -> dict:
        return self._layer().init(key, g, h)

    def apply(self, params, t, g: Graph, h: jax.Array) -> jax.Array:
        del t
        out = self._layer().apply(params, g, h)
        return getattr(jax.nn, self.activation)(out)


@dataclasses.dataclass(frozen=True)
class ODEBlock:
    """h(t1) = h(0) + ∫ f_θ(t, h) dt — continuous residual block.

    ``dynamics`` is any object with ``init(key, adj, h)`` and
    ``apply(params, t, adj, h) -> dh``.
    ``adjoint=True`` trains with the O(1)-memory continuous adjoint;
    ``adjoint="checkpoint"`` with the checkpointed-forward adjoint (stores
    accepted-step states, fixed-step anchored reverse sweep — the fast
    at-scale training path); otherwise pick a reverse-differentiable
    ``method`` (fixed-grid or ``dopri5_scan``) for discretize-then-optimize
    training.
    """

    dynamics: Any
    t1: float = 1.0
    method: str = "rk4"
    rtol: float = 1e-3
    atol: float = 1e-4
    steps: int = 4              # fixed-grid substeps / scan bound per interval
    adjoint: Union[bool, str] = False
    remat: bool = False         # rematerialise dynamics on backward: trades
                                # one extra eval per stage for not storing
                                # stage activations (memory ↔ FLOPs for
                                # deep/many-step solves)

    def init(self, key, adj: Adj, h) -> dict:
        return self.dynamics.init(key, adj, h)

    def apply(self, params, adj: Adj, h: jax.Array):
        """Returns ``(h(t1), solver stats)``."""

        def f(t, y, p):
            return self.dynamics.apply(p, t, adj, y)

        if self.remat:
            f = jax.checkpoint(f)

        ts = jnp.asarray([0.0, self.t1], dtype=h.dtype)
        kw = dict(
            method=self.method, rtol=self.rtol, atol=self.atol,
            steps_per_interval=self.steps,
            max_steps_per_interval=self.steps,
            return_stats=True,
        )
        if self.adjoint:
            ys, stats = odeint_adjoint(
                f, h, ts, params, checkpoint=self.adjoint == "checkpoint", **kw
            )
        else:
            ys, stats = odeint(f, h, ts, params, **kw)
        return ys[-1], stats


def _ode_kw(m) -> dict:
    return dict(
        t1=m.t1, method=m.method, steps=m.steps, rtol=m.rtol, atol=m.atol,
        adjoint=m.adjoint, remat=m.remat,
    )


@dataclasses.dataclass(frozen=True)
class GCNODE:
    """Continuous-depth GCN classifier: encoder conv → ODEBlock → readout.

    The continuous counterpart of ``ResGCN`` (paper: residual h←h+f(h) taken
    to the ODE limit); BASELINE config[1] runs this with rk4(4 steps)."""

    hidden: int = 16
    n_class: int = 7
    dropout: float = 0.5
    t1: float = 1.0
    method: str = "rk4"
    steps: int = 4
    rtol: float = 1e-3
    atol: float = 1e-4
    adjoint: Union[bool, str] = False
    remat: bool = False
    activation: str = "tanh"

    def _block(self):
        return ODEBlock(GCNDynamics(self.hidden, self.activation), **_ode_kw(self))

    def init(self, key, adj: Adj, x) -> dict:
        k1, k2, k3 = jax.random.split(key, 3)
        h = like(x, self.hidden)
        return {
            "encoder": GCNLayer(self.hidden).init(k1, adj, x),
            "ode": self._block().init(k2, adj, h),
            "decoder": GCNLayer(self.n_class).init(k3, adj, h),
        }

    def apply(self, params, adj: Adj, x, *, deterministic=True, rng=None):
        """Returns ``(log_probs [N, n_class], solver stats)``."""
        k1, k2 = split_rng(rng, 2)
        h = jax.nn.relu(GCNLayer(self.hidden).apply(params["encoder"], adj, x))
        h = dropout(h, self.dropout, k1, deterministic)
        h, stats = self._block().apply(params["ode"], adj, h)
        h = dropout(h, self.dropout, k2, deterministic)
        h = GCNLayer(self.n_class).apply(params["decoder"], adj, h)
        return jax.nn.log_softmax(h, axis=-1), stats


@dataclasses.dataclass(frozen=True)
class GATODE:
    """Continuous-depth GAT classifier (BASELINE config[2]: dopri5)."""

    hidden: int = 8
    heads: int = 8
    n_class: int = 7
    dropout: float = 0.6
    t1: float = 1.0
    method: str = "dopri5_scan"
    steps: int = 32
    rtol: float = 1e-3
    atol: float = 1e-4
    adjoint: Union[bool, str] = False
    remat: bool = False
    activation: str = "tanh"

    def _layers(self):
        dim = self.hidden * self.heads
        return (
            GATLayer(self.hidden, heads=self.heads, attn_dropout=self.dropout),
            ODEBlock(GATDynamics(dim, self.activation), **_ode_kw(self)),
            GATLayer(self.n_class, heads=1, concat=False),
        )

    def init(self, key, g: Graph, x) -> dict:
        enc, block, dec = self._layers()
        k1, k2, k3 = jax.random.split(key, 3)
        h = like(x, self.hidden * self.heads)
        return {
            "encoder": enc.init(k1, g, x),
            "ode": block.init(k2, g, h),
            "decoder": dec.init(k3, g, h),
        }

    def apply(self, params, g: Graph, x, *, deterministic=True, rng=None):
        """Returns ``(log_probs [N, n_class], solver stats)``."""
        enc, block, dec = self._layers()
        k0, k1, k2 = split_rng(rng, 3)
        x = dropout(x, self.dropout, k0, deterministic)
        h = jax.nn.elu(
            enc.apply(params["encoder"], g, x, deterministic=deterministic, rng=k1)
        )
        h, stats = block.apply(params["ode"], g, h)
        h = dropout(h, self.dropout, k2, deterministic)
        h = dec.apply(params["decoder"], g, h, deterministic=deterministic)
        return jax.nn.log_softmax(h, axis=-1), stats
