"""GCN — graph convolution layer and 2-layer classifier.

Parity: reference ``GraphConvolution`` (``out = spmm(Â, X·W) + b``,
SURVEY.md §2 R2) and the 2-layer ``GCN`` (hidden 16, dropout 0.5, ReLU,
log_softmax — §3.2), plus the paper's residual variant (§2 R5).

The dense ``X·W`` matmul is the only matrix product; aggregation goes
through ``ops.spmm``, which takes either the sparse ``Graph`` or a
pre-densified Â (see ``train.node_classification.adjacency``).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp

from graph_odenet_tpu.graph import Graph
from graph_odenet_tpu.models.common import dropout, glorot, like, split_rng
from graph_odenet_tpu.ops import spmm

Adj = Union[Graph, jax.Array]


@dataclasses.dataclass(frozen=True)
class GCNLayer:
    """``h' = Â (h W) + b`` — one graph convolution."""

    features: int
    use_bias: bool = True

    def init(self, key, adj: Adj, x) -> dict:
        del adj
        params = {"kernel": glorot(key, (x.shape[-1], self.features))}
        if self.use_bias:
            params["bias"] = jnp.zeros((self.features,), jnp.float32)
        return params

    def apply(self, params, adj: Adj, x: jax.Array) -> jax.Array:
        out = spmm(adj, x @ params["kernel"])
        if self.use_bias:
            out = out + params["bias"]
        return out


@dataclasses.dataclass(frozen=True)
class GCN:
    """2-layer GCN node classifier (reference §3.2 call stack).

    forward: relu(gc1(x)) → dropout → gc2 → log_softmax
    """

    hidden: int = 16
    n_class: int = 7
    dropout: float = 0.5

    def init(self, key, adj: Adj, x) -> dict:
        k1, k2 = jax.random.split(key)
        return {
            "conv1": GCNLayer(self.hidden).init(k1, adj, x),
            "conv2": GCNLayer(self.n_class).init(k2, adj, like(x, self.hidden)),
        }

    def apply(self, params, adj: Adj, x, *, deterministic=True, rng=None):
        """Returns ``(log_probs [N, n_class], {})`` — no solver stats."""
        (k1,) = split_rng(rng, 1)
        h = jax.nn.relu(GCNLayer(self.hidden).apply(params["conv1"], adj, x))
        h = dropout(h, self.dropout, k1, deterministic)
        h = GCNLayer(self.n_class).apply(params["conv2"], adj, h)
        return jax.nn.log_softmax(h, axis=-1), {}


@dataclasses.dataclass(frozen=True)
class ResGCN:
    """Residual GCN — the paper's discrete deep-residual baseline (R5):
    input projection, ``n_blocks`` residual graph-conv blocks
    ``h ← h + σ(Â h W)``, linear readout.  The continuous-depth limit of
    this model is ``GCNODE``."""

    hidden: int = 16
    n_class: int = 7
    n_blocks: int = 2
    dropout: float = 0.5

    def init(self, key, adj: Adj, x) -> dict:
        ks = jax.random.split(key, self.n_blocks + 2)
        h = like(x, self.hidden)
        return {
            "input": GCNLayer(self.hidden).init(ks[0], adj, x),
            "blocks": [
                GCNLayer(self.hidden).init(k, adj, h) for k in ks[1:-1]
            ],
            "output": GCNLayer(self.n_class).init(ks[-1], adj, h),
        }

    def apply(self, params, adj: Adj, x, *, deterministic=True, rng=None):
        """Returns ``(log_probs [N, n_class], {})`` — no solver stats."""
        ks = split_rng(rng, self.n_blocks + 1)
        block = GCNLayer(self.hidden)
        h = jax.nn.relu(block.apply(params["input"], adj, x))
        for p, k in zip(params["blocks"], ks):
            h = dropout(h, self.dropout, k, deterministic)
            h = h + jax.nn.relu(block.apply(p, adj, h))
        h = dropout(h, self.dropout, ks[-1], deterministic)
        h = GCNLayer(self.n_class).apply(params["output"], adj, h)
        return jax.nn.log_softmax(h, axis=-1), {}
