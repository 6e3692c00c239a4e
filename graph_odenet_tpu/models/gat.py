"""GAT — multi-head graph attention in edge-list (SDDMM) form.

Parity: reference ``GraphAttentionLayer`` / ``SpGraphAttentionLayer``
(SURVEY.md §2 R3/R4) and the standard GAT classifier (8 heads × 8 hidden,
ELU, dropout 0.6).  The dense reference materialises N×N attention scores
and masks non-edges with −∞; the sparse one drives a custom autograd
Function over ``torch.sparse.mm``.  Here there is a single formulation —
scores live only on the edge list:

    e_ij = LeakyReLU(a_srcᵀWh_i + a_dstᵀWh_j)   (ops.edge_scores, SDDMM)
    α    = segment_softmax(e, receivers)
    h'   = segment_sum(α · Wh_src)               (ops.attention_aggregate)

which is mathematically identical to both reference layers (SURVEY.md §3.3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from graph_odenet_tpu.graph import Graph
from graph_odenet_tpu.models.common import dropout, glorot, like, split_rng
from graph_odenet_tpu.ops import attention_aggregate, edge_scores


@dataclasses.dataclass(frozen=True)
class GATLayer:
    """Multi-head graph attention layer.

    Output is ``[N, heads*features]`` when ``concat`` else the head-mean
    ``[N, features]`` (reference: hidden layers concat, output layer
    averages).
    """

    features: int
    heads: int = 8
    concat: bool = True
    negative_slope: float = 0.2
    attn_dropout: float = 0.0

    def init(self, key, g: Graph, x) -> dict:
        del g
        H, F = self.heads, self.features
        k_w, k_src, k_dst = jax.random.split(key, 3)
        return {
            # Glorot over the flattened [F_in, H·F] matrix, like a dense
            # layer with H·F outputs.
            "kernel": glorot(k_w, (x.shape[-1], H * F)).reshape(
                x.shape[-1], H, F
            ),
            "attn_src": glorot(k_src, (1, H, F)),
            "attn_dst": glorot(k_dst, (1, H, F)),
        }

    def apply(self, params, g: Graph, x, *, deterministic=True, rng=None):
        wh = jnp.einsum("...i,ihf->...hf", x, params["kernel"])  # [N, H, F]
        # Decomposed attention vector a = [a_src ‖ a_dst]: per-node scalar
        # scores instead of per-edge F-dim concat (same math, O(N·F + E)).
        s_src = jnp.sum(wh * params["attn_src"], axis=-1)  # [N, H]
        s_dst = jnp.sum(wh * params["attn_dst"], axis=-1)  # [N, H]
        logits = edge_scores(g, s_src, s_dst, negative_slope=self.negative_slope)
        drop = not deterministic and self.attn_dropout > 0.0
        out = attention_aggregate(
            g, logits, wh,
            edge_dropout_rng=rng if drop else None,
            edge_dropout_rate=self.attn_dropout if drop else 0.0,
        )  # [N, H, F]
        if self.concat:
            return out.reshape(out.shape[0], self.heads * self.features)
        return jnp.mean(out, axis=1)


@dataclasses.dataclass(frozen=True)
class GAT:
    """2-layer GAT classifier: 8×8 concat + ELU, then head-averaged output
    layer, log_softmax (Veličković et al. 2018 config the reference uses)."""

    hidden: int = 8
    heads: int = 8
    out_heads: int = 1
    n_class: int = 7
    dropout: float = 0.6

    def _layers(self):
        return (
            GATLayer(self.hidden, heads=self.heads, attn_dropout=self.dropout),
            GATLayer(self.n_class, heads=self.out_heads, concat=False,
                     attn_dropout=self.dropout),
        )

    def init(self, key, g: Graph, x) -> dict:
        l1, l2 = self._layers()
        k1, k2 = jax.random.split(key)
        return {
            "att1": l1.init(k1, g, x),
            "att2": l2.init(k2, g, like(x, self.heads * self.hidden)),
        }

    def apply(self, params, g: Graph, x, *, deterministic=True, rng=None):
        """Returns ``(log_probs [N, n_class], {})`` — no solver stats."""
        l1, l2 = self._layers()
        k0, k1, k2, k3 = split_rng(rng, 4)
        x = dropout(x, self.dropout, k0, deterministic)
        h = jax.nn.elu(
            l1.apply(params["att1"], g, x, deterministic=deterministic, rng=k1)
        )
        h = dropout(h, self.dropout, k2, deterministic)
        h = l2.apply(params["att2"], g, h, deterministic=deterministic, rng=k3)
        return jax.nn.log_softmax(h, axis=-1), {}


@dataclasses.dataclass(frozen=True)
class ResGAT:
    """Residual GAT: projection, ``n_blocks`` of ``h ← h + elu(att(h))``,
    head-averaged readout (paper's discrete-residual attention variant)."""

    hidden: int = 8
    heads: int = 8
    n_class: int = 7
    n_blocks: int = 2
    dropout: float = 0.6

    def _layers(self):
        dim = self.hidden * self.heads
        return (
            GATLayer(self.hidden, heads=self.heads, attn_dropout=self.dropout),
            # Per-block attention keeps width constant so the residual adds.
            GATLayer(dim, heads=1, concat=False, attn_dropout=self.dropout),
            GATLayer(self.n_class, heads=1, concat=False),
        )

    def init(self, key, g: Graph, x) -> dict:
        first, block, last = self._layers()
        ks = jax.random.split(key, self.n_blocks + 2)
        h = like(x, self.hidden * self.heads)
        return {
            "input": first.init(ks[0], g, x),
            "blocks": [block.init(k, g, h) for k in ks[1:-1]],
            "output": last.init(ks[-1], g, h),
        }

    def apply(self, params, g: Graph, x, *, deterministic=True, rng=None):
        """Returns ``(log_probs [N, n_class], {})`` — no solver stats."""
        first, block, last = self._layers()
        ks = split_rng(rng, 2 * self.n_blocks + 3)
        x = dropout(x, self.dropout, ks[0], deterministic)
        h = jax.nn.elu(first.apply(
            params["input"], g, x, deterministic=deterministic, rng=ks[1]
        ))
        for i, p in enumerate(params["blocks"]):
            h = dropout(h, self.dropout, ks[2 + 2 * i], deterministic)
            h = h + jax.nn.elu(block.apply(
                p, g, h, deterministic=deterministic, rng=ks[3 + 2 * i]
            ))
        h = dropout(h, self.dropout, ks[-1], deterministic)
        h = last.apply(params["output"], g, h, deterministic=deterministic)
        return jax.nn.log_softmax(h, axis=-1), {}
