"""SDDMM + masked softmax + SpMM — the sparse-attention sandwich.

This is the compute pattern of the reference's GAT layers (SURVEY.md §3.3):

    Wh   = h @ W
    e_ij = LeakyReLU(a_srcᵀ Wh_i + a_dstᵀ Wh_j)      # SDDMM: score per edge
    α    = softmax_j(e_ij)                            # per-receiver softmax
    h'_i = Σ_j α_ij · Wh_j                            # SpMM

The reference computes dense N×N scores then masks non-edges with −∞
(``GraphAttentionLayer``) or drives a custom autograd Function over
``torch.sparse.mm`` (``SpGraphAttentionLayer``).  Here scores exist only on
the edge list; softmax is ``segment_softmax``; everything is gather/segment
ops the compiler fuses.

The per-edge decomposition ``e_ij = s_src[i] + s_dst[j]`` (where
``s_src = Wh @ a_src``) turns the SDDMM into two dense matvecs plus a
per-edge gather-add — O(N·F + E) instead of O(E·F) — exactly the trick the
reference's sparse layer uses implicitly via ``a[:F]``/``a[F:]`` splitting.
"""

from __future__ import annotations

import jax

from graph_odenet_tpu.graph import Graph
from graph_odenet_tpu.ops.segment import gather, segment_softmax, segment_sum

__all__ = ["edge_scores", "attention_aggregate"]


def edge_scores(
    g: Graph,
    s_src: jax.Array,
    s_dst: jax.Array,
    *,
    negative_slope: float = 0.2,
) -> jax.Array:
    """Per-edge attention logits ``LeakyReLU(s_src[sender] + s_dst[receiver])``.

    Args:
      s_src: ``[N_pad, H]`` source-side scores (``Wh @ a_src`` per head).
      s_dst: ``[N_pad, H]`` destination-side scores.

    Returns ``[E_pad, H]`` logits (padding edges included — mask downstream).
    """
    e = gather(s_src, g.senders) + gather(s_dst, g.receivers)
    return jax.nn.leaky_relu(e, negative_slope=negative_slope)


def attention_aggregate(
    g: Graph,
    logits: jax.Array,
    values: jax.Array,
    *,
    edge_dropout_rng: jax.Array | None = None,
    edge_dropout_rate: float = 0.0,
) -> jax.Array:
    """softmax over incoming edges, then attention-weighted value sum.

    Args:
      logits: ``[E_pad, H]`` edge logits.
      values: ``[N_pad, H, F]`` per-head node values (``Wh`` reshaped).
      edge_dropout_*: the reference applies dropout to attention
        coefficients after the softmax (GAT convention); same here.

    Returns ``[N_pad, H, F]`` aggregated features.
    """
    mask = g.edge_mask()[:, None]
    alpha = segment_softmax(logits, g.receivers, g.n_node_pad, mask=mask)
    if edge_dropout_rng is not None and edge_dropout_rate > 0.0:
        # Counter-based mask (ops.dropmask): a function of the edge's
        # endpoints, so the sharded tier draws the same mask per edge.
        from graph_odenet_tpu.ops.dropmask import (
            attention_dropout_scale, seed_from_key,
        )

        alpha = alpha * attention_dropout_scale(
            seed_from_key(edge_dropout_rng), g.senders, g.receivers,
            alpha.shape[1], edge_dropout_rate,
        )
    msgs = gather(values, g.senders) * alpha[..., None].astype(values.dtype)
    return segment_sum(msgs, g.receivers, num_segments=g.n_node_pad)
