"""Segmented aggregation primitives (pure JAX).

These are the semantic ground truth for every sparse op in the framework: the
reference's ``torch.spmm(adj, x)`` is exactly ``segment_sum(w * x[senders],
receivers)`` over a receiver-sorted edge list, and its sparse-GAT softmax
(``SpGraphAttentionLayer``, SURVEY.md §3.3) is ``segment_softmax``.

All functions take a **static** ``num_segments`` so shapes stay compile-time
constant under ``jit`` / ``vmap`` / solver loops.  XLA lowers
``segment_sum`` on sorted indices to a scatter-add.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "gather",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_softmax",
]


def gather(x: jax.Array, idx: jax.Array) -> jax.Array:
    """Row gather ``x[idx]`` — per-edge view of node features."""
    return jnp.take(x, idx, axis=0)


def segment_sum(data, segment_ids, num_segments: int, *, sorted_ids: bool = True):
    """Sum ``data`` rows into ``num_segments`` buckets.

    ``sorted_ids=True`` (the Graph invariant: receiver-sorted edges) lets XLA
    use the cheaper sorted-scatter lowering.
    """
    return jax.ops.segment_sum(
        data,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=sorted_ids,
    )


def segment_mean(data, segment_ids, num_segments: int, *, sorted_ids: bool = True):
    ones = jnp.ones(data.shape[:1], dtype=data.dtype)
    total = segment_sum(data, segment_ids, num_segments, sorted_ids=sorted_ids)
    count = segment_sum(ones, segment_ids, num_segments, sorted_ids=sorted_ids)
    count = jnp.maximum(count, 1.0)
    return total / count.reshape((-1,) + (1,) * (data.ndim - 1))


def segment_max(data, segment_ids, num_segments: int, *, sorted_ids: bool = True):
    return jax.ops.segment_max(
        data,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=sorted_ids,
    )


def segment_softmax(
    logits: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
    *,
    mask: jax.Array | None = None,
    sorted_ids: bool = True,
) -> jax.Array:
    """Numerically-stable softmax over edges grouped by receiver.

    Reference behaviour: sparse GAT masks non-edges with ``-inf`` before a
    row-wise softmax (SURVEY.md §2 R3/R4).  Here non-edges never exist in the
    edge list; ``mask`` handles *padding* edges instead.

    Returns per-edge probabilities (padding edges → 0).
    """
    if mask is not None:
        logits = jnp.where(mask, logits, -jnp.inf)
    # Subtract per-segment max for stability.
    seg_max = segment_max(logits, segment_ids, num_segments, sorted_ids=sorted_ids)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    shifted = logits - seg_max[segment_ids]
    exp = jnp.where(jnp.isfinite(shifted), jnp.exp(shifted), 0.0)
    denom = segment_sum(exp, segment_ids, num_segments, sorted_ids=sorted_ids)
    denom = jnp.maximum(denom, 1e-30)
    return exp / denom[segment_ids]
