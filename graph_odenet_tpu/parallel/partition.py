"""Edge partitioning for multi-device graph aggregation (SURVEY.md §7 hard
part 3).

Strategy (BASELINE-mandated): partition edges by **receiver block** so each
device owns a contiguous slice of output rows — the SpMM write side is then
purely local and the only communication is reading remote *source* features
(the halo).  Edges are further bucketed by **sender block**, every bucket
padded to one static size, so the ring-overlap kernel can consume exactly
the feature chunk that just arrived at each ppermute step with fully static
shapes.

Host-side numpy preprocessing, one-time per graph; outputs are stacked
static-shape arrays ``[P, P, E_bucket]`` ready for ``shard_map``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from graph_odenet_tpu.graph import Graph

__all__ = ["PartitionedGraph", "partition_by_receiver"]


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Edges grouped by (receiver block, sender block), equal-size buckets.

    For P partitions with node-block size B = n_node_pad / P, bucket
    ``[p, b]`` holds the edges received by block p whose sender lies in
    block b:

      senders_rel:   i32[P, P, E_b]  sender − b·B   (index into block b's
                                     feature chunk; padding slots → 0)
      receivers_rel: i32[P, P, E_b]  receiver − p·B (local output row)
      weight:        f32[P, P, E_b]  0 on padding slots.

    Buckets are sorted by local receiver.  Each also carries a **transpose
    (CSC) view** — the same edges sorted by local *sender* — so the ring's
    backward reduces the gather cotangent ``dchunk[s] = Σ_{e: s_e=s}
    w_e·g[r_e]`` over sender-grouped edges (``halo._bucket_spmm``):

      t_senders_rel:   i32[P, P, E_b]  sender − b·B, CSC edge order
      t_receivers_rel: i32[P, P, E_b]  receiver − p·B, CSC edge order
      t_weight:        f32[P, P, E_b]  0 on padding slots

    ``senders_global`` reconstructs global ids on the fly (b·B offset), so
    the all-gather path needs no second copy.
    """

    senders_rel: jax.Array
    receivers_rel: jax.Array
    weight: jax.Array
    t_senders_rel: jax.Array
    t_receivers_rel: jax.Array
    t_weight: jax.Array
    block_size: int = dataclasses.field(metadata=dict(static=True))
    n_parts: int = dataclasses.field(metadata=dict(static=True))
    n_node_pad: int = dataclasses.field(metadata=dict(static=True))
    n_edge: int = dataclasses.field(metadata=dict(static=True))

    @property
    def e_bucket(self) -> int:
        return self.senders_rel.shape[2]

    def senders_global(self) -> jax.Array:
        """i32[P, P, E_b] global sender ids."""
        offs = (jnp.arange(self.n_parts, dtype=jnp.int32) * self.block_size)
        return self.senders_rel + offs[None, :, None]


def partition_by_receiver(
    g: Graph, n_parts: int, *, edge_multiple: int = 1024
) -> PartitionedGraph:
    """Split a Graph into P receiver-block shards × P sender-block buckets,
    all padded to the globally maximal bucket size (degree skew across
    blocks costs padding, not correctness — SURVEY.md §7 hard part 2).

    Buckets are receiver-sorted and padded to a multiple of
    ``edge_multiple`` edges.
    """
    if g.n_node_pad % n_parts:
        raise ValueError(
            f"n_node_pad={g.n_node_pad} not divisible by n_parts={n_parts}; "
            "re-pad the graph (pad_graph with node_multiple=n_parts*k)"
        )
    B = g.n_node_pad // n_parts
    s = np.asarray(g.senders)[: g.n_edge]
    r = np.asarray(g.receivers)[: g.n_edge]
    w = np.asarray(g.weight)[: g.n_edge]
    rb, sb = r // B, s // B

    buckets = {}
    e_bucket = 1
    for p in range(n_parts):
        for b in range(n_parts):
            sel = (rb == p) & (sb == b)
            rp = r[sel] - p * B
            order = np.argsort(rp, kind="stable")
            buckets[(p, b)] = (
                (s[sel] - b * B)[order], rp[order], w[sel][order]
            )
            e_bucket = max(e_bucket, int(sel.sum()))
    e_bucket = _round_up(e_bucket, edge_multiple)

    senders_rel = np.zeros((n_parts, n_parts, e_bucket), dtype=np.int32)
    receivers_rel = np.zeros((n_parts, n_parts, e_bucket), dtype=np.int32)
    weight = np.zeros((n_parts, n_parts, e_bucket), dtype=np.float32)
    t_senders_rel = np.zeros((n_parts, n_parts, e_bucket), dtype=np.int32)
    t_receivers_rel = np.zeros((n_parts, n_parts, e_bucket), dtype=np.int32)
    t_weight = np.zeros((n_parts, n_parts, e_bucket), dtype=np.float32)
    for (p, b), (sp, rp, wp) in buckets.items():
        L = len(sp)
        senders_rel[p, b, :L] = sp
        receivers_rel[p, b, :L] = rp
        weight[p, b, :L] = wp
        # CSC view: same edges sorted by local sender.
        order = np.argsort(sp, kind="stable")
        t_senders_rel[p, b, :L] = sp[order]
        t_receivers_rel[p, b, :L] = rp[order]
        t_weight[p, b, :L] = wp[order]

    return PartitionedGraph(
        senders_rel=jnp.asarray(senders_rel),
        receivers_rel=jnp.asarray(receivers_rel),
        weight=jnp.asarray(weight),
        t_senders_rel=jnp.asarray(t_senders_rel),
        t_receivers_rel=jnp.asarray(t_receivers_rel),
        t_weight=jnp.asarray(t_weight),
        block_size=B,
        n_parts=n_parts,
        n_node_pad=g.n_node_pad,
        n_edge=g.n_edge,
    )
