"""Graph container and adjacency normalisation.

Capability parity: the reference's ``ref:utils.py`` (pygcn-style ``load_data`` /
``normalize`` / ``sparse_mx_to_torch_sparse_tensor``, SURVEY.md §2 R1) builds a
scipy COO adjacency with self-loops and row-normalises it.  Here the graph is
an immutable pytree of **static-shape** device arrays so it can flow through
``jit`` / ``vmap`` / ``lax.while_loop`` without retracing:

  * edges are COO ``(senders, receivers, weight)`` int32/f32 arrays,
    canonically **sorted by receiver** (CSR-like order) so row-segmented
    aggregation can consume them directly;
  * real sizes ``n_node`` / ``n_edge`` are static Python ints (metadata), the
    arrays themselves are padded to tile multiples — padding edges carry
    weight 0 and index node 0, so linear aggregation is exact and masked
    softmax uses the compile-time edge mask;
  * normalisation (``D^-1(A+I)`` row, ``D^-1/2(A+I)D^-1/2`` symmetric) is a
    pure function returning a new Graph, not an in-place scipy mutation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Graph", "from_edges", "pad_graph", "normalize_graph", "to_dense"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-shape COO graph, edges sorted by receiver.

    Attributes:
      senders:   int32[E_pad] source node of each directed edge.
      receivers: int32[E_pad] destination node of each directed edge
                 (non-decreasing over the FULL array: padding edges at the
                 tail point at node n_node_pad−1 with weight 0).
      weight:    f32[E_pad] edge weight (normalised adjacency value; 0 on
                 padding edges).
      n_node:    static int — number of real nodes (<= node array padding).
      n_edge:    static int — number of real edges (<= E_pad).
      n_node_pad: static int — padded node count models should size arrays to.
    """

    senders: jax.Array
    receivers: jax.Array
    weight: jax.Array
    n_node: int = dataclasses.field(metadata=dict(static=True))
    n_edge: int = dataclasses.field(metadata=dict(static=True))
    n_node_pad: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_edge_pad(self) -> int:
        return self.senders.shape[0]

    def edge_mask(self) -> jax.Array:
        """bool[E_pad] — True on real edges.  Compile-time constant shape."""
        return jnp.arange(self.n_edge_pad) < self.n_edge

    def node_mask(self) -> jax.Array:
        """bool[n_node_pad] — True on real nodes."""
        return jnp.arange(self.n_node_pad) < self.n_node

    def in_degree(self) -> jax.Array:
        """f32[n_node_pad] number of incoming real edges per node."""
        ones = jnp.where(self.edge_mask(), 1.0, 0.0)
        return jax.ops.segment_sum(ones, self.receivers, num_segments=self.n_node_pad)


def from_edges(
    senders,
    receivers,
    n_node: int,
    *,
    weight=None,
    add_self_loops: bool = True,
    symmetrize: bool = True,
    normalize: Optional[str] = "row",
    node_multiple: int = 128,
    edge_multiple: int = 1024,
) -> Graph:
    """Build a canonical Graph from raw COO edges (host-side, numpy).

    Mirrors the reference pipeline (SURVEY.md §2 R1): symmetrize the directed
    citation edges, add self-loops, normalise.  Runs in numpy because it is
    one-time preprocessing; the result is device-resident and static-shape.

    Args:
      normalize: "row" (``D^-1(A+I)``, pygcn/GCN-reference convention),
        "sym" (``D^-1/2(A+I)D^-1/2``, Kipf & Welling), or None.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if weight is None:
        weight = np.ones_like(senders, dtype=np.float64)
    weight = np.asarray(weight, dtype=np.float64)

    # Native (C++) preprocessing tier when available — same semantics as the
    # numpy pipeline below, ~order-of-magnitude faster at OGBN scale.
    from graph_odenet_tpu import native as _native

    if normalize in (None, "row", "sym"):
        pre = _native.preprocess_edges(
            senders, receivers, n_node,
            weight=weight,
            symmetrize=symmetrize,
            add_self_loops=add_self_loops,
            normalize=normalize,
        )
        if pre is not None:
            senders, receivers, weight = pre
            return _pack_graph(
                senders, receivers, weight, n_node, node_multiple, edge_multiple
            )

    if symmetrize:
        senders, receivers = (
            np.concatenate([senders, receivers]),
            np.concatenate([receivers, senders]),
        )
        weight = np.concatenate([weight, weight])

    # Deduplicate (symmetrizing an already-symmetric edge list, or repeated
    # citations, must not double weights — reference uses a binary adjacency).
    key = senders * n_node + receivers
    key, idx = np.unique(key, return_index=True)
    senders, receivers, weight = senders[idx], receivers[idx], weight[idx]

    if add_self_loops:
        loop = np.arange(n_node, dtype=np.int64)
        has_loop = np.isin(loop, senders[senders == receivers])
        new = loop[~has_loop]
        senders = np.concatenate([senders, new])
        receivers = np.concatenate([receivers, new])
        weight = np.concatenate([weight, np.ones_like(new, dtype=np.float64)])

    if normalize is not None:
        deg = np.zeros(n_node, dtype=np.float64)
        np.add.at(deg, receivers, weight)
        if normalize == "row":
            inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30), 0.0)
            weight = weight * inv[receivers]
        elif normalize == "sym":
            inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)), 0.0)
            weight = weight * inv_sqrt[receivers] * inv_sqrt[senders]
        else:
            raise ValueError(f"unknown normalize={normalize!r}")

    # CSR order: sort by (receiver, sender) for deterministic tiling.
    order = np.lexsort((senders, receivers))
    senders, receivers, weight = senders[order], receivers[order], weight[order]
    return _pack_graph(
        senders, receivers, weight, n_node, node_multiple, edge_multiple
    )


def _pack_graph(senders, receivers, weight, n_node, node_multiple, edge_multiple):
    """Pad (receiver, sender)-sorted COO arrays into a static-shape Graph."""
    n_edge = senders.shape[0]
    e_pad = _round_up(max(n_edge, 1), edge_multiple)
    n_pad = _round_up(max(n_node, 1), node_multiple)
    pad = e_pad - n_edge
    # Padding edges carry weight 0 and receiver n_pad−1 (≥ every real,
    # sorted receiver) so ``indices_are_sorted=True`` stays truthful for the
    # whole array.
    senders = np.concatenate([senders, np.zeros(pad, dtype=np.int64)])
    receivers = np.concatenate(
        [receivers, np.full(pad, n_pad - 1, dtype=np.int64)]
    )
    weight = np.concatenate([weight, np.zeros(pad, dtype=np.float64)])

    return Graph(
        senders=jnp.asarray(senders, dtype=jnp.int32),
        receivers=jnp.asarray(receivers, dtype=jnp.int32),
        weight=jnp.asarray(weight, dtype=jnp.float32),
        n_node=int(n_node),
        n_edge=int(n_edge),
        n_node_pad=int(n_pad),
    )


def pad_graph(g: Graph, *, node_multiple: int = 128, edge_multiple: int = 1024) -> Graph:
    """Re-pad an existing Graph to (possibly larger) tile multiples."""
    n_pad = _round_up(g.n_node_pad, node_multiple)
    e_pad = _round_up(g.n_edge_pad, edge_multiple)
    de = e_pad - g.n_edge_pad
    return Graph(
        senders=jnp.pad(g.senders, (0, de)),
        receivers=jnp.pad(
            g.receivers, (0, de), constant_values=n_pad - 1
        ),
        weight=jnp.pad(g.weight, (0, de)),
        n_node=g.n_node,
        n_edge=g.n_edge,
        n_node_pad=n_pad,
    )


def normalize_graph(g: Graph, kind: str = "row") -> Graph:
    """Device-side re-normalisation of edge weights (jittable)."""
    mask = g.edge_mask()
    w = jnp.where(mask, g.weight, 0.0)
    deg = jax.ops.segment_sum(w, g.receivers, num_segments=g.n_node_pad)
    if kind == "row":
        inv = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1e-30), 0.0)
        w = w * inv[g.receivers]
    elif kind == "sym":
        inv_sqrt = jnp.where(deg > 0, jax.lax.rsqrt(jnp.maximum(deg, 1e-30)), 0.0)
        w = w * inv_sqrt[g.receivers] * inv_sqrt[g.senders]
    else:
        raise ValueError(f"unknown kind={kind!r}")
    return dataclasses.replace(g, weight=jnp.where(mask, w, 0.0))


@partial(jax.jit, static_argnames=("n",))
def _to_dense(senders, receivers, weight, n):
    a = jnp.zeros((n, n), dtype=weight.dtype)
    return a.at[receivers, senders].add(weight)


def to_dense(g: Graph) -> jax.Array:
    """Densified normalised adjacency Â[f32, n_node_pad² ] (row=receiver).

    One dense matmul against Â aggregates all nodes at once
    (``NodeClassConfig.representation="dense"``); padding rows/cols are
    zero.
    """
    w = jnp.where(g.edge_mask(), g.weight, 0.0)
    return _to_dense(g.senders, g.receivers, w, g.n_node_pad)
