"""SpMM — sparse adjacency × dense features.

Replaces the reference's ``torch.spmm(adj, support)`` (GraphConvolution,
SURVEY.md §2 R2) and ``SpecialSpmm`` (sparse GAT, R4).  Dispatch on the
adjacency representation:

  * ``Graph``            → gather + ``segment_sum`` (XLA scatter-add);
  * dense ``jax.Array``  → a single matmul ``Â @ X``.  The trainer
                           densifies once with ``graph.to_dense`` and reuses
                           it across every solver step when asked to
                           (``train.node_classification.adjacency``).

Both paths are linear, so autodiff through them is exact.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from graph_odenet_tpu.graph import Graph
from graph_odenet_tpu.ops.segment import gather, segment_sum

__all__ = ["spmm", "spmm_segment"]


def spmm_segment(g: Graph, x: jax.Array) -> jax.Array:
    """out[r] = Σ_{e: receivers[e]=r} weight[e] · x[senders[e]].

    Padding edges have weight 0 (and keep receivers sorted), so no masking
    is needed for this linear aggregation.
    """
    msgs = gather(x, g.senders) * g.weight[:, None].astype(x.dtype)
    return segment_sum(msgs, g.receivers, num_segments=g.n_node_pad)


def spmm(adj: Union[Graph, jax.Array], x: jax.Array) -> jax.Array:
    """Aggregate node features over the (normalised) adjacency.

    Args:
      adj: the adjacency in one of two representations —
        * ``Graph``: COO, gather + ``segment_sum``;
        * dense ``[N_pad, N_pad]`` array (row = receiver) as produced by
          ``graph.to_dense``: one matmul.
      x:   ``[N_pad, F]`` node features.
    """
    if isinstance(adj, Graph):
        return spmm_segment(adj, x)
    return jnp.dot(adj.astype(x.dtype), x, preferred_element_type=x.dtype)
