"""Sharded SpMM with halo exchange (SURVEY.md §2 T6, §7 hard part 3).

Two ``shard_map`` realisations over the mesh's "edge" axis, both producing
node features sharded by receiver block:

  * ``mode="allgather"`` — one ``all_gather`` of the feature shards, then a
    single local gather + segment-sum.  Simple, bandwidth-heavy; XLA may
    still overlap the gather with unrelated compute.
  * ``mode="ring"``      — ppermute ring: at step k each device holds block
    (me − k) mod P's features and accumulates exactly the sender-bucket
    [me, that block] while the next chunk is in flight — communication
    hidden behind local segment-sums (the scaling-critical path for the
    ≥80% multi-host efficiency target).

Correctness contract (tested): all modes match the single-device
``ops.spmm`` to float tolerance, on a CPU-emulated 8-device mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graph_odenet_tpu.ops.segment import segment_sum
from graph_odenet_tpu.parallel.partition import PartitionedGraph

__all__ = ["spmm_sharded"]


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _bucket_spmm(block_size, chunk, s_b, r_b, w_b, t_s_b, t_r_b, t_w_b):
    """One bucket's SpMM: ``out[r] = Σ_{e: r_e=r} w_e·chunk[s_e]``,
    differentiable in ``chunk``.

    The hand-written vjp reduces the cotangent
    ``dchunk[s] = Σ_{e: s_e=s} w_e·g[r_e]`` through the bucket's CSC
    (sender-sorted) view, a sorted segment sum, instead of the unsorted
    scatter-add that autodiff of the sender gather produces.
    """
    msgs = jnp.take(chunk, s_b, axis=0) * w_b[:, None].astype(chunk.dtype)
    return segment_sum(msgs, r_b, num_segments=block_size, sorted_ids=False)


def _bucket_spmm_fwd(block_size, chunk, s_b, r_b, w_b, t_s_b, t_r_b, t_w_b):
    out = _bucket_spmm(block_size, chunk, s_b, r_b, w_b, t_s_b, t_r_b, t_w_b)
    return out, (s_b, r_b, w_b, t_s_b, t_r_b, t_w_b)


def _bucket_spmm_bwd(block_size, res, g):
    t_s_b, t_r_b, t_w_b = res[3:]
    dmsgs = jnp.take(g, t_r_b, axis=0) * t_w_b[:, None].astype(g.dtype)
    # Padding slots (sender 0) trail the sorted real edges, so the ids are
    # not sorted as a whole.
    dchunk = segment_sum(
        dmsgs, t_s_b, num_segments=block_size, sorted_ids=False
    )
    # Edge metadata is index state: zero cotangents.
    return (dchunk,) + tuple(jnp.zeros_like(a) for a in res)


_bucket_spmm.defvjp(_bucket_spmm_fwd, _bucket_spmm_bwd)


def _local_accumulate(senders_rel_b, receivers_rel_b, weight_b, chunk, block_size):
    """One bucket's contribution: gather from a single block's feature chunk
    and segment-sum into the local output rows."""
    msgs = jnp.take(chunk, senders_rel_b, axis=0) * weight_b[:, None].astype(chunk.dtype)
    return segment_sum(
        msgs, receivers_rel_b, num_segments=block_size, sorted_ids=False
    )


def spmm_sharded(
    pg: PartitionedGraph,
    x: jax.Array,
    mesh: Mesh,
    *,
    axis: str = "edge",
    mode: str = "ring",
    feat_axis: str | None = None,
    check_vma: bool = True,
) -> jax.Array:
    """Â @ x with x row-sharded over ``axis``; returns the same sharding.

    Args:
      pg: partitioning with ``n_parts == mesh.shape[axis]``.
      x:  f32[n_node_pad, F] node features (global view; sharded or not —
          ``shard_map`` re-shards as needed).
      feat_axis: optional second mesh axis to shard the FEATURE dimension
          over (tensor parallelism for wide layers, SURVEY §2.2 T7): the
          aggregation is feature-wise independent, so each feat-shard runs
          the same halo exchange on an F/PF slice — edge metadata is
          replicated across the axis, activations and ring traffic shrink
          by PF.
      check_vma: pass ``False`` when composing with a batch mesh axis via
          ``jax.vmap(..., spmd_axis_name=...)`` (DP × edge parallelism on a
          2-D mesh) — jax's varying-manual-axes checker currently rejects
          the batched scatter there (its own error suggests this
          workaround); the 2-D-mesh test pins numerical correctness.
    """
    n_parts = mesh.shape[axis]
    if pg.n_parts != n_parts:
        raise ValueError(f"partitioning has {pg.n_parts} parts, mesh axis {n_parts}")
    B = pg.block_size

    # Per-device shards: edge arrays by receiver block (dim 0), features by
    # node block (rows) and optionally the feat mesh axis (columns).  Other
    # mesh axes replicate.
    edge_spec = P(axis, None, None)
    x_spec = P(axis, feat_axis)

    if mode == "allgather":

        def kernel(senders_rel, receivers_rel, weight, x_shard):
            # [1, P, E_b] locals; x_shard [B, F].
            x_full = jax.lax.all_gather(x_shard, axis, tiled=True)  # [N, F]
            offs = jnp.arange(n_parts, dtype=jnp.int32) * B
            senders_global = (senders_rel[0] + offs[:, None]).reshape(-1)
            out = _local_accumulate(
                senders_global,
                receivers_rel[0].reshape(-1),
                weight[0].reshape(-1),
                x_full,
                B,
            )
            return out

    elif mode == "ring":

        def kernel(senders_rel, receivers_rel, weight, t_senders_rel,
                   t_receivers_rel, t_weight, x_shard):
            me = jax.lax.axis_index(axis)
            perm_src = [((i + 1) % n_parts, i) for i in range(n_parts)]

            def local(src_block, chunk):
                def take(a):
                    return jnp.take(a[0], src_block, axis=0)

                return _bucket_spmm(
                    B, chunk,
                    take(senders_rel), take(receivers_rel), take(weight),
                    take(t_senders_rel), take(t_receivers_rel),
                    take(t_weight),
                )

            def body(k, carry):
                out, chunk = carry
                # chunk currently holds block (me + k) mod P's features.
                src_block = (me + k) % n_parts
                # Launch the next hop first so the DMA overlaps the local
                # reduction below (XLA schedules ppermute async).
                nxt = jax.lax.ppermute(chunk, axis, perm=perm_src)
                out = out + local(src_block, chunk)
                return out, nxt

            out0 = jnp.zeros((B, x_shard.shape[1]), dtype=x_shard.dtype)
            # The accumulator must carry the same varying-manual-axes type
            # as the per-device data it sums (shard_map vma typing) — all
            # mesh axes the features are sharded over.
            vma = (axis,) + ((feat_axis,) if feat_axis else ())
            out0 = jax.lax.pcast(out0, vma, to="varying")
            out, _ = jax.lax.fori_loop(0, n_parts, body, (out0, x_shard))
            return out

    else:
        raise ValueError(f"unknown mode {mode!r}")

    if mode == "allgather":
        return jax.shard_map(
            kernel,
            mesh=mesh,
            in_specs=(edge_spec, edge_spec, edge_spec, x_spec),
            out_specs=x_spec,
            check_vma=check_vma,
        )(pg.senders_rel, pg.receivers_rel, pg.weight, x)
    return jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(edge_spec,) * 6 + (x_spec,),
        out_specs=x_spec,
        check_vma=check_vma,
    )(pg.senders_rel, pg.receivers_rel, pg.weight, pg.t_senders_rel,
      pg.t_receivers_rel, pg.t_weight, x)
