"""Edge-partitioned multi-head graph attention (sharded GAT).

Extends the halo-ring SpMM (``parallel.halo``) to the reference's attention
sandwich (SURVEY.md §3.3) across a device mesh.  Receiver-block edge
partitioning (``partition_by_receiver``) makes every receiver's incoming
edge set shard-local, so the masked softmax never crosses devices — but the
*sender* features live on remote shards.  The ring therefore carries each
block's ``(Wh, s_src)`` chunk around the mesh, and every shard folds the
arriving bucket into a **flash-style online softmax**:

    step k (holding block b = me+k's chunk):
      e      = LeakyReLU(s_src_chunk[senders] + s_dst_local[receivers])
      m_new  = max(m, segment_max(e))
      acc    = acc·exp(m − m_new) + segment_sum(exp(e − m_new)·Wh_chunk)
      l      = l·exp(m − m_new) + segment_sum(exp(e − m_new))
    out = acc / l

The communication (ppermute) overlaps the local segment ops, and the
whole thing is plain differentiable XLA (ppermute transposes to ppermute
under AD).

Padding edges inside each bucket are masked via ``pg.weight == 0`` (the
partitioner zero-fills padding slots; GAT adjacencies are unnormalised so
real edges carry weight 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from graph_odenet_tpu.parallel.partition import PartitionedGraph

__all__ = ["gat_sharded", "init_gatode_params", "gatode_forward"]

_NEG = -1e30


def gat_sharded(
    pg: PartitionedGraph,
    s_src: jax.Array,
    s_dst: jax.Array,
    wh: jax.Array,
    mesh: Mesh,
    *,
    axis: str = "edge",
    negative_slope: float = 0.2,
    attn_rate: float = 0.0,
    attn_seed: jax.Array | None = None,
) -> jax.Array:
    """Masked-softmax attention aggregation, node rows sharded over ``axis``.

    Args:
      pg:    receiver-block partitioning with ``n_parts == mesh.shape[axis]``.
      s_src: f32[N_pad, H] source-side scores (``Wh @ a_src`` per head).
      s_dst: f32[N_pad, H] destination-side scores.
      wh:    f32[N_pad, H, F] per-head node values.
      attn_rate/attn_seed: post-softmax attention dropout (the reference's
        GAT recipe).  The mask is the counter-based ``ops.dropmask`` hash
        of GLOBAL (sender, receiver, head, seed) — partitioning-invariant,
        and identical to the single-device ``ops.sddmm`` mask given the
        same seed.  Numerators only; the softmax denominator keeps every
        edge.

    Returns f32[N_pad, H, F], same sharding as the inputs (P(axis) rows).
    Matches the single-device ``ops.sddmm`` path to float tolerance.

    """
    n_parts = mesh.shape[axis]
    if pg.n_parts != n_parts:
        raise ValueError(
            f"partitioning has {pg.n_parts} parts, mesh axis {n_parts}"
        )
    B = pg.block_size
    heads, feat = wh.shape[-2], wh.shape[-1]
    use_drop = attn_rate > 0.0 and attn_seed is not None
    seed_arr = (
        jnp.asarray(attn_seed, jnp.uint32).reshape(())
        if use_drop else jnp.uint32(0)
    )

    def kernel(senders_rel, receivers_rel, weight, ssrc_shard, sdst_shard,
               wh_shard, seed):
        me = jax.lax.axis_index(axis)
        perm = [((i + 1) % n_parts, i) for i in range(n_parts)]

        def bucket_update(src_block, chunk, m, l, acc):
            ssrc_c, wh_c = chunk
            s_b = jnp.take(senders_rel[0], src_block, axis=0)    # [E_b]
            r_b = jnp.take(receivers_rel[0], src_block, axis=0)  # [E_b]
            real = jnp.take(weight[0], src_block, axis=0) != 0.0
            e = jax.nn.leaky_relu(
                jnp.take(ssrc_c, s_b, axis=0) + jnp.take(sdst_shard, r_b, axis=0),
                negative_slope=negative_slope,
            )                                                    # [E_b, H]
            e = jnp.where(real[:, None], e, _NEG)
            m_bucket = jax.ops.segment_max(
                e, r_b, num_segments=B, indices_are_sorted=True
            )
            m_new = jnp.maximum(m, jnp.maximum(m_bucket, _NEG))  # [B, H]
            p = jnp.where(
                real[:, None],
                jnp.exp(e - jnp.take(m_new, r_b, axis=0)),
                0.0,
            )                                                    # [E_b, H]
            if use_drop:
                from graph_odenet_tpu.ops.dropmask import (
                    attention_dropout_scale,
                )

                p_v = p * attention_dropout_scale(
                    seed, src_block * B + s_b, me * B + r_b, heads,
                    attn_rate,
                )
            else:
                p_v = p
            rescale = jnp.exp(m - m_new)                         # [B, H]
            msgs = jnp.take(wh_c, s_b, axis=0) * p_v[..., None]  # [E_b, H, F]
            acc = acc * rescale[..., None] + jax.ops.segment_sum(
                msgs, r_b, num_segments=B, indices_are_sorted=True
            )
            l = l * rescale + jax.ops.segment_sum(
                p, r_b, num_segments=B, indices_are_sorted=True
            )
            return m_new, l, acc

        def body(k, carry):
            m, l, acc, chunk = carry
            src_block = (me + k) % n_parts
            # Launch the next hop first — the DMA overlaps the local
            # segment ops below.
            nxt = jax.tree_util.tree_map(
                lambda a: jax.lax.ppermute(a, axis, perm=perm), chunk
            )
            m, l, acc = bucket_update(src_block, chunk, m, l, acc)
            return m, l, acc, nxt

        vary = lambda a: jax.lax.pcast(a, (axis,), to="varying")
        m0 = vary(jnp.full((B, heads), _NEG, wh_shard.dtype))
        l0 = vary(jnp.zeros((B, heads), wh_shard.dtype))
        acc0 = vary(jnp.zeros((B, heads, feat), wh_shard.dtype))
        m, l, acc, _ = jax.lax.fori_loop(
            0, n_parts, body, (m0, l0, acc0, (ssrc_shard, wh_shard))
        )
        return acc / jnp.maximum(l, 1e-30)[..., None]

    edge_spec = P(axis, None, None)
    row = P(axis, None)
    return jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(edge_spec, edge_spec, edge_spec, row, row,
                  P(axis, None, None), P()),
        out_specs=P(axis, None, None),
    )(pg.senders_rel, pg.receivers_rel, pg.weight, s_src, s_dst, wh,
      seed_arr)


# --- sharded GAT-ODE model (mirror of parallel.sharded_gcn) ---------------
#
# The functional edge-parallel counterpart of models.odeblock.GATODE
# (encoder multi-head GAT → width-preserving single-head attention dynamics
# integrated rk4 → single-head GAT readout, SURVEY.md §2 R6/T6): every
# attention aggregation goes through ``gat_sharded``, so the whole training
# step jits over the mesh with node rows sharded P("edge") and parameters
# replicated (XLA psums their grads).


def init_gatode_params(
    rng, f_in: int, hidden: int, heads: int, n_class: int, dtype=jnp.float32
):
    """Parameters for ``gatode_forward``.  Per layer: a weight ``w`` and the
    per-head split attention vectors ``a = [a_src ‖ a_dst]`` (the reference's
    ``aᵀ[Wh_i ‖ Wh_j]`` decomposes into s_src + s_dst, SURVEY.md §3.3)."""
    ks = jax.random.split(rng, 9)
    glorot = jax.nn.initializers.glorot_uniform()
    d = heads * hidden

    def att_vec(k, h, f):
        return glorot(k, (h, f), dtype)

    return dict(
        w_enc=glorot(ks[0], (f_in, d), dtype),
        a_src_enc=att_vec(ks[1], heads, hidden),
        a_dst_enc=att_vec(ks[2], heads, hidden),
        w_dyn=glorot(ks[3], (d, d), dtype),
        a_src_dyn=att_vec(ks[4], 1, d),
        a_dst_dyn=att_vec(ks[5], 1, d),
        w_out=glorot(ks[6], (d, n_class), dtype),
        a_src_out=att_vec(ks[7], 1, n_class),
        a_dst_out=att_vec(ks[8], 1, n_class),
    )


def _att_layer(pg, mesh, axis, h, w, a_src, a_dst, attn_rate=0.0,
               attn_seed=None):
    """One sharded GAT layer: scores per head then masked-softmax attention."""
    heads, feat = a_src.shape
    wh = (h @ w).reshape(h.shape[0], heads, feat)
    s_src = jnp.einsum("nhf,hf->nh", wh, a_src)
    s_dst = jnp.einsum("nhf,hf->nh", wh, a_dst)
    out = gat_sharded(
        pg, s_src, s_dst, wh, mesh, axis=axis,
        attn_rate=attn_rate, attn_seed=attn_seed,
    )
    return out.reshape(h.shape[0], heads * feat)


def gatode_forward(
    params, pg: PartitionedGraph, x, mesh: Mesh, *, steps: int = 4,
    t1: float = 1.0, axis: str = "edge", dropout: float = 0.0, rng=None,
    remat: bool = False,
):
    """log-probs [N_pad, C]; node rows sharded P('edge') throughout.

    ``dropout``/``rng``: the reference GAT recipe's regularisation,
    mirroring models.GATODE — feature dropout on the input and after the
    ODE block, attention dropout (counter-based, partitioning-invariant)
    in the encoder layer.  Eval passes no ``rng`` and stays deterministic.
    """
    from graph_odenet_tpu.ops.dropmask import seed_from_key
    from graph_odenet_tpu.parallel.sharded_gcn import _feature_dropout

    drop = dropout > 0.0 and rng is not None
    attn_seed = None
    if drop:
        k0, k1, k2 = jax.random.split(rng, 3)
        attn_seed = seed_from_key(k1)
        x = _feature_dropout(x, k0, dropout)
    att = lambda h, w, a_s, a_d, **kw: _att_layer(
        pg, mesh, axis, h, w, a_s, a_d, **kw
    )
    h = jax.nn.elu(att(
        x, params["w_enc"], params["a_src_enc"], params["a_dst_enc"],
        attn_rate=dropout if drop else 0.0, attn_seed=attn_seed,
    ))

    def dyn(h):
        return jnp.tanh(
            att(h, params["w_dyn"], params["a_src_dyn"], params["a_dst_dyn"])
        )

    if remat:
        # Store only the rk4 stage inputs; recompute attention internals in
        # the backward, so the 4·steps dynamics evaluations do not each
        # keep their [E, H·F] messages alive.
        dyn = jax.checkpoint(dyn)

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
    logits = att(h, params["w_out"], params["a_src_out"], params["a_dst_out"])
    return jax.nn.log_softmax(logits, axis=-1)
