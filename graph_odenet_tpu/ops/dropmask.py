"""Counter-based attention-dropout masks, regenerable in any edge order.

The reference applies dropout to the post-softmax attention coefficients
(pyGAT convention; SURVEY.md §2 R3/R4) by sampling a Bernoulli mask in
edge order.  Here the mask is a pure *function* of (sender, receiver,
head, seed): a counter-based hash (murmur3 finalizer over a mixed key).
Any consumer can regenerate it in whatever edge order it owns, with no
permutation and no stored ``[E, H]`` mask — the single-device segment path
(``ops.sddmm``) and the edge-partitioned ring (``parallel.sharded_gat``),
whose buckets hold the edges in another order, draw identical masks.

Caveat: duplicate edges (same ordered pair) share their dropout fate —
the graph builders here never produce duplicates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["keep24", "attention_dropout_scale", "seed_from_key"]

# Mixing multipliers (odd, high-entropy) + murmur3 fmix32 finalizer
# constants.
K_SND = 0x9E3779B9
K_RCV = 0x85EBCA6B
K_HEAD = 0xC2B2AE35
F1 = 0x7FEB352D
F2 = 0x846CA68B


def keep24(rate: float) -> int:
    """Keep threshold on the hash's top 24 bits."""
    return int(round((1.0 - rate) * (1 << 24)))


def _fmix(x):
    x = x ^ (x >> 16)
    x = x * jnp.uint32(F1)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(F2)
    x = x ^ (x >> 16)
    return x


def hash_edge_head(seed, senders, receivers, heads: int):
    """u32 hash per (edge, head): ``[E, H]`` from i32 endpoint arrays."""
    s = senders.astype(jnp.uint32) * jnp.uint32(K_SND)
    r = receivers.astype(jnp.uint32) * jnp.uint32(K_RCV)
    h = (jnp.arange(heads, dtype=jnp.uint32) * jnp.uint32(K_HEAD))[None, :]
    x = (s ^ r)[:, None] ^ h ^ jnp.uint32(seed)
    return _fmix(x)


def attention_dropout_scale(
    seed, senders, receivers, heads: int, rate: float
) -> jax.Array:
    """``[E, H]`` f32 α-scale: ``1/(1-rate)`` where kept, ``0`` dropped.

    ``seed``: traced u32/i32 scalar (see ``seed_from_key``).  Padding edges
    get whatever the hash of their (0, 0) endpoints yields — harmless, the
    aggregation masks them.
    """
    x = hash_edge_head(seed, senders, receivers, heads)
    keep = (x >> 8) < jnp.uint32(keep24(rate))
    return keep.astype(jnp.float32) / (1.0 - rate)


def seed_from_key(rng: jax.Array) -> jax.Array:
    """Collapse a PRNG key to the u32 counter seed."""
    return jax.random.bits(rng, dtype=jnp.uint32)
