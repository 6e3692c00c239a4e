"""Helpers shared by the plain-JAX models: initialisers, dropout and the
splitting of one dropout key over a model's dropout sites."""

from __future__ import annotations

import jax
import jax.numpy as jnp

_glorot = jax.nn.initializers.glorot_uniform()
_lecun = jax.nn.initializers.lecun_normal()


def glorot(key, shape) -> jax.Array:
    """Glorot-uniform float32 kernel (float32 also when x64 is enabled)."""
    return _glorot(key, shape, jnp.float32)


def lecun(key, shape) -> jax.Array:
    """LeCun-normal float32 kernel, the default of a dense layer."""
    return _lecun(key, shape, jnp.float32)


def like(x, features: int) -> jax.ShapeDtypeStruct:
    """Shape stand-in for ``x`` with its last axis set to ``features`` —
    what a layer's ``init`` needs of its input."""
    return jax.ShapeDtypeStruct(tuple(x.shape[:-1]) + (features,), x.dtype)


def split_rng(rng, n: int) -> list:
    """``n`` independent keys from ``rng``, or ``n`` Nones when there is no
    key (deterministic application)."""
    if rng is None:
        return [None] * n
    return list(jax.random.split(rng, n))


def dropout(x: jax.Array, rate: float, rng, deterministic: bool) -> jax.Array:
    """Inverted dropout; the identity when ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout with deterministic=False needs an rng")
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))
