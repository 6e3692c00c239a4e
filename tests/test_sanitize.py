"""Sanitizer tests (SURVEY.md §5): NaN injection through the solver and
step-budget exhaustion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import checkify

from graph_odenet_tpu.utils.sanitize import odeint_checked


def _nan_after(t0):
    def dyn(t, y):
        bomb = jnp.where(t > t0, jnp.nan, 0.0)
        return -y + bomb

    return dyn


def test_nan_injection_reported():
    y0 = jnp.array([1.0, 2.0])
    ts = jnp.linspace(0.0, 1.0, 5)
    with pytest.raises(checkify.JaxRuntimeError, match="non-finite"):
        odeint_checked(_nan_after(0.5), y0, ts, method="rk4")


def test_nan_injection_under_jit():
    """checkify composes with jit: the error funnels out as a value."""
    y0 = jnp.array([1.0])
    ts = jnp.linspace(0.0, 1.0, 3)

    @jax.jit
    def solve(y0):
        return odeint_checked(
            _nan_after(0.5), y0, ts, method="rk4", throw=False
        )

    err, (ys, stats) = solve(y0)
    with pytest.raises(checkify.JaxRuntimeError, match="non-finite"):
        err.throw()


def test_clean_solve_passes():
    y0 = jnp.array([1.0, 2.0])
    ts = jnp.linspace(0.0, 1.0, 5)
    ys, stats = odeint_checked(lambda t, y: -y, y0, ts, method="dopri5")
    np.testing.assert_allclose(
        np.asarray(ys[-1]), np.asarray(y0) * np.exp(-1.0), rtol=1e-5
    )


def test_step_budget_exhaustion_reported():
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 2 * np.pi])
    dyn = lambda t, y: jnp.stack([y[1], -y[0]])
    with pytest.raises(checkify.JaxRuntimeError, match="step budget"):
        odeint_checked(
            dyn, y0, ts, method="dopri5", rtol=1e-9, atol=1e-12, max_steps=3
        )
