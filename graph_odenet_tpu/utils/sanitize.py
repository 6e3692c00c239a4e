"""Sanitizers (SURVEY.md §5 "race detection / sanitizers" row).

XLA programs are data-race-free by construction, so the equivalent of the
reference stack's sanitizers here is a numeric check:

  * :func:`odeint_checked` — ``ode.odeint`` wrapped in
    ``jax.experimental.checkify``: reports non-finite solver states (NaN
    injection anywhere in the dynamics surfaces as a checked error, not
    silent garbage) and adaptive step-budget exhaustion
    (``stats["success"]``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

__all__ = ["odeint_checked"]


def odeint_checked(func, y0, ts, *args, throw: bool = True, **kw):
    """``ode.odeint`` with checkify numeric sanitizers.

    Checks every requested output state for non-finite values (NaN
    injected anywhere in the dynamics surfaces as a checked error instead
    of silently propagating) and, for adaptive methods, that the step
    budget reached every requested time (``stats["success"]``).

    ``throw=True`` (eager convenience) raises ``checkify.JaxRuntimeError``
    immediately; ``throw=False`` returns ``(err, (ys, stats))`` for use
    under jit — call ``err.throw()`` on the host side.
    """
    from graph_odenet_tpu.ode import odeint

    def run(y0, *args):
        ys, stats = odeint(func, y0, ts, *args, return_stats=True, **kw)
        flat = jax.tree_util.tree_leaves(ys)
        finite = jnp.asarray(True)
        for leaf in flat:
            finite = finite & jnp.all(jnp.isfinite(leaf))
        checkify.check(
            finite, "odeint produced non-finite state (NaN/Inf in dynamics?)"
        )
        if "success" in stats:
            checkify.check(
                stats["success"],
                "adaptive solver exhausted its step budget before reaching "
                "the requested time — increase max_steps or loosen tolerances",
            )
        return ys, stats

    err, out = checkify.checkify(run)(y0, *args)
    if throw:
        err.throw()
        return out
    return err, out
