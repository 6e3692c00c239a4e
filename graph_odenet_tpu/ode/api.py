"""``odeint`` — the torchdiffeq-compatible entry point (SURVEY.md §2 T1).

``odeint(func, y0, ts, *args, method=..., rtol=..., atol=...)`` integrates
``dy/dt = func(t, y, *args)`` and returns the solution at every requested
time (``ys[0] == y0``), like ``torchdiffeq.odeint``.  Differences, all
deliberate:

  * ``y0`` may be any pytree; state is ravelled once at this boundary so the
    solvers see a flat ``f32[D]`` vector (simplifies norms and the augmented
    adjoint state).
  * the integration is a single XLA program — jit/vmap/pjit compose; no
    per-step host sync.
  * explicit ``*args`` (e.g. model params) are threaded through so
    ``jax.grad`` w.r.t. parameters works with every differentiable method.

Method → differentiability:
  euler / midpoint / heun2 / heun3 / rk4 /
  rk4_classic / explicit_adams /
  implicit_adams / fixed_adams             reverse-mode AD through lax.scan
  dopri5 / dopri8 / bosh3 / adaptive_heun /
  fehlberg2                                forward only (lax.while_loop);
                                           use the ``*_scan`` variant or
                                           odeint_adjoint for reverse-mode
  dopri5_scan / dopri8_scan / …_scan       reverse-mode AD (bounded scan)
  scipy_solver                             host-side solve_ivp via
                                           jax.pure_callback (jit/vmap-
                                           compatible validation path,
                                           forward only)

``odeint_adjoint`` (SURVEY.md §2 T4) wraps any method with the O(1)-memory
continuous adjoint.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from graph_odenet_tpu.ode import adaptive, fixed, tableaus

__all__ = ["odeint", "odeint_adjoint", "SOLVERS"]

_FIXED = {
    "euler": tableaus.EULER,
    "midpoint": tableaus.MIDPOINT,
    "heun2": tableaus.HEUN2,
    "heun3": tableaus.HEUN3,
    # torchdiffeq's "rk4" is Kutta's 3/8 rule (rk4_alt_step_func) — match it.
    "rk4": tableaus.RK4_38,
    "rk4_classic": tableaus.RK4,
}

# torchdiffeq's explicit adaptive solver zoo; each also has a reverse-
# differentiable "<name>_scan" variant (bounded scan + masking).
_ADAPTIVE = {
    "dopri5": tableaus.DOPRI5,
    "dopri8": tableaus.DOPRI8,
    "bosh3": tableaus.BOSH3,
    "adaptive_heun": tableaus.HEUN12,
    "fehlberg2": tableaus.FEHLBERG2,
}

# Fixed-grid multistep (torchdiffeq's explicit_adams / implicit_adams;
# "fixed_adams" is torchdiffeq's alias for the ABM predictor-corrector).
_ADAMS = {"explicit_adams": False, "implicit_adams": True, "fixed_adams": True}

SOLVERS = tuple(_FIXED) + tuple(_ADAMS) + tuple(_ADAPTIVE) + tuple(
    f"{m}_scan" for m in _ADAPTIVE
) + ("adams", "adams_scan", "scipy_solver")


def _ravel_problem(func, y0, args):
    y0_flat, unravel = ravel_pytree(y0)

    def f_flat(t, y_flat):
        dy = func(t, unravel(y_flat), *args)
        return ravel_pytree(dy)[0]

    return y0_flat, unravel, f_flat


def _scipy_solve(func, unravel, y0_flat, ts, args, *, rtol, atol, scipy_method):
    """Host-side solve_ivp, exposed through ``jax.pure_callback``.

    Parity: torchdiffeq's ``ScipyWrapperODESolver``.  The callback makes the
    path compose with jit/vmap (each solve syncs to host — a validation
    tool, not a production path).  Traced values the dynamics depends on
    must be threaded through ``*args`` (anything merely closed over by
    ``func`` would leak a tracer into the host callback).  Forward-only.
    """
    import numpy as np

    dtype = y0_flat.dtype
    args_flat, args_unravel = ravel_pytree(args)

    def host(y0_np, ts_np, args_np):
        from scipy.integrate import solve_ivp

        args_c = args_unravel(jnp.asarray(args_np))

        def rhs(t, y):
            dy = func(jnp.asarray(t, dtype), unravel(jnp.asarray(y, dtype)), *args_c)
            return np.asarray(ravel_pytree(dy)[0], np.float64)

        ts64 = np.asarray(ts_np, np.float64)
        sol = solve_ivp(
            rhs, (ts64[0], ts64[-1]), np.asarray(y0_np, np.float64),
            t_eval=ts64, method=scipy_method, rtol=rtol, atol=atol,
        )
        if not sol.success:  # pragma: no cover - scipy failure surface
            raise RuntimeError(f"scipy solve_ivp failed: {sol.message}")
        return np.asarray(sol.y.T, dtype)

    out_sd = jax.ShapeDtypeStruct((ts.shape[0], y0_flat.shape[0]), dtype)
    return jax.pure_callback(
        host, out_sd, y0_flat, ts, args_flat, vmap_method="sequential"
    )


def odeint(
    func: Callable,
    y0: Any,
    ts: jax.Array,
    *args,
    method: str = "dopri5",
    rtol: float = 1e-7,
    atol: float = 1e-9,
    steps_per_interval: int = 1,
    max_steps: int = 10_000,
    max_steps_per_interval: int = 64,
    first_step: float | None = None,
    return_stats: bool = False,
    scipy_method: str = "RK45",
    max_order: int = 12,
):
    """Integrate ``dy/dt = func(t, y, *args)`` over times ``ts`` (increasing).

    Returns ``ys`` with a leading time axis per leaf of ``y0`` (and a stats
    dict ``{nfe, ...}`` when ``return_stats=True``).
    """
    ts = jnp.asarray(ts)
    y0_flat, unravel, f_flat = _ravel_problem(func, y0, args)
    ts = ts.astype(y0_flat.dtype)

    # Reverse-time integration (torchdiffeq supports decreasing t; the
    # on-device solvers here require an increasing grid): substitute
    # s = d·t with d = sign(t_end − t_0), giving dy/ds = d·f(d·s, y) over
    # the increasing grid d·ts.  For concrete ts the transform applies
    # only when actually decreasing (zero overhead on the common path);
    # for traced ts the direction is a traced scalar and the transform
    # applies unconditionally — d = +1 reduces to the identity, so traced
    # decreasing grids are handled correctly instead of silently
    # producing garbage.  scipy_solver is exempt: solve_ivp integrates
    # decreasing t_eval natively.
    if ts.shape[0] >= 2 and method != "scipy_solver":
        if isinstance(ts, jax.core.Tracer):
            direction = jnp.where(ts[-1] >= ts[0], 1.0, -1.0).astype(ts.dtype)
            needs_flip = True
        else:
            import numpy as _np

            needs_flip = bool(_np.asarray(ts)[1] < _np.asarray(ts)[0])
            direction = jnp.asarray(-1.0, ts.dtype)
        if needs_flip:
            inner_f = f_flat
            f_flat = lambda s, y: direction * inner_f(direction * s, y)
            ts = direction * ts

    if method == "scipy_solver":
        ys_flat = _scipy_solve(
            func, unravel, y0_flat, ts, args,
            rtol=rtol, atol=atol, scipy_method=scipy_method,
        )
        stats = dict(nfe=jnp.asarray(-1, jnp.int32))
    elif method in _FIXED:
        ys_flat, nfe = fixed.odeint_fixed(
            f_flat, _FIXED[method], y0_flat, ts, steps_per_interval=steps_per_interval
        )
        stats = dict(nfe=nfe)
    elif method in _ADAMS:
        from graph_odenet_tpu.ode import adams

        ys_flat, nfe = adams.odeint_adams(
            f_flat, y0_flat, ts, steps_per_interval=steps_per_interval,
            corrector=_ADAMS[method],
        )
        stats = dict(nfe=nfe)
    elif method in ("adams", "adams_scan"):
        # torchdiffeq's "adams": variable-coefficient, variable-order
        # (1..max_order) Adams–Bashforth–Moulton (Shampine–Gordon).
        from graph_odenet_tpu.ode import vcabm

        if method == "adams":
            ys_flat, stats = vcabm.odeint_vcabm(
                f_flat, y0_flat, ts, rtol=rtol, atol=atol,
                max_steps=max_steps, first_step=first_step,
                max_order=max_order,
            )
        else:
            ys_flat, stats = vcabm.odeint_vcabm_scan(
                f_flat, y0_flat, ts, rtol=rtol, atol=atol,
                max_steps_per_interval=max_steps_per_interval,
                first_step=first_step, max_order=max_order,
            )
    elif method in _ADAPTIVE:
        ys_flat, stats = adaptive.odeint_adaptive(
            f_flat, y0_flat, ts, tab=_ADAPTIVE[method],
            rtol=rtol, atol=atol, max_steps=max_steps, first_step=first_step,
        )
    elif method.endswith("_scan") and method[:-5] in _ADAPTIVE:
        ys_flat, stats = adaptive.odeint_adaptive_scan(
            f_flat, y0_flat, ts, tab=_ADAPTIVE[method[:-5]],
            rtol=rtol, atol=atol,
            max_steps_per_interval=max_steps_per_interval, first_step=first_step,
        )
    else:
        raise ValueError(f"unknown method {method!r}; choose from {SOLVERS}")

    ys = jax.vmap(unravel)(ys_flat)
    return (ys, stats) if return_stats else ys


def _odeint_ckpt_forward(
    func: Callable,
    y0: Any,
    ts: jax.Array,
    *args,
    method: str = "dopri5",
    rtol: float = 1e-7,
    atol: float = 1e-9,
    steps_per_interval: int = 1,
    max_steps_per_interval: int = 64,
    first_step: float | None = None,
    **_ignored,
):
    """Forward solve that also returns the accepted-step trace (flat).

    Backbone of the checkpointed adjoint: fixed-grid methods emit their
    (statically known) substep grid as the trace; explicit adaptive
    methods run the trace-capturing clipped ``while_loop`` solver
    (``adaptive.odeint_adaptive_ckpt``).  ``_scan`` suffixes are stripped —
    the checkpoint path never differentiates through the forward, so the
    bounded-scan variants' masked compute would be pure waste.

    Returns ``(ys, stats, trace)`` — ys as a pytree, trace flat
    (``{t, y[K, D], acc_at_target, n_steps, ok}``).
    """
    ts = jnp.asarray(ts)
    y0_flat, unravel, f_flat = _ravel_problem(func, y0, args)
    ts = ts.astype(y0_flat.dtype)
    base = method[:-5] if method.endswith("_scan") else method
    if base in _FIXED:
        S = max(int(steps_per_interval), 1)
        T = ts.shape[0]
        frac = (jnp.arange(S, dtype=ts.dtype) / S)[None, :]
        seg = ts[:-1, None] + (ts[1:] - ts[:-1])[:, None] * frac
        ts_fine = jnp.concatenate([seg.reshape(-1), ts[-1:]])
        ys_fine, nfe = fixed.odeint_fixed(
            f_flat, _FIXED[base], y0_flat, ts_fine, steps_per_interval=1
        )
        acc_at_target = jnp.arange(T, dtype=jnp.int32) * S
        ys_flat = ys_fine[acc_at_target]
        stats = dict(nfe=nfe)
        trace = dict(
            t=ts_fine, y=ys_fine, acc_at_target=acc_at_target,
            n_steps=jnp.asarray((T - 1) * S, jnp.int32),
            ok=jnp.asarray(True),
        )
    elif base in _ADAPTIVE:
        ys_flat, stats, trace = adaptive.odeint_adaptive_ckpt(
            f_flat, y0_flat, ts, tab=_ADAPTIVE[base], rtol=rtol, atol=atol,
            trace_per_interval=max_steps_per_interval, first_step=first_step,
        )
    else:
        raise ValueError(
            f"checkpoint adjoint supports fixed-grid and explicit adaptive "
            f"methods, not {method!r} (adams/scipy have no step trace)"
        )
    ys = jax.vmap(unravel)(ys_flat)
    return ys, stats, trace


def odeint_adjoint(
    func: Callable,
    y0: Any,
    ts: jax.Array,
    *args,
    method: str = "dopri5",
    rtol: float = 1e-7,
    atol: float = 1e-9,
    return_stats: bool = False,
    checkpoint: bool = False,
    bwd_method: str = "rk4",
    bwd_substeps: int = 1,
    **options,
):
    """``odeint`` with O(1)-memory gradients via the continuous adjoint.

    Reverse pass solves the augmented ODE ``[y, a, ∂L/∂args]`` backwards
    between requested times — the jittable equivalent of torchdiffeq's
    ``OdeintAdjointMethod`` (SURVEY.md §3.5).  Unlike torchdiffeq, the
    forward solve's stats (NFE, …) are surfaced (``return_stats=True``)
    even though the solve lives inside a ``custom_vjp``.

    ``checkpoint=True`` selects the checkpointed-forward adjoint: the
    forward stores its accepted-step states (O(steps) memory) and the
    reverse augmented solve reads y from storage — fixed ``bwd_method``
    steps (``bwd_substeps`` per stored step) over the stored grid instead
    of a second adaptive integration, with no backward-in-time y drift.
    The at-scale training path (VERDICT r4 #3).
    """
    from graph_odenet_tpu.ode.adjoint import (
        _odeint_adjoint_impl, _odeint_ckpt_adjoint_impl,
    )

    opts = dict(method=method, rtol=rtol, atol=atol, **options)
    opts.pop("return_stats", None)  # the impl always requests stats
    if checkpoint:
        opts["bwd_method"] = bwd_method
        opts["bwd_substeps"] = int(bwd_substeps)
        ys, stats = _odeint_ckpt_adjoint_impl(
            func, tuple(sorted(opts.items())), y0, ts, *args
        )
    else:
        ys, stats = _odeint_adjoint_impl(
            func, tuple(sorted(opts.items())), y0, ts, *args
        )
    return (ys, stats) if return_stats else ys
