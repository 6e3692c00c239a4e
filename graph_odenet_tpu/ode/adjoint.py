"""Continuous adjoint — O(1)-memory gradients through ``odeint``.

Parity target: torchdiffeq's ``OdeintAdjointMethod`` (SURVEY.md §2 T4,
§3.5): the backward pass never stores the forward trajectory between
requested times; instead it re-integrates the augmented system

    d/dt [ y, a, ĝ_t, ĝ_args ] = [ f,  −aᵀ∂f/∂y,  −aᵀ∂f/∂t,  −aᵀ∂f/∂args ]

in reverse, seeded at each requested time with the incoming cotangent.
Reverse time is handled with the substitution s = −t (our solvers integrate
increasing grids only), under which every augmented component simply flips
sign via the vjp of ``f`` evaluated at −s.

Implemented as ``jax.custom_vjp`` so it composes with jit / scan / pjit and
works for *any* forward method, including the non-differentiable
``lax.while_loop`` dopri5.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from graph_odenet_tpu.ode import tableaus as _tabs
from graph_odenet_tpu.ode.tableaus import rk_step

__all__ = ["_odeint_adjoint_impl", "_odeint_ckpt_adjoint_impl"]


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _odeint_adjoint_impl(func, opts, y0, ts, *args):
    from graph_odenet_tpu.ode.api import odeint

    # Always request stats: the forward solve inside the custom_vjp is the
    # only place they exist, and hiding them forced consumers (ODEBlock,
    # ode_model_bench) to probe NFE through a non-adjoint twin.  They ride
    # along as a primal output (integer leaves → float0 cotangents).
    kw = dict(opts)
    kw["return_stats"] = True
    return odeint(func, y0, ts, *args, **kw)


def _fwd(func, opts, y0, ts, *args):
    ys, stats = _odeint_adjoint_impl(func, opts, y0, ts, *args)
    return (ys, stats), (ys, ts, args)


def _bwd(func, opts, residuals, g):
    from graph_odenet_tpu.ode.api import odeint

    ys, ts, args = residuals
    g = g[0]  # cotangent of ys; the stats cotangent is symbolic-zero
    kw = dict(opts)
    # Backward integration reuses the forward solver settings; the
    # while-loop dopri5 is fine here (the adjoint IS the gradient path).
    bwd_kw = dict(kw)
    bwd_kw["return_stats"] = False

    def aug_dynamics(s, aug, *args):
        """Augmented dynamics in reversed time s = −t."""
        y, y_bar, _, _ = aug
        f_eval, vjp_fn = jax.vjp(lambda y_, t_, *a_: func(t_, y_, *a_), y, -s, *args)
        vy, vt, *vargs = vjp_fn(y_bar)
        # d/ds flips the sign of dy/dt; the adjoint components get −(−aᵀ∂f/∂·).
        return (
            jax.tree_util.tree_map(jnp.negative, f_eval),
            vy,
            vt,
            tuple(vargs),
        )

    def y_at(i):
        return jax.tree_util.tree_map(lambda a: a[i], ys)

    def g_at(i):
        return jax.tree_util.tree_map(lambda a: a[i], g)

    T = ts.shape[0]
    zeros_args = jax.tree_util.tree_map(jnp.zeros_like, args)

    def scan_fun(carry, i):
        y_bar, t0_bar, args_bar = carry
        yi, gi = y_at(i), g_at(i)
        # Effect of perturbing the i-th measurement time.
        f_i = func(ts[i], yi, *args)
        t_bar = sum(
            jnp.vdot(fl, gl)
            for fl, gl in zip(jax.tree_util.tree_leaves(f_i), jax.tree_util.tree_leaves(gi))
        )
        t0_bar = t0_bar - t_bar
        aug0 = (yi, y_bar, t0_bar, args_bar)
        span = jnp.stack([-ts[i], -ts[i - 1]])
        aug_path = odeint(aug_dynamics, aug0, span, *args, **bwd_kw)
        _, y_bar, t0_bar, args_bar = jax.tree_util.tree_map(
            lambda a: a[1], aug_path
        )
        y_bar = jax.tree_util.tree_map(jnp.add, y_bar, g_at(i - 1))
        return (y_bar, t0_bar, args_bar), t_bar

    init = (g_at(T - 1), jnp.zeros_like(ts[0]), zeros_args)
    (y0_bar, t0_bar, args_bar), rev_ts_bar = jax.lax.scan(
        scan_fun, init, jnp.arange(T - 1, 0, -1)
    )
    ts_bar = jnp.concatenate([t0_bar[None], rev_ts_bar[::-1]])
    return (y0_bar, ts_bar, *args_bar)


_odeint_adjoint_impl.defvjp(_fwd, _bwd)


# ---------------------------------------------------------------------------
# Checkpointed-forward adjoint (VERDICT r4 #3).
#
# The plain continuous adjoint above re-integrates y *adaptively* backwards
# alongside the cotangents — a second controller-driven solve whose step
# count is unrelated to the forward's, and whose y drifts from the forward
# trajectory.  Here the forward stores every accepted state (O(accepted
# steps)·|y| device memory — far less than direct backprop, which stores
# every stage's activations) and the reverse sweep takes exactly one
# fixed ``bwd_method`` step (default rk4, ``bwd_substeps`` subdivisions)
# per stored step, with the y component re-anchored at the stored value at
# every step boundary: no controller work, no rejected backward steps, no
# Hairer init probes, no drift.
# ---------------------------------------------------------------------------

_BWD_TABLEAUS = {
    "euler": _tabs.EULER,
    "midpoint": _tabs.MIDPOINT,
    "heun2": _tabs.HEUN2,
    "heun3": _tabs.HEUN3,
    "rk4": _tabs.RK4_38,       # torchdiffeq's rk4 = Kutta 3/8
    "rk4_classic": _tabs.RK4,
    "adaptive_heun": _tabs.HEUN12,
    "fehlberg2": _tabs.FEHLBERG2,
    "bosh3": _tabs.BOSH3,
    "dopri5": _tabs.DOPRI5,
    "dopri8": _tabs.DOPRI8,
}


def _split_opts(opts):
    kw = dict(opts)
    bwd_method = kw.pop("bwd_method", "rk4")
    bwd_substeps = int(kw.pop("bwd_substeps", 1))
    return kw, bwd_method, bwd_substeps


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _odeint_ckpt_adjoint_impl(func, opts, y0, ts, *args):
    from graph_odenet_tpu.ode.api import _odeint_ckpt_forward

    kw, _, _ = _split_opts(opts)
    ys, stats, _ = _odeint_ckpt_forward(func, y0, ts, *args, **kw)
    return ys, stats


def _ckpt_fwd(func, opts, y0, ts, *args):
    from graph_odenet_tpu.ode.api import _odeint_ckpt_forward

    kw, _, _ = _split_opts(opts)
    ys, stats, trace = _odeint_ckpt_forward(func, y0, ts, *args, **kw)
    res = (
        ys, ts, args,
        trace["t"], trace["y"], trace["acc_at_target"], trace["n_steps"],
    )
    return (ys, stats), res


def _ckpt_bwd(func, opts, residuals, g):
    ys, ts, args, trace_t, trace_y, acc_at_target, n_steps = residuals
    g = g[0]  # cotangent of ys; stats cotangent is symbolic-zero
    _, bwd_method, nsub = _split_opts(opts)
    tab = _BWD_TABLEAUS[bwd_method]

    y0_flat, unravel_y = ravel_pytree(
        jax.tree_util.tree_map(lambda a: a[0], ys)
    )
    args_flat, unravel_args = ravel_pytree(args)
    D, P = y0_flat.shape[0], args_flat.shape[0]
    dtype = y0_flat.dtype

    def f_af(t, y_flat, a_flat):
        dy = func(t, unravel_y(y_flat), *unravel_args(a_flat))
        return ravel_pytree(dy)[0]

    ys_flat = jax.vmap(lambda yi: ravel_pytree(yi)[0])(ys)   # [T, D]
    g_flat = jax.vmap(lambda gi: ravel_pytree(gi)[0])(g)     # [T, D]
    # Output-time perturbation gradients: ∂L/∂t_i = ⟨f(t_i, y_i), g_i⟩.
    # Static unroll over the (small) output grid.
    f_at = jnp.stack([
        f_af(ts[i].astype(dtype), ys_flat[i], args_flat)
        for i in range(ts.shape[0])
    ])
    t_bar = jnp.einsum("td,td->t", f_at, g_flat)

    def aug_dyn(s, w):
        """Augmented dynamics in reversed time s = −t on the flat state
        ``[y (D) | a (D) | t0_bar (1) | args_bar (P)]``."""
        y, a = w[:D], w[D: 2 * D]
        f_eval, vjp_fn = jax.vjp(
            lambda y_, t_, p_: f_af(t_, y_, p_), y, -s, args_flat
        )
        vy, vt, vp = vjp_fn(a)
        return jnp.concatenate([-f_eval, vy, vt[None], vp])

    acc_tail = acc_at_target[1:]
    g_tail = g_flat[1:]
    tbar_tail = t_bar[1:]

    def body(kk, carry):
        y_bar, t0_bar, args_bar = carry
        j = n_steps - kk                      # stored step index, high → low
        # Cotangent injection where output time i is the boundary of step j
        # (the forward clips steps to land exactly on output times).
        m = (acc_tail == j).astype(dtype)     # [T-1]
        y_bar = y_bar + m @ g_tail
        t0_bar = t0_bar - jnp.vdot(m, tbar_tail)
        t1 = trace_t[j]
        h = (t1 - trace_t[j - 1]) / nsub
        w = jnp.concatenate([trace_y[j], y_bar, t0_bar[None], args_bar])
        for i in range(nsub):                 # static unroll (nsub is tiny)
            s0 = -t1 + i * h
            w, _, _, _ = rk_step(
                func=aug_dyn, tab=tab, t0=s0, y0=w, f0=aug_dyn(s0, w),
                dt=h, compute_f1=False,
            )
        return (w[D: 2 * D], w[2 * D], w[2 * D + 1:])

    init = (
        jnp.zeros((D,), dtype), jnp.zeros((), dtype), jnp.zeros((P,), dtype)
    )
    # Dynamic trip count (lowered to while_loop — fine inside a custom bwd):
    # exactly n_steps backward steps, zero masked waste from the budget.
    y_bar, t0_bar, args_bar = jax.lax.fori_loop(0, n_steps, body, init)

    y0_bar = unravel_y(y_bar + g_flat[0])
    ts_bar = jnp.concatenate([t0_bar[None], t_bar[1:]]).astype(ts.dtype)
    return (y0_bar, ts_bar, *unravel_args(args_bar))


_odeint_ckpt_adjoint_impl.defvjp(_ckpt_fwd, _ckpt_bwd)
