"""ODE solver unit tests (SURVEY.md §4.1): closed-form problems, convergence
order, dopri5 controller behaviour, dense output, gradients, composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.ode import odeint, odeint_adjoint

# --- closed-form problems (torchdiffeq-style tests/problems.py) -----------


def exp_decay(t, y):
    return -0.5 * y


def exp_decay_sol(t, y0):
    # Reference values in numpy so they stay correctly rounded even if the
    # suite ever runs on an accelerator with approximate transcendentals.
    return y0 * np.exp(-0.5 * np.asarray(t))


def oscillator(t, y):
    # y = (q, p): harmonic oscillator, period 2π.
    return jnp.stack([y[1], -y[0]])


def oscillator_sol(t):
    t = np.asarray(t)
    return np.stack([np.cos(t), -np.sin(t)])


def forced(t, y):
    # Time-dependent: dy/dt = sin(t); y = 1 − cos(t) from y0=0.
    return jnp.sin(t) * jnp.ones_like(y)


TS = jnp.linspace(0.0, 2.0, 9)


@pytest.mark.parametrize(
    "method", ["euler", "midpoint", "heun2", "heun3", "rk4", "rk4_classic"]
)
def test_fixed_methods_solve_exp_decay(method):
    y0 = jnp.array([1.0, 2.0])
    ys = odeint(exp_decay, y0, TS, method=method, steps_per_interval=8)
    expected = np.stack([exp_decay_sol(t, np.asarray(y0)) for t in np.asarray(TS)])
    tol = {"euler": 2e-2, "midpoint": 1e-3, "heun2": 1e-3, "heun3": 1e-4,
           "rk4": 1e-6, "rk4_classic": 1e-6}
    np.testing.assert_allclose(
        np.asarray(ys), np.asarray(expected), atol=tol[method]
    )


@pytest.mark.parametrize(
    "method,order",
    [("euler", 1), ("midpoint", 2), ("heun2", 2), ("heun3", 3),
     ("rk4", 4), ("rk4_classic", 4)],
)
def test_fixed_methods_convergence_order(method, order):
    y0 = jnp.array([1.0])
    ts = jnp.array([0.0, 1.0])
    errs = []
    for n in (4, 8, 16):
        ys = odeint(exp_decay, y0, ts, method=method, steps_per_interval=n)
        errs.append(abs(float(ys[-1, 0]) - float(np.exp(-0.5))))
    rate01 = np.log2(errs[0] / errs[1])
    rate12 = np.log2(errs[1] / errs[2])
    assert rate01 > order - 0.3, (method, errs)
    assert rate12 > order - 0.3, (method, errs)


@pytest.mark.parametrize("method", ["dopri5", "dopri5_scan"])
def test_adaptive_solves_oscillator_to_tolerance(method):
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.linspace(0.0, 2 * np.pi, 20)
    ys, stats = odeint(
        exp_decay if False else oscillator,
        y0, ts, method=method, rtol=1e-6, atol=1e-8, return_stats=True,
    )
    expected = oscillator_sol(np.asarray(ts)).T
    np.testing.assert_allclose(np.asarray(ys), np.asarray(expected), atol=1e-4)
    assert int(stats["nfe"]) > 0


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_adams_methods_solve_exp_decay(method):
    y0 = jnp.array([1.0, 2.0])
    ys = odeint(exp_decay, y0, TS, method=method, steps_per_interval=8)
    expected = np.stack([exp_decay_sol(t, np.asarray(y0)) for t in np.asarray(TS)])
    np.testing.assert_allclose(np.asarray(ys), np.asarray(expected), atol=1e-6)


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_adams_convergence_order_4(method):
    y0 = jnp.array([1.0])
    ts = jnp.array([0.0, 1.0])
    errs = []
    for n in (8, 16, 32):
        ys = odeint(exp_decay, y0, ts, method=method, steps_per_interval=n)
        errs.append(abs(float(ys[-1, 0]) - float(np.exp(-0.5))))
    rate01 = np.log2(errs[0] / errs[1])
    rate12 = np.log2(errs[1] / errs[2])
    assert rate01 > 3.6, (method, errs)
    assert rate12 > 3.6, (method, errs)


def test_adams_fewer_nfe_than_rk4():
    """The point of multistep: fewer dynamics evals per step than RK4."""
    y0 = jnp.array([1.0, 0.0])
    _, s_ab = odeint(
        oscillator, y0, TS, method="explicit_adams", steps_per_interval=16,
        return_stats=True,
    )
    _, s_rk = odeint(
        oscillator, y0, TS, method="rk4", steps_per_interval=16,
        return_stats=True,
    )
    assert int(s_ab["nfe"]) < int(s_rk["nfe"]) * 0.5, (
        int(s_ab["nfe"]), int(s_rk["nfe"])
    )


def test_grad_through_adams():
    def loss(k):
        ys = odeint(
            lambda t, y: -k * y, jnp.array([1.0]), jnp.array([0.0, 1.0]),
            method="implicit_adams", steps_per_interval=16,
        )
        return ys[-1, 0]

    g = jax.grad(loss)(jnp.asarray(0.7))
    np.testing.assert_allclose(float(g), -np.exp(-0.7), rtol=1e-4)


@pytest.mark.parametrize(
    "method",
    ["bosh3", "bosh3_scan", "adaptive_heun", "fehlberg2",
     "dopri8", "dopri8_scan"],
)
def test_other_adaptive_methods_solve_oscillator(method):
    """torchdiffeq's remaining explicit adaptive zoo (SURVEY.md §2 T3)."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.linspace(0.0, 2 * np.pi, 20)
    ys, stats = odeint(
        oscillator, y0, ts, method=method, rtol=1e-6, atol=1e-8,
        return_stats=True, max_steps_per_interval=512,
    )
    expected = oscillator_sol(np.asarray(ts)).T
    # Low-order pairs control the *embedded* (lower-order) solution while
    # propagating the higher one (local extrapolation), so global error can
    # exceed the tolerance by a modest constant — same as torchdiffeq.
    # dopri8 takes ~0.7-radian steps here, so the 4th-order dense-output
    # quartic (same interpolant torchdiffeq uses for dopri8) dominates the
    # mid-interval error — in both variants, since the scan solver shares
    # the while-loop solver's natural (unclipped) steps + interpolation.
    tol = {"bosh3": 1e-4, "bosh3_scan": 1e-4,
           "adaptive_heun": 2e-4, "fehlberg2": 5e-4,
           "dopri8": 5e-4, "dopri8_scan": 5e-4}[method]
    np.testing.assert_allclose(np.asarray(ys), np.asarray(expected), atol=tol)
    assert int(stats["nfe"]) > 0


def test_lower_order_adaptive_needs_more_steps():
    """Order sanity: at equal tolerance, heun (2nd) > bosh3 (3rd) > dopri5
    (5th) in function evaluations."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 2 * np.pi])
    nfe = {}
    for m in ("adaptive_heun", "bosh3", "dopri5"):
        _, stats = odeint(
            oscillator, y0, ts, method=m, rtol=1e-6, atol=1e-8,
            return_stats=True,
        )
        nfe[m] = int(stats["nfe"])
    assert nfe["adaptive_heun"] > nfe["bosh3"] > nfe["dopri5"], nfe


def test_grad_through_bosh3_scan():
    def loss(k):
        ys = odeint(
            lambda t, y: -k * y, jnp.array([1.0]), jnp.array([0.0, 1.0]),
            method="bosh3_scan", rtol=1e-6, atol=1e-8,
            max_steps_per_interval=256,
        )
        return ys[-1, 0]

    k = jnp.asarray(0.7)
    g = jax.grad(loss)(k)
    # d/dk exp(-k) = -exp(-k)
    np.testing.assert_allclose(float(g), -np.exp(-0.7), rtol=1e-4)


def test_dopri8_tableau_order_conditions():
    """The PD8(7)13M coefficients satisfy row-sum and quadrature conditions
    (the full order-8 proof is Prince & Dormand 1981; these linear conditions
    plus the empirical-order test below catch any transcription error)."""
    from graph_odenet_tpu.ode.tableaus import DOPRI8

    a, b, c = DOPRI8.a, DOPRI8.b, DOPRI8.c
    np.testing.assert_allclose(a.sum(axis=1), c, atol=1e-14)
    b_hat = b - DOPRI8.b_err
    for k in range(1, 9):
        np.testing.assert_allclose(
            (b * c ** (k - 1)).sum(), 1.0 / k, atol=1e-14
        )
    for k in range(1, 8):
        np.testing.assert_allclose(
            (b_hat * c ** (k - 1)).sum(), 1.0 / k, atol=1e-14
        )
    # A few deeper rooted-tree conditions (order 3–5).
    ac = a @ c
    for got, want in [
        (b @ ac, 1 / 6), (b @ (c * ac), 1 / 8), (b @ (a @ c**2), 1 / 12),
        (b @ (a @ ac), 1 / 24), ((b * ac) @ ac, 1 / 20),
        (b @ (a @ (a @ ac)), 1 / 120),
    ]:
        np.testing.assert_allclose(got, want, atol=1e-14)
    # Midpoint dense-output weights: continuous-extension conditions at θ=1/2.
    cm = np.asarray(DOPRI8.c_mid)
    np.testing.assert_allclose(cm.sum(), 0.5, atol=1e-12)
    np.testing.assert_allclose((cm * c).sum(), 0.125, atol=1e-12)
    np.testing.assert_allclose(cm @ ac, 0.5**3 / 6, atol=1e-12)


def test_dopri8_empirical_convergence_order():
    """Fixed-grid runs of the dopri8 tableau on y' = y·cos t converge at
    ~O(h^8) — the strongest end-to-end check of the stage matrix."""
    from graph_odenet_tpu.ode import fixed
    from graph_odenet_tpu.ode.tableaus import DOPRI8

    def f(t, y):
        return y * jnp.cos(t)

    y0 = jnp.array([1.0], dtype=jnp.float64)
    ts = jnp.array([0.0, 2.0], dtype=jnp.float64)
    exact = np.exp(np.sin(2.0))
    errs = []
    for n in (4, 8, 16):
        ys, _ = fixed.odeint_fixed(f, DOPRI8, y0, ts, steps_per_interval=n)
        errs.append(abs(float(ys[-1, 0]) - exact))
    rate01 = np.log2(errs[0] / errs[1])
    rate12 = np.log2(errs[1] / errs[2])
    assert rate01 > 7.3, errs
    assert rate12 > 7.3, errs


def test_dopri8_fewer_steps_than_dopri5_at_tight_tolerance():
    """The reason dopri8 exists: at tight tolerances the 8th-order method
    needs fewer dynamics evaluations than dopri5."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 2 * np.pi])
    nfe = {}
    for m in ("dopri5", "dopri8"):
        _, stats = odeint(
            oscillator, y0, ts, method=m, rtol=1e-10, atol=1e-12,
            return_stats=True,
        )
        nfe[m] = int(stats["nfe"])
    assert nfe["dopri8"] < nfe["dopri5"], nfe


def test_fixed_adams_is_implicit_adams_alias():
    """torchdiffeq exposes the ABM predictor-corrector as both
    ``implicit_adams`` and ``fixed_adams``."""
    y0 = jnp.array([1.0, 2.0])
    a = odeint(exp_decay, y0, TS, method="fixed_adams", steps_per_interval=8)
    b = odeint(exp_decay, y0, TS, method="implicit_adams", steps_per_interval=8)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scipy_solver_host_fallback():
    """torchdiffeq's ``scipy_solver`` parity: host-side solve_ivp for
    cross-validation, routed through ``jax.pure_callback`` so it composes
    with jit."""
    pytest.importorskip("scipy")
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.linspace(0.0, 2 * np.pi, 20)
    ys = odeint(
        oscillator, y0, ts, method="scipy_solver", rtol=1e-8, atol=1e-10
    )
    expected = oscillator_sol(np.asarray(ts)).T
    np.testing.assert_allclose(np.asarray(ys), expected, atol=1e-5)

    ys_jit = jax.jit(
        lambda y: odeint(
            oscillator, y, ts, method="scipy_solver", rtol=1e-8, atol=1e-10
        )
    )(y0)
    np.testing.assert_allclose(np.asarray(ys_jit), expected, atol=1e-5)


def test_scipy_solver_traced_args_threading():
    """Traced values the dynamics needs must flow through ``*args`` — the
    callback ravels them to the host (api.py ``_scipy_solve``)."""
    pytest.importorskip("scipy")
    y0 = jnp.array([1.0, 2.0])
    ts = jnp.linspace(0.0, 2.0, 5)

    def dyn(t, y, rate):
        return -rate * y

    @jax.jit
    def solve(rate):
        return odeint(dyn, y0, ts, rate, method="scipy_solver",
                      rtol=1e-8, atol=1e-10)

    ys = solve(jnp.asarray(0.5))
    expected = np.stack([exp_decay_sol(t, np.asarray(y0)) for t in np.asarray(ts)])
    np.testing.assert_allclose(np.asarray(ys), expected, atol=1e-6)


def test_dopri5_nfe_scales_with_tolerance():
    """Tighter tolerance ⇒ more function evaluations (controller works)."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 2 * np.pi])
    nfes = []
    for rtol in (1e-3, 1e-6, 1e-9):
        _, stats = odeint(
            oscillator, y0, ts, method="dopri5", rtol=rtol, atol=rtol * 1e-2,
            return_stats=True,
        )
        nfes.append(int(stats["nfe"]))
    assert nfes[0] < nfes[1] < nfes[2], nfes
    # Sanity: a period of the oscillator at 1e-6 should take a few dozen
    # steps, not thousands (accept/reject machinery not thrashing).
    assert nfes[1] < 1200, nfes


def test_dopri5_dense_output_is_high_order():
    """Requested times are interpolated, not stepped-to: check mid-interval
    accuracy on the forced problem with a large-step trajectory."""
    y0 = jnp.array([0.0])
    ts = jnp.linspace(0.0, 3.0, 50)  # many outputs, few solver steps
    ys, stats = odeint(
        forced, y0, ts, method="dopri5", rtol=1e-8, atol=1e-10,
        return_stats=True,
    )
    expected = 1.0 - np.cos(np.asarray(ts))
    np.testing.assert_allclose(np.asarray(ys[:, 0]), expected, atol=1e-6)
    # Dense output means dozens of outputs don't force dozens of extra steps:
    # nfe must be far less than 6 × (steps needed if each of 49 intervals
    # took its own adaptive restart).
    assert int(stats["n_accept"]) < 100


def test_time_dependent_dynamics():
    y0 = jnp.array([0.0])
    ts = jnp.linspace(0.0, 3.0, 7)
    for method in ("rk4", "dopri5", "dopri5_scan"):
        ys = odeint(forced, y0, ts, method=method, rtol=1e-7, atol=1e-9,
                    steps_per_interval=16)
        np.testing.assert_allclose(
            np.asarray(ys[:, 0]), 1.0 - np.cos(np.asarray(ts)), atol=1e-4
        )


def test_pytree_state():
    y0 = {"a": jnp.ones((2, 3)), "b": jnp.zeros(4)}
    f = lambda t, y: jax.tree_util.tree_map(lambda x: -x, y)
    ys = odeint(f, y0, jnp.array([0.0, 1.0]), method="rk4", steps_per_interval=8)
    np.testing.assert_allclose(
        np.asarray(ys["a"][-1]), np.exp(-1.0) * np.ones((2, 3)), atol=1e-5
    )
    assert ys["b"].shape == (2, 4)


def test_args_threading():
    f = lambda t, y, k: -k * y
    ys = odeint(f, jnp.array([1.0]), jnp.array([0.0, 1.0]), 2.0,
                method="rk4", steps_per_interval=16)
    np.testing.assert_allclose(float(ys[-1, 0]), np.exp(-2.0), atol=1e-5)


# --- differentiation ------------------------------------------------------


def _terminal_loss(method, **kw):
    def loss(k):
        f = lambda t, y, k: -k * y
        ys = odeint(f, jnp.array([1.0]), jnp.array([0.0, 1.0]), k,
                    method=method, **kw)
        return ys[-1, 0]

    return loss


@pytest.mark.parametrize(
    "method,kw",
    [
        ("rk4", dict(steps_per_interval=32)),
        ("dopri5_scan", dict(rtol=1e-8, atol=1e-10)),
    ],
)
def test_grad_through_solver_matches_analytic(method, kw):
    # d/dk exp(-k) = -exp(-k)
    g = jax.grad(_terminal_loss(method, **kw))(1.0)
    np.testing.assert_allclose(float(g), -np.exp(-1.0), rtol=1e-4)


def test_grad_check_fixed():
    from jax.test_util import check_grads

    def f(k):
        return _terminal_loss("rk4", steps_per_interval=16)(k)

    check_grads(f, (0.7,), order=1, modes=["rev"], atol=1e-3, rtol=1e-3)


def test_adjoint_grad_matches_analytic():
    def loss(k):
        f = lambda t, y, k: -k * y
        ys = odeint_adjoint(
            f, jnp.array([1.0]), jnp.array([0.0, 1.0]), k,
            method="dopri5", rtol=1e-8, atol=1e-10,
        )
        return ys[-1, 0]

    g = jax.grad(loss)(1.0)
    np.testing.assert_allclose(float(g), -np.exp(-1.0), rtol=1e-4)


def test_adjoint_grad_y0_and_multiple_times():
    def loss(y0):
        ys = odeint_adjoint(
            lambda t, y: -y, y0, jnp.linspace(0.0, 1.0, 5),
            method="dopri5", rtol=1e-8, atol=1e-10,
        )
        return jnp.sum(ys[-1]) + jnp.sum(ys[2])

    y0 = jnp.array([1.0, 2.0])
    g = jax.grad(loss)(y0)
    expected = np.exp(-1.0) + np.exp(-0.5)
    np.testing.assert_allclose(np.asarray(g), expected * np.ones(2), rtol=1e-4)


def test_adjoint_surfaces_forward_stats():
    """The adjoint's forward solve stats (NFE, …) ride through the
    custom_vjp as a primal output — no −1 sentinel (VERDICT r4 #6)."""
    f = lambda t, y: -y
    y0, ts = jnp.array([1.0]), jnp.array([0.0, 1.0])
    ys, stats = odeint_adjoint(
        f, y0, ts, method="dopri5", rtol=1e-6, atol=1e-8, return_stats=True
    )
    _, stats_direct = odeint(
        f, y0, ts, method="dopri5", rtol=1e-6, atol=1e-8, return_stats=True
    )
    assert int(stats["nfe"]) == int(stats_direct["nfe"]) > 0
    # Stats must not break differentiation of the primal output.
    g = jax.grad(
        lambda k: odeint_adjoint(
            lambda t, y, k: -k * y, y0, ts, k,
            method="dopri5", rtol=1e-8, atol=1e-10, return_stats=True,
        )[0][-1, 0]
    )(1.0)
    np.testing.assert_allclose(float(g), -np.exp(-1.0), rtol=1e-4)


def test_adjoint_matches_direct_backprop():
    """Adjoint and discretize-then-optimize agree on a nonlinear problem."""
    w = jnp.array([[0.1, -0.4], [0.7, 0.2]])

    def f(t, y, w):
        return jnp.tanh(w @ y)

    y0 = jnp.array([0.5, -0.3])
    ts = jnp.array([0.0, 1.0])

    def loss_direct(w):
        return jnp.sum(odeint(f, y0, ts, w, method="rk4", steps_per_interval=64)[-1])

    def loss_adj(w):
        return jnp.sum(
            odeint_adjoint(f, y0, ts, w, method="dopri5", rtol=1e-9, atol=1e-11)[-1]
        )

    g1 = jax.grad(loss_direct)(w)
    g2 = jax.grad(loss_adj)(w)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-4)


# --- checkpointed-forward adjoint (VERDICT r4 #3) -------------------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(method="dopri5", rtol=1e-8, atol=1e-10),
        dict(method="dopri5", rtol=1e-8, atol=1e-10, bwd_method="dopri5"),
        dict(method="rk4", steps_per_interval=32),
        dict(method="dopri5_scan", rtol=1e-8, atol=1e-10,
             max_steps_per_interval=64, bwd_substeps=2),
        dict(method="bosh3", rtol=1e-7, atol=1e-9, bwd_method="bosh3"),
    ],
)
def test_ckpt_adjoint_grad_matches_analytic(kw):
    def loss(k):
        f = lambda t, y, k: -k * y
        ys = odeint_adjoint(
            f, jnp.array([1.0]), jnp.array([0.0, 1.0]), k,
            checkpoint=True, **kw,
        )
        return ys[-1, 0]

    v, g = jax.value_and_grad(loss)(1.0)
    np.testing.assert_allclose(float(v), np.exp(-1.0), rtol=1e-5)
    np.testing.assert_allclose(float(g), -np.exp(-1.0), rtol=1e-4)


def test_ckpt_adjoint_param_and_y0_grads_match_direct():
    w0 = jnp.array([[0.1, -0.4], [0.7, 0.2]])
    y00 = jnp.array([0.5, -0.3])
    ts = jnp.array([0.0, 1.0])

    def f(t, y, w):
        return jnp.tanh(w @ y)

    def loss_direct(w, y0):
        return jnp.sum(
            odeint(f, y0, ts, w, method="rk4", steps_per_interval=64)[-1]
        )

    def loss_ckpt(w, y0):
        return jnp.sum(
            odeint_adjoint(
                f, y0, ts, w, method="dopri5", rtol=1e-9, atol=1e-11,
                checkpoint=True, bwd_method="dopri5",
            )[-1]
        )

    g1 = jax.grad(loss_direct, argnums=(0, 1))(w0, y00)
    g2 = jax.grad(loss_ckpt, argnums=(0, 1))(w0, y00)
    for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_ckpt_adjoint_multiple_output_times():
    """Cotangents inject at clipped step boundaries — parity with the plain
    adjoint on a loss touching an interior output time."""

    def loss(y0, ckpt):
        kw = dict(method="dopri5", rtol=1e-9, atol=1e-11)
        if ckpt:
            kw.update(checkpoint=True, bwd_method="dopri5")
        ys = odeint_adjoint(
            lambda t, y: -y, y0, jnp.linspace(0.0, 1.0, 5), **kw
        )
        return jnp.sum(ys[-1]) + jnp.sum(ys[2])

    y0 = jnp.array([1.0, 2.0])
    ga = jax.grad(lambda y: loss(y, False))(y0)
    gb = jax.grad(lambda y: loss(y, True))(y0)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), atol=1e-6)


def test_ckpt_adjoint_time_grad_and_stats():
    def loss(t1):
        ys = odeint_adjoint(
            lambda t, y: -y, jnp.array([1.0]), jnp.stack([0.0 * t1, t1]),
            method="dopri5", rtol=1e-9, atol=1e-11,
            checkpoint=True, bwd_method="dopri5", bwd_substeps=2,
        )
        return ys[-1, 0]

    g = jax.grad(loss)(0.8)
    np.testing.assert_allclose(float(g), -np.exp(-0.8), rtol=1e-4)

    _, stats = odeint_adjoint(
        lambda t, y: -y, jnp.array([1.0]), jnp.array([0.0, 1.0]),
        method="dopri5", rtol=1e-6, atol=1e-8,
        checkpoint=True, return_stats=True,
    )
    assert int(stats["nfe"]) > 0
    assert bool(stats["success"])


def test_ckpt_adjoint_rejects_traceless_methods():
    with pytest.raises(ValueError, match="checkpoint adjoint"):
        odeint_adjoint(
            lambda t, y: -y, jnp.array([1.0]), jnp.array([0.0, 1.0]),
            method="adams", checkpoint=True,
        )


def test_ckpt_adjoint_in_odeblock_model():
    """GCNODE with adjoint="checkpoint" produces finite grads that match
    the plain-adjoint model's on the same params."""
    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.models import GCNODE

    data = synthetic_planetoid("cora", seed=0, scale=0.05)
    adj = data.dense_adj()

    def make(adjoint):
        return GCNODE(
            hidden=8, n_class=data.n_class, method="dopri5_scan", steps=16,
            rtol=1e-5, atol=1e-7, adjoint=adjoint,
        )

    m_ck = make("checkpoint")
    params = m_ck.init(jax.random.PRNGKey(0), adj, data.features)

    def loss(m, p):
        out, _ = m.apply(p, adj, data.features, deterministic=True)
        return -jnp.mean(out[data.idx_train, data.labels[data.idx_train]])

    l_ck, g_ck = jax.value_and_grad(lambda p: loss(m_ck, p))(params)
    l_pl, g_pl = jax.value_and_grad(lambda p: loss(make(True), p))(params)
    np.testing.assert_allclose(float(l_ck), float(l_pl), rtol=1e-4)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_ck), jax.tree_util.tree_leaves(g_pl)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-3, rtol=2e-2
        )


# --- composition ----------------------------------------------------------


def test_jit_vmap_compose():
    @jax.jit
    def solve(y0):
        return odeint(oscillator, y0, jnp.array([0.0, 1.0]), method="dopri5",
                      rtol=1e-6, atol=1e-8)[-1]

    y0s = jnp.stack([jnp.array([1.0, 0.0]), jnp.array([0.0, 1.0])])
    out = jax.vmap(solve)(y0s)
    assert out.shape == (2, 2)
    np.testing.assert_allclose(
        np.asarray(out[0]), [np.cos(1.0), -np.sin(1.0)], atol=1e-5
    )

def test_reverse_time_integration():
    """Decreasing ts (torchdiffeq-supported) — all methods via −t transform."""
    y0 = jnp.array([1.0])
    ts = jnp.array([1.0, 0.0])  # integrate backwards: y(0) = y0·e^{+1}
    for method in ("rk4", "dopri5", "dopri5_scan"):
        ys = odeint(lambda t, y: -y, y0, ts, method=method,
                    steps_per_interval=16, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(float(ys[-1, 0]), np.e, rtol=1e-4)


def test_reverse_time_traced_grid():
    """A *traced* decreasing grid (ts passed through jit) must integrate
    correctly — the direction transform is applied as a traced scalar
    (api.py), not decided by host inspection."""
    y0 = jnp.array([1.0])

    for method in ("rk4", "dopri5", "dopri5_scan"):
        @jax.jit
        def solve(ts):
            return odeint(lambda t, y: -y, y0, ts, method=method,
                          steps_per_interval=16, rtol=1e-8, atol=1e-10)

        back = solve(jnp.array([1.0, 0.0]))
        np.testing.assert_allclose(float(back[-1, 0]), np.e, rtol=1e-4)
        # Same jitted program, increasing grid: direction = +1 identity.
        fwd = solve(jnp.array([0.0, 1.0]))
        np.testing.assert_allclose(float(fwd[-1, 0]), 1 / np.e, rtol=1e-4)


@pytest.mark.parametrize("method", ["dopri5", "bosh3", "dopri8"])
def test_scan_matches_while(method):
    """Given a sufficient step budget the scan solver is controller-identical
    to the while-loop solver: same trajectory, same accepted/rejected step
    counts, same NFE (VERDICT r2 #8 — the differentiable path no longer
    perturbs the controller by clipping steps to output times)."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.linspace(0.0, 2 * np.pi, 9)
    kw = dict(rtol=1e-6, atol=1e-8, return_stats=True)
    ys_w, s_w = odeint(oscillator, y0, ts, method=method, **kw)
    ys_s, s_s = odeint(oscillator, y0, ts, method=f"{method}_scan",
                       max_steps_per_interval=256, **kw)
    assert int(s_w["nfe"]) == int(s_s["nfe"])
    assert int(s_w["n_accept"]) == int(s_s["n_accept"])
    assert int(s_w["n_reject"]) == int(s_s["n_reject"])
    np.testing.assert_allclose(
        np.asarray(ys_w), np.asarray(ys_s), rtol=1e-6, atol=1e-9
    )


# --- VCABM: torchdiffeq's adaptive-order "adams" (VERDICT r2 #6) -----------


@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_vcabm_solves_oscillator(method):
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.linspace(0.0, 2 * np.pi, 20)
    ys, stats = odeint(
        oscillator, y0, ts, method=method, rtol=1e-6, atol=1e-8,
        return_stats=True, max_steps_per_interval=128,
    )
    expected = oscillator_sol(np.asarray(ts)).T
    np.testing.assert_allclose(np.asarray(ys), np.asarray(expected), atol=2e-4)
    assert bool(stats["success"])


@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_vcabm_solves_exp_decay_tight(method):
    y0 = jnp.array([1.0, 2.0])
    ys = odeint(exp_decay, y0, TS, method=method, rtol=1e-9, atol=1e-11,
                max_steps_per_interval=128)
    expected = np.stack(
        [exp_decay_sol(t, np.asarray(y0)) for t in np.asarray(TS)]
    )
    np.testing.assert_allclose(np.asarray(ys), expected, atol=1e-7)


def test_vcabm_order_adapts_up():
    """On a long smooth integration the order controller must climb well
    past the starting order 1 (the point of variable order)."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 4 * np.pi])
    _, stats = odeint(oscillator, y0, ts, method="adams",
                      rtol=1e-9, atol=1e-11, return_stats=True)
    assert bool(stats["success"])
    assert int(stats["final_order"]) >= 4, int(stats["final_order"])


def test_vcabm_fewer_nfe_than_dopri5():
    """The reason multistep exists: ~2 dynamics evals per accepted step vs
    dopri5's 6, so on a smooth problem at tight tolerance VCABM wins NFE."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 2 * np.pi])
    nfe = {}
    for m in ("adams", "dopri5"):
        _, stats = odeint(oscillator, y0, ts, method=m,
                          rtol=1e-8, atol=1e-10, return_stats=True)
        nfe[m] = int(stats["nfe"])
    assert nfe["adams"] < nfe["dopri5"], nfe


def test_vcabm_time_dependent_dynamics():
    y0 = jnp.array([0.0])
    ts = jnp.linspace(0.0, 3.0, 7)
    ys = odeint(forced, y0, ts, method="adams", rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(ys[:, 0]), 1.0 - np.cos(np.asarray(ts)), atol=1e-5
    )


def test_grad_through_vcabm_scan():
    def loss(k):
        ys = odeint(
            lambda t, y: -k * y, jnp.array([1.0]), jnp.array([0.0, 1.0]),
            method="adams_scan", rtol=1e-7, atol=1e-9,
            max_steps_per_interval=128,
        )
        return ys[-1, 0]

    g = jax.grad(loss)(jnp.asarray(0.7))
    np.testing.assert_allclose(float(g), -np.exp(-0.7), rtol=1e-4)


def test_vcabm_reverse_time():
    y0 = jnp.array([1.0])
    ys = odeint(lambda t, y: -y, y0, jnp.array([1.0, 0.0]), method="adams",
                rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(ys[-1, 0]), np.e, rtol=1e-5)


def test_vcabm_exhaustion_reported():
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 2 * np.pi])
    _, stats = odeint(oscillator, y0, ts, method="adams", rtol=1e-9,
                      atol=1e-12, max_steps=3, return_stats=True)
    assert not bool(stats["success"])
    assert float(stats["t_reached"]) < float(ts[-1])


def test_vcabm_gamma_star_constants():
    """γ* satisfies γ*_0 = 1, Σ_{j≤m} γ*_j/(m−j+1) = 0 (Hairer–Nørsett–
    Wanner); first values are the published 1, −1/2, −1/12, −1/24…"""
    from graph_odenet_tpu.ode.vcabm import gamma_star

    g = gamma_star(6)
    np.testing.assert_allclose(
        g, [1.0, -1 / 2, -1 / 12, -1 / 24, -19 / 720, -3 / 160], atol=1e-15
    )


@pytest.mark.parametrize("method", ["dopri5", "dopri5_scan"])
def test_adaptive_exhaustion_reported(method):
    """When the step budget runs out short of a target time the stats must
    say so (torchdiffeq raises; under jit we report success/t_reached)."""
    y0 = jnp.array([1.0, 0.0])
    ts = jnp.array([0.0, 2 * np.pi])
    kw = dict(rtol=1e-9, atol=1e-12, return_stats=True)
    lim = dict(max_steps=3) if method == "dopri5" else dict(
        max_steps_per_interval=3
    )
    _, stats = odeint(oscillator, y0, ts, method=method, **kw, **lim)
    assert not bool(stats["success"])
    assert float(stats["t_reached"]) < float(ts[-1])

    # Generous budget: the same solve succeeds and reaches the end.
    _, ok = odeint(oscillator, y0, ts, method=method, **kw,
                   max_steps_per_interval=2048)
    assert bool(ok["success"])
    assert float(ok["t_reached"]) >= float(ts[-1]) - 1e-6
