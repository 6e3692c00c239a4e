"""Physics trainers: discrete IN one-step prediction + autoregressive
rollout, and IN-ODE trajectory fitting (SURVEY.md §2 R11, §3.4).

Parity: the reference trains the interaction network on (state_t →
vel_{t+1}) pairs with MSE + Adam, then evaluates by feeding predictions
back autoregressively (discrete) or integrating long spans (ODE), reporting
rollout-MSE curves.  Deltas: minibatches are device arrays, the
rollout feedback loop is a ``lax.scan`` (the reference steps it from host
Python), and input standardisation constants are computed on device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from graph_odenet_tpu.data.nbody import SpringSystem, generate_trajectories, one_step_dataset
from graph_odenet_tpu.models import INODE, InteractionNetwork
from graph_odenet_tpu.utils.logging import MetricsLogger

__all__ = [
    "PhysicsConfig", "fit_interaction_network", "rollout_discrete",
    "fit_inode", "physics_rollout_curves",
]


@dataclasses.dataclass
class PhysicsConfig:
    # Data.
    n_bodies: int = 6
    dim: int = 2
    n_sims: int = 256
    n_steps: int = 200
    # Model.
    effect_dim: int = 50
    relation_hidden: tuple = (150, 150, 150, 150)
    object_hidden: tuple = (100,)
    # Optimisation.
    lr: float = 1e-3
    batch_size: int = 512
    epochs: int = 20
    seed: int = 0
    # IN-ODE.
    ode_method: str = "dopri5_scan"
    ode_steps: int = 16
    ode_window: int = 10        # trajectory timesteps fitted per sample
    ode_remat: bool = True      # remat dynamics in the solver scan: the
                                # scan otherwise stores every relation-MLP
                                # activation of every stage, per sample
    rtol: float = 1e-4
    atol: float = 1e-6
    log_path: Optional[str] = None
    echo: bool = False


def _make_data(cfg: PhysicsConfig, key):
    system = SpringSystem(n_bodies=cfg.n_bodies, dim=cfg.dim)
    trajs = generate_trajectories(system, key, cfg.n_sims, cfg.n_steps)
    return system, trajs


def fit_interaction_network(cfg: PhysicsConfig, trajs=None, system=None):
    """Train the discrete IN on one-step velocity targets.  Returns results
    + everything needed for rollout evaluation."""
    key = jax.random.PRNGKey(cfg.seed)
    key, dkey = jax.random.split(key)
    if trajs is None:
        system, trajs = _make_data(cfg, dkey)
    senders, receivers = system.edges()
    inputs, targets = one_step_dataset(trajs, dim=cfg.dim)

    # Standardise (velocity targets can be tiny; reference-style z-scoring).
    in_mean = inputs.mean(axis=(0, 1))
    in_std = jnp.maximum(inputs.std(axis=(0, 1)), 1e-6)

    model = InteractionNetwork(
        out_dim=cfg.dim,
        effect_dim=cfg.effect_dim,
        relation_hidden=cfg.relation_hidden,
        object_hidden=cfg.object_hidden,
    )

    def forward(params, states):
        """states [B, N, 1+2D] → predicted next-step velocity [B, N, D]."""
        norm = (states - in_mean) / in_std
        return jax.vmap(
            lambda o: model.apply(params, o, senders, receivers)
        )(norm)

    key, ikey = jax.random.split(key)
    params = model.init(
        ikey, (inputs[0] - in_mean) / in_std, senders, receivers
    )
    tx = optax.adam(cfg.lr)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, batch_x, batch_y):
        def loss_fn(p):
            pred = forward(p, batch_x)
            return jnp.mean((pred - batch_y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    n = inputs.shape[0]
    steps_per_epoch = max(n // cfg.batch_size, 1)
    log = MetricsLogger(cfg.log_path, echo=cfg.echo)
    t0 = time.time()
    loss = jnp.inf
    for epoch in range(cfg.epochs):
        key, pkey = jax.random.split(key)
        perm = jax.random.permutation(pkey, n)
        for s in range(steps_per_epoch):
            idx = perm[s * cfg.batch_size : (s + 1) * cfg.batch_size]
            params, opt_state, loss = train_step(
                params, opt_state, inputs[idx], targets[idx]
            )
        log.write(epoch=epoch, one_step_mse=loss)
    log.close()
    return dict(
        params=params,
        forward=forward,
        system=system,
        trajs=trajs,
        one_step_mse=float(loss),
        seconds=time.time() - t0,
    )


def rollout_discrete(forward, params, system: SpringSystem, init_states, horizon: int):
    """Autoregressive rollout: v̂ = IN(state); pos ← pos + dt·v̂ (§3.4).

    init_states: [B, N, 1+2D].  Returns predicted trajectories
    [B, horizon+1, N, 1+2D].
    """
    dim = system.dim
    dt = system.dt

    def step(states, _):
        vel = forward(params, states)
        mass = states[..., :1]
        pos = states[..., 1 : 1 + dim] + dt * vel
        nxt = jnp.concatenate([mass, pos, vel], axis=-1)
        return nxt, nxt

    _, traj = jax.lax.scan(step, init_states, None, length=horizon)
    traj = jnp.swapaxes(traj, 0, 1)  # [B, T, N, F]
    return jnp.concatenate([init_states[:, None], traj], axis=1)


def rollout_mse(pred_traj, true_traj, dim: int = 2):
    """Position MSE per horizon step — the reference's rollout curve."""
    p = pred_traj[..., 1 : 1 + dim]
    t = true_traj[..., 1 : 1 + dim]
    return jnp.mean((p - t) ** 2, axis=(0, 2, 3))


def fit_inode(cfg: PhysicsConfig, trajs=None, system=None):
    """Train the IN-ODE by fitting short trajectory windows with the
    integrator in the loop (SURVEY.md §2 R10)."""
    key = jax.random.PRNGKey(cfg.seed)
    key, dkey = jax.random.split(key)
    if trajs is None:
        system, trajs = _make_data(cfg, dkey)
    senders, receivers = system.edges()
    W = cfg.ode_window
    dt = system.dt

    # Windows: [B, W+1, N, 1+2D] sliced from trajectories.
    s, t1, n, f = trajs.shape
    n_win = (t1 - 1) // W
    wins = trajs[:, : n_win * W + 1]
    wins = jnp.stack([wins[:, i * W : i * W + W + 1] for i in range(n_win)], 1)
    wins = wins.reshape(s * n_win, W + 1, n, f)

    model = INODE(
        dim=cfg.dim,
        effect_dim=cfg.effect_dim,
        relation_hidden=cfg.relation_hidden,
        object_hidden=cfg.object_hidden,
        method=cfg.ode_method,
        steps=cfg.ode_steps,
        remat=cfg.ode_remat,
        rtol=cfg.rtol,
        atol=cfg.atol,
    )
    ts = jnp.arange(W + 1, dtype=jnp.float32) * dt
    mass0 = wins[0, 0, :, :1]

    def forward(params, window0):
        """window0 [N, 1+2D] at t=0 → predicted [W+1, N, 2D]."""
        y0 = window0[..., 1:]
        traj, _ = model.apply(
            params, y0, ts, window0[..., :1], senders, receivers
        )
        return traj

    key, ikey = jax.random.split(key)
    params = model.init(
        ikey, wins[0, 0, :, 1:], ts, mass0, senders, receivers
    )
    tx = optax.adam(cfg.lr)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, batch):
        def loss_fn(p):
            pred = jax.vmap(lambda w: forward(p, w[0]))(batch)  # [B, W+1, N, 2D]
            return jnp.mean((pred - batch[..., 1:]) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    nb = wins.shape[0]
    bs = min(cfg.batch_size, nb)
    steps_per_epoch = max(nb // bs, 1)
    log = MetricsLogger(cfg.log_path, echo=cfg.echo)
    t0 = time.time()
    loss = jnp.inf
    for epoch in range(cfg.epochs):
        key, pkey = jax.random.split(key)
        perm = jax.random.permutation(pkey, nb)
        for st in range(steps_per_epoch):
            idx = perm[st * bs : (st + 1) * bs]
            params, opt_state, loss = train_step(params, opt_state, wins[idx])
        log.write(epoch=epoch, window_mse=loss)
    log.close()
    return dict(
        params=params,
        forward=forward,
        model=model,
        system=system,
        trajs=trajs,
        window_mse=float(loss),
        seconds=time.time() - t0,
    )


def physics_rollout_curves(cfg: PhysicsConfig, horizon: int = 50, n_test: int = 64):
    """Config 3's full deliverable: train discrete IN + IN-ODE on shared
    trajectories, then evaluate BOTH by rollout MSE over ``horizon`` steps
    on held-out test trajectories — the reference's rollout-MSE-vs-horizon
    curve (SURVEY.md §2 R11, §3.4).

    Returns a JSON-able dict with ``rollout_mse_discrete`` /
    ``rollout_mse_inode`` curves (index = horizon step) plus the training
    summaries.  Shared by ``scripts/run_config3.py``, ``configs.run_config
    (3, rollout=...)`` and ``cli.py config 3 --rollout N``.
    """
    from graph_odenet_tpu.models import INODE

    t0 = time.time()
    key = jax.random.PRNGKey(cfg.seed)
    key, dkey, tkey = jax.random.split(key, 3)
    system, trajs = _make_data(cfg, dkey)
    test_trajs = generate_trajectories(system, tkey, n_test, horizon + 1)

    res_in = fit_interaction_network(cfg, trajs=trajs, system=system)
    res_ode = fit_inode(cfg, trajs=trajs, system=system)

    init = test_trajs[:, 0]                         # [B, N, 1+2D]
    pred_disc = rollout_discrete(
        res_in["forward"], res_in["params"], system, init, horizon
    )
    mse_disc = rollout_mse(pred_disc, test_trajs[:, : horizon + 1])

    # IN-ODE: one long integration over the horizon grid (same params,
    # scan budget scaled so the solver can resolve the longer span).
    model = res_ode["model"]
    long_model = INODE(
        dim=model.dim,
        effect_dim=model.effect_dim,
        relation_hidden=model.relation_hidden,
        object_hidden=model.object_hidden,
        method=model.method,
        rtol=model.rtol,
        atol=model.atol,
        remat=model.remat,
        steps=max(model.steps * (horizon // cfg.ode_window + 1), 64),
    )
    ts = jnp.arange(horizon + 1, dtype=jnp.float32) * system.dt
    senders, receivers = system.edges()

    @jax.jit
    def ode_roll(params, init):
        def one(w0):
            y, _ = long_model.apply(
                params, w0[..., 1:], ts, w0[..., :1], senders, receivers,
            )  # [T, N, 2D]
            mass = jnp.broadcast_to(
                w0[None, :, :1], (y.shape[0],) + w0[..., :1].shape
            )
            return jnp.concatenate([mass, y], axis=-1)

        return jax.vmap(one)(init)

    pred_ode = ode_roll(res_ode["params"], init)
    mse_ode = rollout_mse(pred_ode, test_trajs[:, : horizon + 1])
    return dict(
        config="physics-in-ode",
        platform=jax.default_backend(),
        horizon=horizon,
        n_test=n_test,
        dt=float(system.dt),
        one_step_mse=res_in["one_step_mse"],
        window_mse=res_ode["window_mse"],
        train_seconds_in=round(res_in["seconds"], 1),
        train_seconds_inode=round(res_ode["seconds"], 1),
        rollout_mse_discrete=[float(x) for x in mse_disc],
        rollout_mse_inode=[float(x) for x in mse_ode],
        cfg=dataclasses.asdict(cfg),
        total_seconds=round(time.time() - t0, 1),
    )
