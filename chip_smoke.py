#!/usr/bin/env python
"""Run the system's main path once on NVIDIA GPUs and check its results.

    python chip_smoke.py                 # one GPU: every phase below
    python chip_smoke.py --four-cards    # four GPUs: the sharded phase

One process runs the phases in order and prints one JSON line for each.

  device     Stops unless JAX's first device is a GPU.  Prints its kind and
             the device count, nvidia-smi's name and power limit, the JAX
             version, XLA_FLAGS and the compile-cache directory.
  ops        On an ogbn-arxiv-shaped power-law graph (169,343 nodes and
             1,166,243 edges before symmetrisation): ``spmm_segment`` at
             F=128 and ``attention_aggregate`` at (H, F) = (8, 8) and
             (1, 128), with and without dropout 0.6.  Forward and gradients
             against the float64 references of ``ops.reference``, as
             ``max|err|/max|ref|``: forwards within 1e-5; gradients within
             ``4·2⁻²⁴·√d`` for the graph's largest degree d (~1e-4 here),
             because they sum over the hub's edges in float32 atomics in
             no fixed order.  Each gradient is taken 5 times: the worst
             error is gated, and the spread between the runs is printed.
             No op has a matmul, so rounding is the only error.  fwd+bwd
             time.
  train      ``fit_node_classifier`` at published widths: config 1 (cora
             twin, GCN-ODE rk4), config 2 (citeseer twin, GAT-ODE 8×8
             dopri5), and on the arxiv twin GCN-ODE hidden 256 and GAT-ODE
             8×8 dopri5 with the checkpointed adjoint.  The loss is finite
             and the params moved; s/epoch, NFE, the train step's memory.
  physics    ``run_config(3)``: IN and IN-ODE for 2 epochs, rollout curves.
  reference  GCN-ODE and GAT-ODE forward on the citeseer twin, on the GPU
             under "highest" matmul precision against the CPU: log-probs
             within 1e-4, equal NFE.  The TF32 default's difference is
             printed, not gated.
  repr       GCN-ODE epochs with a dense Â against the edge list on the
             cora (also cut to 1/4 and 1/2), citeseer and pubmed twins:
             the measurement behind the edge list being the trainer's
             default (``train.node_classification.adjacency``).
  sharded    (``--four-cards``) On the arxiv twin, one training step of
             sharded GCN-ODE (ring, allgather) and GAT-ODE (ring) on a
             4-GPU mesh against the same step on a 1-GPU mesh, under
             "highest": the loss and the whole gradient (2-norm of the
             difference over that of the 1-GPU gradient) within 1e-4.  Then
             3 epochs of ``fit_sharded_node_classifier`` per mode.

Exit code 0 and, as the last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``
only when every phase passed, with nvidia-smi's ``name, power.limit`` of
each card on the lines before it.  Otherwise exit code 1 and no such line:
without a GPU nothing is printed on stdout; after a failed phase the
last line names the failed phases.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ONE_CARD_PHASES = ("ops", "train", "physics", "reference", "repr")
FOUR_CARD_PHASES = ("sharded",)
ARXIV_NODES, ARXIV_EDGES = 169_343, 1_166_243
OP_TOL = 1e-5          # forward max|err| / max|ref| of an op vs float64
GRAD_RUNS = 5          # times each op gradient is taken and checked
REF_TOL = 1e-4         # log-prob difference GPU ("highest") vs CPU
PARITY_TOL = 1e-4      # 4-card against 1-card step, relative


class NoAccelerator(RuntimeError):
    """JAX found no GPU, or fewer than the phases need."""


def emit(rec: dict) -> None:
    print(json.dumps(rec, default=_plain), flush=True)


def _plain(v):
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded phase, on 4 GPUs")
    return p.parse_args(argv)


def selected_phases(args) -> tuple[str, ...]:
    return FOUR_CARD_PHASES if args.four_cards else ONE_CARD_PHASES


def ok_line(devices) -> str:
    """The last line of a passing run."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }})


def check_devices(devices, need: int) -> None:
    if devices[0].platform != "gpu":
        raise NoAccelerator(
            f"JAX's first device is {devices[0].platform!r}, not a GPU"
        )
    if len(devices) < need:
        raise NoAccelerator(f"{len(devices)} GPUs, {need} needed")


def nvidia_smi() -> list[str]:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [l.strip() for l in out.stdout.splitlines() if l.strip()]


def _leaves(tree):
    import jax

    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _memory(compiled) -> dict | None:
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes",
    )}


# --- ops ------------------------------------------------------------------


def phase_ops(scale: float = 1.0, iters: int = 20) -> dict:
    import jax
    import jax.numpy as jnp

    from graph_odenet_tpu.bench import _time, powerlaw_graph
    from graph_odenet_tpu.ops import attention_aggregate
    from graph_odenet_tpu.ops import reference as ref
    from graph_odenet_tpu.ops.dropmask import seed_from_key
    from graph_odenet_tpu.ops.spmm import spmm_segment

    n, e = int(ARXIV_NODES * scale), int(ARXIV_EDGES * scale)
    rng = np.random.default_rng(0)
    recs = []

    g = powerlaw_graph(n, e)
    x = rng.standard_normal((g.n_node_pad, 128)).astype(np.float32)
    c = rng.standard_normal((g.n_node_pad, 128)).astype(np.float32)

    # Graphs enter as arguments, not as constants of the executable.
    @jax.jit
    def spmm_fb(g, x, c):
        y, vjp = jax.vjp(lambda v: spmm_segment(g, v), x)
        return y, vjp(c)[0]

    xd, cd = jnp.asarray(x), jnp.asarray(c)
    runs = [_host(spmm_fb(g, xd, cd)) for _ in range(GRAD_RUNS)]
    t = _time(spmm_fb, g, xd, cd, iters=iters)
    recs.append(dict(
        op="spmm_segment", feat=128, n_edge=g.n_edge,
        fwd_bwd_ms=t * 1e3, edges_per_s=g.n_edge / t,
        err_fwd=ref.rel_err(runs[0][0], ref.spmm_reference(g, x)),
        **_grad_readings("grad", [r[1] for r in runs],
                         ref.spmm_vjp_reference(g, c)),
        grad_tol=_grad_tol(g),
    ))

    ga = powerlaw_graph(n, e, normalize=None)
    grad_tol = _grad_tol(ga)
    s_real = np.asarray(ga.senders)[: ga.n_edge]
    r_real = np.asarray(ga.receivers)[: ga.n_edge]
    key = jax.random.PRNGKey(7)
    for heads, feat in ((8, 8), (1, 128)):
        lg = (rng.standard_normal((ga.n_edge_pad, heads)) * 2).astype(np.float32)
        v = rng.standard_normal((ga.n_node_pad, heads, feat)).astype(np.float32)
        ct = rng.standard_normal((ga.n_node_pad, heads, feat)).astype(np.float32)
        lgd, vd, ctd = jnp.asarray(lg), jnp.asarray(v), jnp.asarray(ct)
        for rate in (0.0, 0.6):
            kw = dict(edge_dropout_rng=key, edge_dropout_rate=rate) if rate else {}

            @jax.jit
            def att_fb(ga, lg, v, ct, kw=kw):
                out, vjp = jax.vjp(
                    lambda l, w: attention_aggregate(ga, l, w, **kw), lg, v
                )
                return (out,) + vjp(ct)

            runs = [_host(att_fb(ga, lgd, vd, ctd)) for _ in range(GRAD_RUNS)]
            t = _time(att_fb, ga, lgd, vd, ctd, iters=iters)
            drop = (
                ref.dropmask_reference(
                    int(seed_from_key(key)), s_real, r_real, heads, rate
                ) if rate else None
            )
            rdl, rdv = ref.attention_vjp_reference(ga, lg, v, ct, drop)
            recs.append(dict(
                op="attention_aggregate", heads=heads, feat=feat,
                dropout=rate, n_edge=ga.n_edge,
                fwd_bwd_ms=t * 1e3, edges_per_s=ga.n_edge / t,
                err_fwd=ref.rel_err(
                    runs[0][0], ref.attention_reference(ga, lg, v, drop)
                ),
                **_grad_readings("dlogits", [r[1] for r in runs], rdl),
                **_grad_readings("dvalues", [r[2] for r in runs], rdv),
                grad_tol=grad_tol,
            ))
    problems = [
        f"{r['op']} {k}={r[k]:.3g}" for r in recs for k in r
        if (k == "err_fwd" and not r[k] <= OP_TOL)
        or (k.startswith("grad_err") and not r[k] <= r["grad_tol"])
    ]
    return dict(fwd_tol=OP_TOL, ops=recs, problems=problems)


def _host(arrays):
    return [np.asarray(a) for a in arrays]


def _grad_readings(name, runs, want) -> dict:
    """The worst ``max|err|/max|ref|`` over repeated runs of a gradient,
    and their spread: ``max|run_i − run_0| / max|ref|``, how far the
    order of the float32 atomic sums moves the result between runs."""
    from graph_odenet_tpu.ops.reference import rel_err

    scale = max(float(np.max(np.abs(want))), 1e-300)
    return {
        f"grad_err_{name}": max(rel_err(r, want) for r in runs),
        f"grad_spread_{name}": max(
            float(np.max(np.abs(r - runs[0]))) for r in runs
        ) / scale,
    }


def _grad_tol(g) -> float:
    """Bound on a gradient's ``max|err| / max|ref|``: ``4·2⁻²⁴·√d`` for the
    largest degree ``d``.  A gradient sums over a node's edges in float32
    atomics in no fixed order (the attention gradients also go through the
    softmax denominator, a sum over the hub's edges), and such a sum errs
    by about ``2⁻²⁴·√d`` of its size; 4 is the margin."""
    e = g.n_edge
    deg = max(
        np.bincount(np.asarray(g.receivers)[:e]).max(),
        np.bincount(np.asarray(g.senders)[:e]).max(),
    )
    return float(4 * 2.0**-24 * np.sqrt(deg))


# --- train ----------------------------------------------------------------


def _train_cases(scale: float):
    """(label, config, data) at the published widths."""
    import dataclasses

    from graph_odenet_tpu.configs import get_config
    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv
    from graph_odenet_tpu.train import NodeClassConfig

    small_epochs = 4
    _, c1 = get_config(1)
    _, c2 = get_config(2)
    yield ("config1_cora_gcnode", dataclasses.replace(
        c1, epochs=small_epochs, representation="dense",
    ), lambda: synthetic_planetoid("cora", seed=c1.seed, scale=scale))
    yield ("config2_citeseer_gatode",
           dataclasses.replace(c2, epochs=small_epochs),
           lambda: synthetic_planetoid("citeseer", seed=c2.seed, scale=scale))
    made = []

    def arxiv():  # built once, shared by both arxiv runs
        if not made:
            made.append(synthetic_ogbn_arxiv(seed=0, scale=scale))
        return made[0]

    yield ("arxiv_gcnode_h256", NodeClassConfig(
        model="gcnode", hidden=256, method="rk4", steps=4, dropout=0.5,
        epochs=3,
    ), arxiv)
    yield ("arxiv_gatode_8x8_ckpt_adjoint", NodeClassConfig(
        model="gatode", hidden=8, heads=8, method="dopri5_scan", steps=32,
        rtol=1e-3, atol=1e-4, adjoint="checkpoint", dropout=0.6, lr=0.005,
        epochs=3,
    ), arxiv)


def phase_train(scale: float = 1.0) -> dict:
    import jax

    from graph_odenet_tpu.train import fit_node_classifier
    from graph_odenet_tpu.train.node_classification import (
        adjacency, build_model,
    )

    runs, problems = [], []
    for label, cfg, make_data in _train_cases(scale):
        data = make_data()
        res = fit_node_classifier(cfg, data)
        # The trainer's initial params: the second key of its seed's split.
        adj = adjacency(data, cfg.representation, cfg.model)
        p0 = build_model(cfg, data.n_class).init(
            jax.random.split(jax.random.PRNGKey(cfg.seed))[1], adj,
            data.features,
        )
        moved = max(
            float(np.max(np.abs(a - b)))
            for a, b in zip(_leaves(res["params"]), _leaves(p0))
        )
        secs = res["epoch_seconds"]
        runs.append(dict(
            run=label, model=cfg.model, hidden=cfg.hidden,
            heads=cfg.heads if cfg.model.startswith("gat") else None,
            method=cfg.method, steps=cfg.steps, adjoint=cfg.adjoint,
            representation=cfg.representation, n_node=data.graph.n_node,
            n_edge=data.graph.n_edge, epochs=res["epochs_run"],
            s_per_epoch=float(np.mean(secs[1:])) if len(secs) > 1 else None,
            first_epoch_s=secs[0], loss=res["loss"], nfe=res["nfe"],
            best=res["best"], max_param_change=moved,
            train_step_memory=_memory(res["train_step"]),
        ))
        if not np.isfinite(res["loss"]):
            problems.append(f"{label}: loss {res['loss']}")
        if not moved > 0.0:
            problems.append(f"{label}: params did not move")
    stats = jax.devices()[0].memory_stats() or {}
    return dict(runs=runs, peak_bytes_in_use=stats.get("peak_bytes_in_use"),
                problems=problems)


# --- physics --------------------------------------------------------------


def phase_physics(scale: float = 0.25, horizon: int = 20) -> dict:
    from graph_odenet_tpu.configs import run_config

    res = run_config(3, scale=scale, epochs=2, rollout=horizon)
    curves = {k: res[k] for k in ("rollout_mse_discrete", "rollout_mse_inode")}
    problems = [
        f"{k} not finite" for k in ("one_step_mse", "window_mse")
        if not np.isfinite(res[k])
    ] + [
        f"{k}: {len(v)} points, not finite or not {horizon + 1}"
        for k, v in curves.items()
        if len(v) != horizon + 1 or not np.all(np.isfinite(v))
    ]
    keep = ("one_step_mse", "window_mse", "train_seconds_in",
            "train_seconds_inode", "total_seconds", "n_test", "horizon")
    return dict(
        **{k: res[k] for k in keep},
        **{f"{k}_last": v[-1] for k, v in curves.items()},
        problems=problems,
    )


# --- reference ------------------------------------------------------------


def phase_reference(scale: float = 1.0) -> dict:
    import jax

    from graph_odenet_tpu.configs import get_config
    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.train.node_classification import (
        adjacency, build_model,
    )

    data = synthetic_planetoid("citeseer", seed=0, scale=scale)
    n = data.graph.n_node
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    recs, problems = [], []
    for idx in (1, 2):
        _, cfg = get_config(idx)
        model = build_model(cfg, data.n_class)
        adj = adjacency(data, cfg.representation, cfg.model)
        params = model.init(jax.random.PRNGKey(0), adj, data.features)

        def forward(device, precision):
            args = jax.device_put((params, adj, data.features), device)
            ctx = (jax.default_matmul_precision(precision) if precision
                   else contextlib.nullcontext())
            with ctx:
                lp, stats = jax.jit(
                    lambda p, a, x: model.apply(p, a, x, deterministic=True)
                )(*args)
            return np.asarray(lp)[:n], int(stats["nfe"])

        lp_gpu, nfe_gpu = forward(gpu, "highest")
        lp_cpu, nfe_cpu = forward(cpu, "highest")
        lp_tf32, nfe_tf32 = forward(gpu, None)
        diff = float(np.max(np.abs(lp_gpu - lp_cpu)))
        recs.append(dict(
            model=cfg.model, method=cfg.method,
            representation=cfg.representation,
            max_abs_diff_highest=diff, nfe_gpu=nfe_gpu, nfe_cpu=nfe_cpu,
            max_abs_diff_default=float(np.max(np.abs(lp_tf32 - lp_cpu))),
            nfe_default=nfe_tf32,
        ))
        if not diff <= REF_TOL:
            problems.append(f"{cfg.model}: |gpu - cpu| = {diff:.3g}")
        if nfe_gpu != nfe_cpu:
            problems.append(f"{cfg.model}: nfe {nfe_gpu} != {nfe_cpu}")
    return dict(tol=REF_TOL, models=recs, problems=problems)


# --- repr -----------------------------------------------------------------


def phase_repr(scale: float = 1.0, epochs: int = 12) -> dict:
    import dataclasses

    from graph_odenet_tpu.configs import get_config
    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.train import fit_node_classifier
    _, base = get_config(1)
    recs = []
    # Cut-down cora twins probe below the smallest published graph.
    for name, size in (("cora", 0.25), ("cora", 0.5), ("cora", 1.0),
                       ("citeseer", 1.0), ("pubmed", 1.0)):
        data = synthetic_planetoid(name, seed=0, scale=scale * size)
        ms = {}
        for rep in ("dense", "segment"):
            cfg = dataclasses.replace(
                base, representation=rep, epochs=epochs, patience=epochs
            )
            # Steady epochs: the first two hold compilation and warm-up.
            secs = fit_node_classifier(cfg, data)["epoch_seconds"][2:]
            ms[rep] = float(np.median(secs)) * 1e3
        faster = min(ms, key=ms.get)
        recs.append(dict(
            dataset=name, scale=size, n_node_pad=data.graph.n_node_pad,
            n_edge=data.graph.n_edge, epoch_ms_dense=ms["dense"],
            epoch_ms_segment=ms["segment"], faster=faster,
        ))
    # Timing backs the trainer's default but does not gate the run.
    return dict(epochs_timed=epochs - 2, datasets=recs, problems=[])


# --- sharded (four cards) -------------------------------------------------


def sharded_parity(data, model: str, mode: str, devices, *, hidden: int,
                   heads: int = 8, steps: int = 4, dropout: float = 0.0,
                   seed: int = 0) -> dict:
    """Loss and parameter gradients of one training step on a mesh over
    ``devices`` and on a mesh over ``devices[:1]``, same seed and data,
    under "highest" matmul precision."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from graph_odenet_tpu.parallel import make_mesh, partition_by_receiver
    from graph_odenet_tpu.parallel import sharded_gat, sharded_gcn

    c, f_in = data.n_class, data.features.shape[1]
    key = jax.random.PRNGKey(seed)
    if model == "gcnode":
        params = sharded_gcn.init_params(key, f_in, hidden, c)
    else:
        params = sharded_gat.init_gatode_params(key, f_in, hidden, heads, c)
    y1h = jax.nn.one_hot(data.labels, c, dtype=jnp.float32)
    w = np.zeros((data.graph.n_node_pad,), np.float32)
    w[np.asarray(data.idx_train)] = 1.0
    drop_key = jax.random.PRNGKey(seed + 1)

    out = []
    for devs in (list(devices), list(devices)[:1]):
        mesh = make_mesh(shape=(len(devs),), axis_names=("edge",), devices=devs)
        pg = jax.device_put(partition_by_receiver(data.graph, len(devs)),
                            NamedSharding(mesh, PartitionSpec("edge")))
        x, y, wt = sharded_gcn.shard_batch(
            mesh, "edge", data.features, y1h, jnp.asarray(w)
        )

        # Graph and data enter as arguments, not as constants.
        def loss(p, pg, x, y, wt):
            if model == "gcnode":
                lp = sharded_gcn.forward(p, pg, x, mesh, steps=steps,
                                         mode=mode, dropout=dropout,
                                         rng=drop_key)
            else:
                lp = sharded_gat.gatode_forward(p, pg, x, mesh, steps=steps,
                                                dropout=dropout, rng=drop_key)
            return jnp.sum(-jnp.sum(lp * y, axis=-1) * wt) / jnp.sum(wt)

        with jax.default_matmul_precision("highest"):
            val, grad = jax.jit(jax.value_and_grad(loss))(params, pg, x, y, wt)
        out.append((float(val), _leaves(grad)))
    (l_n, g_n), (l_1, g_1) = out
    flat_n, flat_1 = (np.concatenate([a.ravel() for a in g]) for g in (g_n, g_1))
    return dict(
        model=model, mode=mode, n_devices=len(devices), loss=l_n,
        loss_1=l_1, loss_rel=abs(l_n - l_1) / max(abs(l_1), 1e-30),
        grad_rel=_norm_rel(flat_n, flat_1),
        # Per leaf, for information: the attention vectors' gradients
        # cancel to near zero (the softmax over a receiver's edges barely
        # depends on its own score), so their relative error is rounding.
        leaf_rel_max=max(_norm_rel(a, b) for a, b in zip(g_n, g_1)),
    )


def _norm_rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


SHARDED_RUNS = (("gcnode", "ring"), ("gcnode", "allgather"), ("gatode", "ring"))


def _sharded_width(model):
    # GCN-ODE at config 4's width; GAT-ODE at config 2's 8 heads × 8.
    return dict(hidden=256, dropout=0.5) if model == "gcnode" else dict(
        hidden=8, heads=8, dropout=0.6)


def phase_sharded(scale: float = 1.0, n_cards: int = 4, epochs: int = 3) -> dict:
    import jax

    from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv
    from graph_odenet_tpu.parallel.trainer import (
        ShardedTrainConfig, fit_sharded_node_classifier,
    )

    data = synthetic_ogbn_arxiv(seed=0, scale=scale)
    devices = jax.devices()[:n_cards]
    parity, runs, problems = [], [], []
    for model, mode in SHARDED_RUNS:
        rec = sharded_parity(data, model, mode, devices, **_sharded_width(model))
        parity.append(rec)
        for k in ("loss_rel", "grad_rel"):
            if not rec[k] <= PARITY_TOL:
                problems.append(f"{model}/{mode} {k}={rec[k]:.3g}")
    for model, mode in SHARDED_RUNS:
        res = fit_sharded_node_classifier(ShardedTrainConfig(
            model=model, mode=mode, steps=4, epochs=epochs, n_parts=n_cards,
            **_sharded_width(model),
        ), data)
        runs.append(dict(model=model, mode=mode, step_ms=res["step_ms"],
                         loss_first=res["loss_first"],
                         loss_final=res["loss_final"],
                         epochs_run=res["epochs_run"]))
        if not np.isfinite(res["loss_final"]):
            problems.append(f"{model}/{mode}: loss {res['loss_final']}")
    return dict(tol=PARITY_TOL, n_node=data.graph.n_node,
                n_edge=data.graph.n_edge, parity=parity, runs=runs,
                problems=problems)


PHASES = dict(ops=phase_ops, train=phase_train, physics=phase_physics,
              reference=phase_reference, repr=phase_repr,
              sharded=phase_sharded)


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = selected_phases(args)
    from graph_odenet_tpu.utils.compile_cache import configure_compile_cache

    cache_dir = configure_compile_cache()
    import jax

    devices = jax.devices()
    need = 4 if args.four_cards else 1
    try:
        check_devices(devices, need)
        smi = nvidia_smi()
    except (NoAccelerator, OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    devices = devices[:need] if args.four_cards else devices
    emit(dict(
        phase="device", ok=True, platform=devices[0].platform,
        device_kind=devices[0].device_kind, count=len(devices),
        nvidia_smi=smi, jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS"), compile_cache=cache_dir,
    ))
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            rec = PHASES[name]()
        except Exception as e:  # report this phase and go on to the next
            rec = dict(problems=[f"{type(e).__name__}: {e}"],
                       traceback=traceback.format_exc()[-3000:])
        ok = not rec["problems"]
        if not ok:
            failed.append(name)
        emit(dict(phase=name, ok=ok, seconds=time.perf_counter() - t0, **rec))
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}")
        return 1
    print("\n".join(smi))
    print(ok_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
