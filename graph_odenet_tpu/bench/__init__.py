"""Benchmark harness — the BASELINE.md metrics (SURVEY.md §6).

Three benchmarks, all returning plain dicts (one JSON-able record each):

  * :func:`spmm_bench`     — edges/s/chip, SpMM forward+backward (headline;
                             also exposed by the repo-root ``bench.py``).
  * :func:`ode_bench`      — ODE NFE/s: dopri5 GCN-dynamics integration at
                             Cora scale, whole trajectory on device.
  * :func:`scaling_bench`  — edge-partitioned sharded SpMM step time across
                             an N-device mesh vs single device (the ≥80%
                             scaling target; run on a CPU mesh for harness
                             tests, on the cards for numbers).

The reference repo never published throughput (BASELINE.md "published": {});
these establish the numbers this framework is judged on.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = [
    "spmm_bench", "gat_bench", "ode_bench", "ode_model_bench",
    "scaling_bench", "powerlaw_graph",
]


def powerlaw_graph(n_nodes, n_edges, seed=0, **kw):
    """OGBN-arxiv-shaped synthetic graph (zipf receiver popularity)."""
    from graph_odenet_tpu.graph import from_edges

    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.8, size=n_edges).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, size=n_edges)
    kw.setdefault("normalize", "row")
    kw.setdefault("node_multiple", 128)
    kw.setdefault("edge_multiple", 1024)
    return from_edges(src, pop, n_node=n_nodes, **kw)


def _time(fn, *args, iters=20, warmup=2):
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def spmm_bench(n_nodes=169_343, n_edges=1_166_243, feat=128, iters=20):
    """edges/s/chip for SpMM fwd+bwd on the segment path."""
    import jax
    import jax.numpy as jnp

    from graph_odenet_tpu.ops.spmm import spmm_segment

    g = powerlaw_graph(n_nodes, n_edges)
    x = jnp.asarray(
        np.random.default_rng(1).standard_normal((g.n_node_pad, feat)),
        jnp.float32,
    )

    def fwd_bwd(path, adj):
        return jax.jit(jax.grad(lambda x: 0.5 * jnp.sum(path(adj, x) ** 2)))

    t_seg = _time(fwd_bwd(spmm_segment, g), x, iters=iters)
    return dict(
        n_edge=g.n_edge,
        edges_per_s=g.n_edge / t_seg,
        ms=t_seg * 1e3,
    )


def gat_bench(
    n_nodes=169_343, n_edges=1_166_243, heads=1, feat=128, iters=20,
    mode="fwd_bwd", use_scores=True, dropout=0.0,
):
    """edges/s/chip for the GAT attention sandwich (SDDMM→softmax→SpMM)
    on the segment path.

    ``use_scores``: logits come from decomposed node scores (the GAT
    layer's real workload, ops/sddmm.edge_scores); False measures the plain
    op on arbitrary logits.

    ``dropout``: post-softmax attention dropout rate — the reference trains
    GAT with 0.6, so ``dropout=0.6, mode="fwd_bwd"`` is the training-path
    measurement (round-2 VERDICT #2)."""
    import jax
    import jax.numpy as jnp

    from graph_odenet_tpu.ops.sddmm import attention_aggregate, edge_scores

    g = powerlaw_graph(n_nodes, n_edges, normalize=None)
    rng = np.random.default_rng(1)
    if use_scores:
        s_src = jnp.asarray(
            rng.standard_normal((g.n_node_pad, heads)), jnp.float32
        )
        s_dst = jnp.asarray(
            rng.standard_normal((g.n_node_pad, heads)), jnp.float32
        )
        logits = edge_scores(g, s_src, s_dst)
    else:
        logits = jnp.asarray(
            rng.standard_normal((g.n_edge_pad, heads)), jnp.float32
        )
    wh = jnp.asarray(
        rng.standard_normal((g.n_node_pad, heads, feat)), jnp.float32
    )

    drop_kw = {}
    if dropout > 0.0:
        drop_kw = dict(
            edge_dropout_rng=jax.random.PRNGKey(7),
            edge_dropout_rate=dropout,
        )

    if mode == "fwd":
        fn = jax.jit(lambda lg, w: attention_aggregate(g, lg, w, **drop_kw))
    else:
        fn = jax.jit(jax.grad(
            lambda lg, w: 0.5 * jnp.sum(
                attention_aggregate(g, lg, w, **drop_kw) ** 2
            ),
            argnums=(0, 1),
        ))

    t = _time(fn, logits, wh, iters=iters)
    return dict(
        n_edge=g.n_edge, heads=heads, feat=feat, mode=mode, dropout=dropout,
        edges_per_s=g.n_edge / t, ms=t * 1e3,
    )


def ode_bench(
    n_nodes=2_708, feat=128, method="dopri5", rtol=1e-3, atol=1e-4,
    representation="dense", iters=10, seed=0,
):
    """NFE/s of a GCN-dynamics ODE solve (SURVEY.md §3.1 hot loop).

    The whole adaptive trajectory runs inside one XLA program; NFE/s =
    (total dynamics evaluations) / wall-clock — each NFE is one
    matmul+aggregate over the full graph.
    """
    import jax
    import jax.numpy as jnp

    from graph_odenet_tpu.graph import from_edges, to_dense
    from graph_odenet_tpu.ode import odeint
    from graph_odenet_tpu.ops import spmm

    rng = np.random.default_rng(seed)
    # Cora-shaped random graph at the requested size.
    deg = 4
    src = rng.integers(0, n_nodes, size=deg * n_nodes)
    dst = rng.integers(0, n_nodes, size=deg * n_nodes)
    g = from_edges(src, dst, n_node=n_nodes, normalize="sym", node_multiple=128)
    adj = to_dense(g) if representation == "dense" else g
    w = jnp.asarray(
        rng.standard_normal((feat, feat)) / np.sqrt(feat), jnp.float32
    )
    y0 = jnp.asarray(rng.standard_normal((g.n_node_pad, feat)), jnp.float32)

    def dynamics(t, h):
        return jnp.tanh(spmm(adj, h @ w))

    ts = jnp.asarray([0.0, 1.0], jnp.float32)

    @jax.jit
    def solve(y0):
        ys, stats = odeint(
            dynamics, y0, ts, method=method, rtol=rtol, atol=atol,
            return_stats=True,
        )
        return ys[-1], stats["nfe"]

    out, nfe = solve(y0)
    jax.block_until_ready(out)
    t = _time(lambda y: solve(y)[0], y0, iters=iters)
    nfe = int(nfe)
    return dict(
        method=method, nfe=nfe, seconds=t, nfe_per_s=nfe / t,
        edges_per_s=nfe * g.n_edge / t, representation=representation,
    )


def scaling_bench(n_devices=None, n_nodes=8_192, deg=16, feat=128, iters=10):
    """Edge-partitioned sharded GCN-ODE step time on an N-device mesh.

    Returns per-device-count step times + parallel efficiency vs 1 device.
    On a CPU host mesh this validates the harness; on a real slice the
    ≥80%-scaling BASELINE target is judged from ``efficiency``.
    """
    import jax
    import jax.numpy as jnp

    from graph_odenet_tpu.graph import from_edges
    from graph_odenet_tpu.parallel import make_mesh, partition_by_receiver
    from graph_odenet_tpu.parallel.sharded_gcn import (
        init_params, shard_batch, train_step,
    )

    n_devices = n_devices or len(jax.devices())
    rng = np.random.default_rng(0)
    src = rng.integers(0, n_nodes, size=deg * n_nodes)
    dst = rng.integers(0, n_nodes, size=deg * n_nodes)
    results = {}
    for nd in (1, n_devices):
        mesh = make_mesh(
            shape=(nd,), axis_names=("edge",), devices=jax.devices()[:nd]
        )
        g = from_edges(src, dst, n_node=n_nodes, normalize="row", node_multiple=nd)
        pg = partition_by_receiver(g, nd, edge_multiple=8)
        x = jnp.asarray(rng.standard_normal((g.n_node_pad, feat)), jnp.float32)
        c = 8
        labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, g.n_node_pad)]
        weight = (np.arange(g.n_node_pad) < g.n_node).astype(np.float32)
        x_s, y_s, w_s = shard_batch(mesh, "edge", x, jnp.asarray(labels), jnp.asarray(weight))
        params = init_params(jax.random.PRNGKey(0), feat, 64, c)
        step = jax.jit(
            lambda p, x, y, w: train_step(p, pg, x, y, w, mesh, steps=4, mode="ring")
        )
        t = _time(lambda p: step(p, x_s, y_s, w_s)[0], params, iters=iters)
        results[nd] = t
    eff = results[1] / (results[n_devices])  # >1 means strong-scaling win
    platform = jax.devices()[0].platform
    return dict(
        n_devices=n_devices,
        t1_ms=results[1] * 1e3,
        tn_ms=results[n_devices] * 1e3,
        speedup=results[1] / results[n_devices],
        efficiency=eff / n_devices,
        n_edge=int(deg * n_nodes),
        platform=platform,
        # N virtual CPU devices share one socket: timings there validate the
        # harness only; the ≥80% BASELINE target is judged on a real slice.
        harness_only=platform == "cpu",
    )


def ode_model_bench(
    model: str = "gcnode", n_nodes: int = 2_708, deg: int = 4,
    feat_in: int = 128, hidden: int = 64, heads: int = 8,
    method: str = "dopri5", rtol: float = 1e-3, atol: float = 1e-4,
    representation: str = "segment", iters: int = 10, seed: int = 0,
    mode: str = "fwd", dropout: float | None = None,
    steps: int = 32, remat: bool = False, adjoint: bool = False,
):
    """NFE/s of the REAL flagship models (encoder → ODEBlock → readout),
    not a hand-rolled dynamics (round-1 VERDICT weak #6).

    ``representation``: "segment" | "dense" (GCN-ODE only), as in the
    trainer.

    ``mode="train_step"`` measures the R7 inner loop users actually train:
    ``value_and_grad`` of the NLL loss with dropout live (reference rates:
    0.5 GCN-family, 0.6 GAT-family), adaptive methods switched to their
    reverse-differentiable ``_scan`` variants (round-2 VERDICT #7).
    """
    import jax
    import jax.numpy as jnp

    from graph_odenet_tpu.graph import from_edges, to_dense
    from graph_odenet_tpu.models import GATODE, GCNODE

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=deg * n_nodes)
    dst = rng.integers(0, n_nodes, size=deg * n_nodes)
    norm = "sym" if model == "gcnode" else None
    g = from_edges(src, dst, n_node=n_nodes, normalize=norm, node_multiple=128)
    adj = to_dense(g) if representation == "dense" else g
    n_class = 8
    train = mode == "train_step"
    # The O(1)-memory continuous adjoint differentiates through its own
    # reverse integration, so the forward may keep the true while_loop
    # solver; direct backprop needs the bounded reverse-differentiable
    # _scan variants.
    if train and not adjoint and method in (
        "dopri5", "dopri8", "bosh3", "adaptive_heun", "fehlberg2", "adams",
    ):
        method = method + "_scan"
    if dropout is None:
        dropout = (0.5 if model == "gcnode" else 0.6) if train else 0.0
    kw = dict(
        n_class=n_class, method=method, rtol=rtol, atol=atol,
        steps=steps, dropout=dropout, remat=remat, adjoint=adjoint,
    )
    if model == "gcnode":
        m = GCNODE(hidden=hidden, **kw)
    elif model == "gatode":
        m = GATODE(hidden=hidden // heads, heads=heads, **kw)
    else:
        raise ValueError(model)
    x = jnp.asarray(
        rng.standard_normal((g.n_node_pad, feat_in)), jnp.float32
    )
    params = m.init(jax.random.PRNGKey(0), adj, x)

    @jax.jit
    def fwd(params, x):
        # Both the direct and the adjoint path return real solver stats (the
        # adjoint surfaces its forward solve's stats through the custom_vjp).
        out, stats = m.apply(params, adj, x, deterministic=True)
        return out, stats["nfe"]

    labels = jnp.asarray(rng.integers(0, n_class, size=g.n_node_pad))
    import optax

    tx = optax.adam(1e-2)

    @jax.jit
    def step(params, opt_state, x, key):
        # The full R7 inner loop: value_and_grad + Adam update (the
        # optimizer's memory traffic is part of what users pay per step).
        def loss_fn(p):
            out, stats = m.apply(
                p, adj, x, deterministic=False, rng=key,
            )
            nfe = stats["nfe"]
            logp = jax.nn.log_softmax(out[: g.n_node])
            nll = -jnp.mean(
                jnp.take_along_axis(logp, labels[: g.n_node, None], 1)
            )
            return nll, nfe

        (nll, nfe), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, nfe

    if train:
        opt_state = tx.init(params)
        # Fresh dropout key each timed iteration (pre-split host-side so
        # the key derivation is outside the timed region).
        keys = list(jax.random.split(jax.random.PRNGKey(3), iters + 4))
        import itertools

        ctr = itertools.count()
        p1, o1, nfe = step(params, opt_state, x, keys[0])
        jax.block_until_ready(p1)
        t = _time(
            lambda xx: step(
                params, opt_state, xx, keys[next(ctr) % len(keys)]
            )[0],
            x, iters=iters,
        )
    else:
        (out, nfe) = fwd(params, x)
        jax.block_until_ready(out)
        t = _time(lambda xx: fwd(params, xx)[0], x, iters=iters)
    nfe = int(nfe)
    return dict(
        model=model, method=method, representation=representation,
        mode=mode, dropout=dropout, steps=steps, remat=remat,
        adjoint=adjoint,
        n_node=g.n_node, n_edge=g.n_edge, nfe=nfe, seconds=t,
        nfe_per_s=nfe / t, edges_per_s=nfe * g.n_edge / t,
    )
