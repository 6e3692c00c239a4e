"""Full-batch node-classification trainer (SURVEY.md §2 R7, §3.1).

Parity with the reference ``train.py``: Adam(lr 0.01, weight-decay 5e-4 as
L2-in-gradient), full-graph forward, NLL on the train indices, early
stopping on validation loss (GAT patience ~100), final test accuracy, seed
control.  Deltas: the epoch step is one jitted function (forward +
backward + update all on device), GCN-family models may aggregate
through a densified Â, and metrics stream as JSONL.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import jax
import jax.numpy as jnp
import optax

from graph_odenet_tpu.data.planetoid import NodeClassificationData
from graph_odenet_tpu.models import GAT, GCN, GATODE, GCNODE, ResGAT, ResGCN
from graph_odenet_tpu.utils.logging import MetricsLogger
from graph_odenet_tpu.utils.metrics import masked_accuracy, masked_nll

__all__ = ["NodeClassConfig", "adjacency", "build_model", "fit_node_classifier"]


@dataclasses.dataclass
class NodeClassConfig:
    model: str = "gcn"           # gcn|resgcn|gcnode|gat|resgat|gatode
    hidden: int = 16
    heads: int = 8
    n_blocks: int = 2            # residual variants
    dropout: float = 0.5
    # ODE-variant knobs.
    t1: float = 1.0
    method: str = "rk4"
    steps: int = 4
    rtol: float = 1e-3
    atol: float = 1e-4
    adjoint: Union[bool, str] = False  # False | True | "checkpoint"
    activation: str = "tanh"
    # Optimisation (reference defaults).
    lr: float = 0.01
    weight_decay: float = 5e-4
    epochs: int = 200
    patience: int = 100
    seed: int = 42
    # Adjacency: "segment" (edge list, every model) or "dense" (Â densified
    # once, each aggregation one matmul; GCN family only).
    representation: str = "segment"
    log_path: Optional[str] = None
    echo: bool = False


def build_model(cfg: NodeClassConfig, n_class: int):
    common = dict(n_class=n_class, dropout=cfg.dropout)
    ode = dict(
        t1=cfg.t1, method=cfg.method, steps=cfg.steps,
        rtol=cfg.rtol, atol=cfg.atol, adjoint=cfg.adjoint,
        activation=cfg.activation,
    )
    if cfg.model == "gcn":
        return GCN(hidden=cfg.hidden, **common)
    if cfg.model == "resgcn":
        return ResGCN(hidden=cfg.hidden, n_blocks=cfg.n_blocks, **common)
    if cfg.model == "gcnode":
        return GCNODE(hidden=cfg.hidden, **common, **ode)
    if cfg.model == "gat":
        return GAT(hidden=cfg.hidden, heads=cfg.heads, **common)
    if cfg.model == "resgat":
        return ResGAT(hidden=cfg.hidden, heads=cfg.heads, n_blocks=cfg.n_blocks, **common)
    if cfg.model == "gatode":
        return GATODE(hidden=cfg.hidden, heads=cfg.heads, **common, **ode)
    raise ValueError(f"unknown model {cfg.model!r}")


def adjacency(data: NodeClassificationData, representation: str, model: str):
    """The adjacency ``model`` aggregates over: the edge list ("segment")
    or, for the GCN family, the densified Â ("dense").

    The edge list is the default at every size.  On one NVIDIA H100 80GB
    HBM3 (chip_smoke.py's ``repr`` phase) a dense Â never won beyond
    run-to-run noise: GCN-ODE epochs tie at 768 to 3,328 padded nodes,
    with the order flipping between runs, and at pubmed (19,840 nodes) the
    edge list is 11× faster.  A dense aggregation is also a matmul, which
    the GPU runs in TF32 by default, where the edge list sums in f32.
    """
    if representation == "segment":
        return data.graph
    if representation == "dense":
        if model not in ("gcn", "resgcn", "gcnode"):
            raise ValueError(f"{model!r} scores edges; it needs 'segment'")
        return data.dense_adj()
    raise ValueError(f"unknown representation {representation!r}")


def fit_node_classifier(cfg: NodeClassConfig, data: NodeClassificationData):
    """Train + early-stop + test.  Returns a results dict."""
    model = build_model(cfg, data.n_class)
    adj = adjacency(data, cfg.representation, cfg.model)

    rng = jax.random.PRNGKey(cfg.seed)
    rng, init_rng = jax.random.split(rng)
    params = model.init(init_rng, adj, data.features)

    # Reference: torch Adam(weight_decay) = L2 added to gradients.
    tx = optax.chain(
        optax.add_decayed_weights(cfg.weight_decay),
        optax.adam(cfg.lr),
    )
    opt_state = tx.init(params)

    # The graph and the data enter the steps as arguments: closed over,
    # they would become constants of the executable, copied into it and
    # constant-folded at compile time.
    d = dict(
        adj=adj, x=data.features, labels=data.labels,
        train=data.idx_train, val=data.idx_val, test=data.idx_test,
    )

    def train_step(params, opt_state, dropout_rng, d):
        def loss_fn(p):
            out, stats = model.apply(
                p, d["adj"], d["x"], deterministic=False, rng=dropout_rng,
            )
            return masked_nll(out, d["labels"], d["train"]), stats

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        nfe = stats.get("nfe", jnp.zeros((), jnp.int32))
        return optax.apply_updates(params, updates), opt_state, loss, nfe

    # Compiled ahead of the loop so the caller can read its memory use.
    rng, drop_rng = jax.random.split(rng)
    train_step = (
        jax.jit(train_step).lower(params, opt_state, drop_rng, d).compile()
    )

    @jax.jit
    def eval_step(params, d):
        out, _ = model.apply(params, d["adj"], d["x"], deterministic=True)
        lab = d["labels"]
        return dict(
            train_acc=masked_accuracy(out, lab, d["train"]),
            val_loss=masked_nll(out, lab, d["val"]),
            val_acc=masked_accuracy(out, lab, d["val"]),
            test_acc=masked_accuracy(out, lab, d["test"]),
        )

    log = MetricsLogger(cfg.log_path, echo=cfg.echo)
    best = dict(val_loss=float("inf"), test_acc=0.0, val_acc=0.0, epoch=-1)
    best_params = params
    bad_epochs = 0
    epoch_seconds = []
    t_start = time.time()
    for epoch in range(cfg.epochs):
        t_epoch = time.perf_counter()
        params, opt_state, loss, nfe = train_step(
            params, opt_state, drop_rng, d
        )
        rng, drop_rng = jax.random.split(rng)
        m = eval_step(params, d)
        log.write(epoch=epoch, loss=loss, **m)
        if float(m["val_loss"]) < best["val_loss"]:
            best = dict(
                val_loss=float(m["val_loss"]),
                val_acc=float(m["val_acc"]),
                test_acc=float(m["test_acc"]),
                epoch=epoch,
            )
            best_params = params
            bad_epochs = 0
        else:
            bad_epochs += 1
        epoch_seconds.append(time.perf_counter() - t_epoch)
        if bad_epochs > cfg.patience:
            break
    log.close()
    return dict(
        best=best,
        params=best_params,
        epochs_run=epoch + 1,
        seconds=time.time() - t_start,
        final_test_acc=best["test_acc"],
        # Wall time of each epoch (train step + eval), ended by the host
        # reading the eval loss; the first includes the eval compilation.
        epoch_seconds=epoch_seconds,
        loss=float(loss),
        # Dynamics evaluations in the last training step (0: no ODE block).
        nfe=int(nfe),
        train_step=train_step,
    )
