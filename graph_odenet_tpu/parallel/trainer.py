"""Edge-parallel end-to-end training — the R7 recipe on a device mesh.

Reference parity (SURVEY.md §2 R7 applied to §7 step 7 / config[4]): the
reference trains every experiment to convergence with Adam(lr, weight
decay as L2-in-gradient), full-batch NLL on the train indices, early
stopping on validation loss, and reports test accuracy.  This module runs
exactly that recipe over the *edge-partitioned* models
(``parallel.sharded_gcn.forward`` / ``parallel.sharded_gat.gatode_forward``)
so the whole step — forward, backward, Adam update — is one jitted XLA
program over a ``Mesh``, with node rows sharded P("edge"), parameters
replicated, and parameter-gradient psums inserted by XLA.

Fault tolerance: checkpoints (params + opt state + epoch) every
``ckpt_every`` epochs when ``ckpt_dir`` is set; a restarted call resumes
from the latest step (same contract ``tests/test_fault_recovery.py`` pins
for the single-device trainer).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec

from graph_odenet_tpu.data.planetoid import NodeClassificationData
from graph_odenet_tpu.parallel.mesh import make_mesh
from graph_odenet_tpu.parallel.partition import partition_by_receiver
from graph_odenet_tpu.parallel import sharded_gat, sharded_gcn
from graph_odenet_tpu.parallel.sharded_gcn import shard_batch

__all__ = ["ShardedTrainConfig", "fit_sharded_node_classifier"]


@dataclasses.dataclass
class ShardedTrainConfig:
    model: str = "gcnode"        # gcnode | gatode
    hidden: int = 256            # gatode: per-head width (heads * hidden total)
    heads: int = 4               # gatode only
    steps: int = 4               # rk4 substeps
    t1: float = 1.0
    mode: str = "ring"           # halo exchange flavour: ring | allgather
                                 # (gcnode only for allgather)
    lr: float = 0.01
    weight_decay: float = 5e-4
    # Feature (+ attention, gatode) dropout — the reference recipe uses 0.5
    # for GCN-family and 0.6 for GAT-family; 0 disables (eval always does).
    dropout: float = 0.0
    epochs: int = 30
    patience: int = 100
    # None = auto: every epoch on small graphs (reference R7 behaviour),
    # every 5 at arxiv scale where a full-graph eval costs ~a train step.
    eval_every: Optional[int] = None
    seed: int = 0
    # Checkpoint the ODE dynamics (recompute attention internals in the
    # backward) — trades compute for the memory of stored activations.
    remat: bool = False
    n_parts: Optional[int] = None   # default: all visible devices
    edge_multiple: int = 1024
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10


def _index_mask(idx, n_pad):
    m = np.zeros((n_pad,), np.float32)
    m[np.asarray(idx)] = 1.0
    return m


def fit_sharded_node_classifier(
    cfg: ShardedTrainConfig, data: NodeClassificationData, mesh=None
):
    """Train the edge-partitioned model to convergence; returns a summary
    dict with ``test_acc``, ``val_acc``, ``step_ms``, ``epochs_run``."""
    n_parts = cfg.n_parts or len(jax.devices())
    if mesh is None:
        mesh = make_mesh(
            shape=(n_parts,), axis_names=("edge",),
            devices=jax.devices()[:n_parts],
        )
    g = data.graph
    # Bucket row p lives on device p, where the shard_map steps read it:
    # placed once here, not resharded from one device at every step.
    pg = jax.device_put(
        partition_by_receiver(g, n_parts, edge_multiple=cfg.edge_multiple),
        NamedSharding(mesh, PartitionSpec("edge")),
    )
    n_pad, f_in, c = g.n_node_pad, data.features.shape[1], data.n_class

    labels_1h = jax.nn.one_hot(data.labels, c, dtype=jnp.float32)  # −1 → 0s
    w_train = _index_mask(data.idx_train, n_pad)
    w_val = _index_mask(data.idx_val, n_pad)
    w_test = _index_mask(data.idx_test, n_pad)
    x, y1h, w_tr, w_va, w_te, labels = shard_batch(
        mesh, "edge", data.features, labels_1h,
        jnp.asarray(w_train), jnp.asarray(w_val), jnp.asarray(w_test),
        data.labels,
    )

    # The graph and the data enter the steps as arguments: closed over,
    # they would become constants of the executable, copied into it and
    # constant-folded at compile time.
    d = dict(pg=pg, x=x, y=y1h, w_tr=w_tr, w_va=w_va, w_te=w_te,
             labels=labels)

    rng = jax.random.PRNGKey(cfg.seed)
    if cfg.model == "gcnode":
        params = sharded_gcn.init_params(rng, f_in, cfg.hidden, c)
        fwd = lambda p, d, key=None: sharded_gcn.forward(
            p, d["pg"], d["x"], mesh, steps=cfg.steps, t1=cfg.t1,
            mode=cfg.mode, dropout=cfg.dropout, rng=key,
        )
    elif cfg.model == "gatode":
        if cfg.mode != "ring":
            raise ValueError(f"sharded gatode runs mode 'ring', not {cfg.mode!r}")
        params = sharded_gat.init_gatode_params(
            rng, f_in, cfg.hidden, cfg.heads, c
        )
        fwd = lambda p, d, key=None: sharded_gat.gatode_forward(
            p, d["pg"], d["x"], mesh, steps=cfg.steps, t1=cfg.t1,
            dropout=cfg.dropout, rng=key, remat=cfg.remat,
        )
    else:
        raise ValueError(f"unknown sharded model {cfg.model!r}")

    # Reference optimizer: torch Adam(weight_decay) = L2 added to gradients.
    tx = optax.chain(
        optax.add_decayed_weights(cfg.weight_decay), optax.adam(cfg.lr)
    )
    opt_state = tx.init(params)

    def masked_nll(lp, d, w):
        per_node = -jnp.sum(lp * d["y"], axis=-1) * w
        return jnp.sum(per_node) / jnp.maximum(jnp.sum(w), 1.0)

    def masked_acc(lp, d, w):
        hit = (jnp.argmax(lp, axis=-1) == d["labels"]).astype(jnp.float32)
        return jnp.sum(hit * w) / jnp.maximum(jnp.sum(w), 1.0)

    @jax.jit
    def train_step(params, opt_state, key, d):
        loss, grads = jax.value_and_grad(
            lambda p: masked_nll(fwd(p, d, key), d, d["w_tr"])
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def evaluate(params, d):
        lp = fwd(params, d)
        return dict(
            train_acc=masked_acc(lp, d, d["w_tr"]),
            val_loss=masked_nll(lp, d, d["w_va"]),
            val_acc=masked_acc(lp, d, d["w_va"]),
            test_acc=masked_acc(lp, d, d["w_te"]),
        )

    ckpt = None
    start_epoch = 0
    if cfg.ckpt_dir:
        from graph_odenet_tpu.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(cfg.ckpt_dir)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(
                dict(params=params, opt_state=opt_state, epoch=0)
            )
            # Restored leaves are host arrays; replicate them across the
            # mesh so they are commensurate with the shard_map step.
            rep = NamedSharding(mesh, PartitionSpec())
            params, opt_state = jax.device_put(
                (state["params"], state["opt_state"]), rep
            )
            start_epoch = int(state["epoch"]) + 1

    eval_every = cfg.eval_every or (1 if g.n_edge < 200_000 else 5)
    best = dict(val_loss=float("inf"), val_acc=0.0, test_acc=0.0, epoch=-1)
    best_params = params
    bad = 0
    losses = []
    t0 = time.time()
    step_ms = None
    drop_rng = jax.random.PRNGKey(cfg.seed + 1)
    for epoch in range(start_epoch, cfg.epochs):
        t_step = time.perf_counter()
        params, opt_state, loss = train_step(
            params, opt_state, jax.random.fold_in(drop_rng, epoch), d
        )
        loss = float(jax.block_until_ready(loss))
        if epoch > start_epoch:  # steady state: skip the compile epoch
            dt = (time.perf_counter() - t_step) * 1e3
            step_ms = dt if step_ms is None else min(step_ms, dt)
        losses.append(loss)
        if epoch % eval_every == 0 or epoch == cfg.epochs - 1:
            m = {k: float(v) for k, v in evaluate(params, d).items()}
            if m["val_loss"] < best["val_loss"]:
                best = dict(
                    val_loss=m["val_loss"], val_acc=m["val_acc"],
                    test_acc=m["test_acc"], epoch=epoch,
                )
                best_params = params
                bad = 0
            else:
                bad += 1
                if bad > cfg.patience:
                    break
        if ckpt and (epoch % cfg.ckpt_every == 0 or epoch == cfg.epochs - 1):
            ckpt.save(
                epoch, dict(params=params, opt_state=opt_state, epoch=epoch)
            )
    return dict(
        test_acc=best["test_acc"],
        val_acc=best["val_acc"],
        val_loss=best["val_loss"],
        best_epoch=best["epoch"],
        epochs_run=epoch + 1,
        step_ms=step_ms,
        loss_first=losses[0] if losses else None,
        loss_final=losses[-1] if losses else None,
        seconds=time.time() - t0,
        n_parts=n_parts,
        params=best_params,
    )
