"""Canonical experiment configs — one per BASELINE.json ``configs`` entry.

  0  2-layer GCN on Cora (discrete baseline, full-batch, CPU-runnable)
  1  GCN-ODE on Cora, fixed-step RK4 (4 steps)
  2  GAT-ODE on Citeseer with adaptive dopri5 (SDDMM attention)
  3  Interaction-network ODE on n-body springs, rollout MSE
  4  Edge-partitioned GCN-ODE on OGBN-arxiv, multi-device halo exchange

Each entry returns (kind, config) where kind selects the trainer:
``node`` → train.node_classification, ``physics`` → train.physics,
``sharded`` → parallel.sharded_gcn.
"""

from __future__ import annotations

import dataclasses

from graph_odenet_tpu.train.node_classification import NodeClassConfig
from graph_odenet_tpu.train.physics import PhysicsConfig

__all__ = ["get_config", "run_config", "CONFIG_NAMES"]

CONFIG_NAMES = {
    0: "cora-gcn-discrete",
    1: "cora-gcnode-rk4",
    2: "citeseer-gatode-dopri5",
    3: "nbody-inode-rollout",
    4: "ogbn-arxiv-gcnode-sharded",
}

# Named extras beyond the BASELINE entries: the reference's full dataset ×
# model sweep (GCN on all three citation sets; the canonical Veličković
# GAT recipe — 8 heads × 8 hidden, dropout 0.6, lr 0.005).
_GAT_RECIPE = dict(
    model="gat", hidden=8, heads=8, dropout=0.6,
    lr=0.005, weight_decay=5e-4, epochs=300, patience=100,
)
_GCN_RECIPE = dict(
    model="gcn", hidden=16, dropout=0.5, lr=0.01,
    weight_decay=5e-4, epochs=200, patience=100,
)
_RESGCN_RECIPE = dict(_GCN_RECIPE, model="resgcn", n_blocks=2)
_RESGAT_RECIPE = dict(_GAT_RECIPE, model="resgat", n_blocks=2)
_GCNODE_RECIPE = dict(
    model="gcnode", hidden=16, method="rk4", steps=4, dropout=0.5,
    lr=0.01, weight_decay=5e-4, epochs=200, patience=100,
)
_GATODE_RECIPE = dict(
    model="gatode", hidden=8, heads=8, method="dopri5_scan",
    steps=32, rtol=1e-3, atol=1e-4, dropout=0.6,
    lr=0.005, weight_decay=5e-4, epochs=300, patience=100,
)
EXTRA_CONFIGS = {
    "citeseer-gcn": ("citeseer", _GCN_RECIPE),
    "pubmed-gcn": ("pubmed", _GCN_RECIPE),
    "cora-gat": ("cora", _GAT_RECIPE),
    "citeseer-gat": ("citeseer", _GAT_RECIPE),
    "pubmed-gat": ("pubmed", _GAT_RECIPE),
    # The paper's full model × dataset sweep (SURVEY.md §6): residual
    # discrete baselines + both ODE families on every citation set.
    # (cora-gcnode ≡ config 1, citeseer-gatode ≡ config 2.)
    "cora-resgcn": ("cora", _RESGCN_RECIPE),
    "citeseer-resgcn": ("citeseer", _RESGCN_RECIPE),
    "pubmed-resgcn": ("pubmed", _RESGCN_RECIPE),
    "cora-resgat": ("cora", _RESGAT_RECIPE),
    "citeseer-resgat": ("citeseer", _RESGAT_RECIPE),
    "pubmed-resgat": ("pubmed", _RESGAT_RECIPE),
    "citeseer-gcnode": ("citeseer", _GCNODE_RECIPE),
    "pubmed-gcnode": ("pubmed", _GCNODE_RECIPE),
    "cora-gatode": ("cora", _GATODE_RECIPE),
    "pubmed-gatode": ("pubmed", _GATODE_RECIPE),
}


@dataclasses.dataclass
class ShardedConfig:
    dataset: str = "ogbn-arxiv"
    model: str = "gcnode"
    hidden: int = 256
    steps: int = 4
    t1: float = 1.0
    lr: float = 0.01
    weight_decay: float = 5e-4
    epochs: int = 30
    patience: int = 100
    mode: str = "ring"   # halo exchange flavour
    dropout: float = 0.5  # R7 feature dropout (gatode adds attention dropout)
    n_parts: int = 8
    ckpt_dir: str | None = None


def get_config(i):
    if isinstance(i, str):
        if i in EXTRA_CONFIGS:
            _, recipe = EXTRA_CONFIGS[i]
            return "node", NodeClassConfig(**recipe)
        inv = {v: k for k, v in CONFIG_NAMES.items()}
        if i in inv:
            return get_config(inv[i])
        raise KeyError(i)
    if i == 0:
        return "node", NodeClassConfig(
            model="gcn", hidden=16, dropout=0.5, lr=0.01,
            weight_decay=5e-4, epochs=200, patience=100,
        )
    if i == 1:
        return "node", NodeClassConfig(
            model="gcnode", hidden=16, method="rk4", steps=4,
            dropout=0.5, lr=0.01, weight_decay=5e-4, epochs=200,
        )
    if i == 2:
        return "node", NodeClassConfig(
            model="gatode", hidden=8, heads=8, method="dopri5_scan",
            steps=32, rtol=1e-3, atol=1e-4, dropout=0.6,
            lr=0.005, weight_decay=5e-4, epochs=300, patience=100,
        )
    if i == 3:
        return "physics", PhysicsConfig(
            n_bodies=6, n_sims=256, n_steps=200,
            ode_method="dopri5_scan", ode_steps=16, ode_window=10,
        )
    if i == 4:
        return "sharded", ShardedConfig()
    raise KeyError(i)


_CONFIG_DATASET = {0: "cora", 1: "cora", 2: "citeseer"}


def run_config(
    i,
    *,
    scale: float = 1.0,
    data_path: str | None = None,
    calibrated: bool = False,
    seed: int | None = None,
    rollout: int = 0,
    epochs: int | None = None,
):
    """Execute canonical config ``i`` (index or name) end-to-end.

    ``scale`` shrinks the synthetic dataset for smoke runs; ``data_path``
    points at real pygcn-format files (node configs); ``calibrated`` uses
    the difficulty-calibrated twins (data.planetoid.CALIBRATED) so twin
    accuracy is comparable to the published real-data numbers; ``seed``
    overrides the config seed (multi-seed accuracy tables); ``epochs``
    overrides its epoch budget (smoke runs); ``rollout``
    (physics config only) > 0 runs the full deliverable — discrete IN +
    IN-ODE trained on shared data and evaluated by rollout MSE over that
    horizon (``train.physics.physics_rollout_curves``).
    """
    kind, cfg = get_config(i)
    cfg_name = CONFIG_NAMES[i] if isinstance(i, int) else i
    if seed is not None and hasattr(cfg, "seed"):
        cfg = dataclasses.replace(cfg, seed=seed)
    if epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=epochs)
    if kind == "node":
        from graph_odenet_tpu.data import synthetic_planetoid
        from graph_odenet_tpu.data.planetoid import load_planetoid
        from graph_odenet_tpu.train import fit_node_classifier

        name = (
            _CONFIG_DATASET[i] if isinstance(i, int)
            else EXTRA_CONFIGS.get(i, (i.split("-")[0], None))[0]
        )
        data = (
            load_planetoid(name, data_path)
            if data_path
            else synthetic_planetoid(
                name, seed=cfg.seed, scale=scale, calibrated=calibrated
            )
        )
        res = fit_node_classifier(cfg, data)
        return dict(config=cfg_name, dataset=data.name, best=res["best"],
                    seconds=round(res["seconds"], 2))
    if kind == "physics":
        from graph_odenet_tpu.train.physics import (
            fit_inode, physics_rollout_curves,
        )

        if scale != 1.0:
            cfg = dataclasses.replace(
                cfg,
                n_sims=max(8, int(cfg.n_sims * scale)),
                n_steps=max(20, int(cfg.n_steps * scale)),
            )
        if rollout > 0:
            out = physics_rollout_curves(
                cfg, horizon=rollout, n_test=max(4, int(64 * scale))
            )
            return {**out, "config": cfg_name}
        res = fit_inode(cfg)
        out = {k: v for k, v in res.items() if isinstance(v, (int, float))}
        return dict(config=cfg_name, **out)
    if kind == "sharded":
        # A real end-to-end training run (the R7 recipe — Adam + weight
        # decay + val early-stop + checkpoints) of the edge-parallel
        # GCN-ODE over the device mesh, on (synthetic) ogbn-arxiv.
        import jax

        from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv
        from graph_odenet_tpu.parallel.trainer import (
            ShardedTrainConfig, fit_sharded_node_classifier,
        )

        n_parts = min(cfg.n_parts, len(jax.devices()))
        data = synthetic_ogbn_arxiv(seed=0, scale=scale)
        tcfg = ShardedTrainConfig(
            model=cfg.model, hidden=cfg.hidden, steps=cfg.steps, t1=cfg.t1,
            lr=cfg.lr, weight_decay=cfg.weight_decay, epochs=cfg.epochs,
            patience=cfg.patience, mode=cfg.mode, dropout=cfg.dropout,
            n_parts=n_parts, ckpt_dir=cfg.ckpt_dir,
        )
        res = fit_sharded_node_classifier(tcfg, data)
        res.pop("params")
        return dict(config=cfg_name, dataset=data.name, **res)
    raise KeyError(i)
