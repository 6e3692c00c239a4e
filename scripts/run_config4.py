"""Config 4 end-to-end: a completed training run of the edge-partitioned
GCN-ODE (the full R7 recipe, dropout live) over every visible device (at
most 8) on synthetic ogbn-arxiv.  Writes artifacts/config4_run.json.

Knobs: GODE_MODE=ring|allgather (halo flavour), GODE_MODEL=gcnode|gatode,
GODE_CALIBRATED=1 (difficulty-calibrated twin), GODE_TAG=<suffix> for the
artifact name.

Usage: GODE_SCALE=0.25 python scripts/run_config4.py
On the CPU, as an 8-device mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      GODE_SCALE=0.25 python scripts/run_config4.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from graph_odenet_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()

SCALE = float(os.environ.get("GODE_SCALE", "0.25"))
EPOCHS = int(os.environ.get("GODE_EPOCHS", "30"))
MODE = os.environ.get("GODE_MODE", "")
MODEL = os.environ.get("GODE_MODEL", "")
CALIBRATED = os.environ.get("GODE_CALIBRATED", "0") == "1"
REMAT = os.environ.get("GODE_REMAT", "0") == "1"
TAG = os.environ.get("GODE_TAG", "")


def main():
    from graph_odenet_tpu.configs import get_config
    from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv
    from graph_odenet_tpu.parallel.trainer import (
        ShardedTrainConfig,
        fit_sharded_node_classifier,
    )

    _, cfg = get_config(4)
    t0 = time.time()
    data = synthetic_ogbn_arxiv(seed=0, scale=SCALE, calibrated=CALIBRATED)
    model = MODEL or cfg.model
    tcfg = ShardedTrainConfig(
        model=model, hidden=cfg.hidden if model == "gcnode" else 64,
        heads=4, steps=cfg.steps, t1=cfg.t1,
        lr=cfg.lr, weight_decay=cfg.weight_decay, epochs=EPOCHS,
        patience=cfg.patience, mode=MODE or cfg.mode, remat=REMAT,
        dropout=cfg.dropout if model == "gcnode" else 0.6,
        n_parts=min(cfg.n_parts, len(jax.devices())),
    )
    res = fit_sharded_node_classifier(tcfg, data)
    res.pop("params", None)
    res.update(config="ogbn-arxiv-gcnode-sharded", dataset=data.name)
    res["scale"] = SCALE
    res["epochs"] = EPOCHS
    res["mode"] = tcfg.mode
    res["model"] = model
    res["calibrated"] = CALIBRATED
    res["platform"] = jax.default_backend()
    res["wall_seconds"] = round(time.time() - t0, 1)
    os.makedirs("artifacts", exist_ok=True)
    path = f"artifacts/config4_run{('_' + TAG) if TAG else ''}.json"
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=float)
    print(json.dumps(res, default=float), flush=True)


if __name__ == "__main__":
    main()
