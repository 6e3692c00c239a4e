"""Calibrate the synthetic OGBN-arxiv twin's difficulty (VERDICT r4 #4).

Probes the full-scale R7 GCN recipe (hidden 256, Adam lr .01, wd 5e-4,
val early-stop — the config-4 backbone) on candidate difficulty knobs
until the twin's test accuracy lands near the real dataset's ~0.71
(OGB leaderboard GCN), the same methodology the planetoid twins got
(data.planetoid.CALIBRATED).  Run on one GPU (segment representation).
Appends to artifacts/arxiv_calibration.jsonl.

Usage: python scripts/calibrate_arxiv_twin.py [epochs]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from graph_odenet_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv  # noqa: E402
from graph_odenet_tpu.train import (  # noqa: E402
    NodeClassConfig, fit_node_classifier,
)

OUT = "artifacts/arxiv_calibration.jsonl"

# (feature_noise, confusion) candidates, easy → hard.  The abs+rownorm
# transform gives feature_noise a sharp cliff past ~1.0 (measured: 0.8 →
# .85, 0.85 → .71, 0.9 → .63, 1.2 → random at 5% scale); full scale runs
# ~10 pts easier, so probe 0.88–0.98 with a little confusion.
GRID = [
    (0.8, 0.0),    # the uncalibrated round-2 twin (reference point)
    # Full-observable confusion (features + wiring): irreducible error,
    # ceiling ≈ 1 − q, epoch-robust.  q=0.30 targets the real ~0.71.
    (0.8, 0.3),
    (0.8, 0.25),
    (0.8, 0.22),
    (0.8, 0.235),
]


def main():
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    os.makedirs("artifacts", exist_ok=True)
    done = set()
    if os.path.exists(OUT):
        for line in open(OUT):
            r = json.loads(line)
            done.add((r["feature_noise"], r["confusion"], r["epochs"]))
    for noise, conf in GRID:
        key = (noise, conf, epochs)
        if key in done:
            print(f"skip {key}", flush=True)
            continue
        data = synthetic_ogbn_arxiv(
            seed=0, feature_noise=noise, confusion=conf
        )
        cfg = NodeClassConfig(
            model="gcn", hidden=256, dropout=0.5, lr=0.01,
            weight_decay=5e-4, epochs=epochs, patience=100,
        )
        res = fit_node_classifier(cfg, data)
        rec = dict(
            feature_noise=noise, confusion=conf,
            epochs=epochs, test_acc=res["best"]["test_acc"],
            val_acc=res["best"]["val_acc"], best_epoch=res["best"]["epoch"],
            seconds=round(res["seconds"], 1),
        )
        with open(OUT, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
