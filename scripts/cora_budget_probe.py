"""Direct test of the round-5 saturation reading of the cora GCN-ODE
deficit: GCN-ODE's val-selected best epoch is ~140/200 while discrete
GCN is still improving at the budget.  If the deficit were a budget
artifact *against the ODE model*, doubling the budget would close it;
the saturation reading predicts the gap persists or widens (GCN keeps
gaining, GCN-ODE has peaked).

Paired seeds on the calibrated cora twin, epochs=400 (patience disabled
so both models see the full budget).  Appends to
artifacts/cora_budget_probe.jsonl (resumable).
"""

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graph_odenet_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from graph_odenet_tpu.configs import get_config  # noqa: E402
from graph_odenet_tpu.data import synthetic_planetoid  # noqa: E402
from graph_odenet_tpu.train import fit_node_classifier  # noqa: E402

OUT = "artifacts/cora_budget_probe.jsonl"
EPOCHS = int(sys.argv[1]) if len(sys.argv) > 1 else 400
N_SEEDS = int(sys.argv[2]) if len(sys.argv) > 2 else 5


def main():
    os.makedirs("artifacts", exist_ok=True)
    done = set()
    if os.path.exists(OUT):
        for line in open(OUT):
            r = json.loads(line)
            done.add((r["model"], r["seed"], r["epochs"]))
    for seed in range(N_SEEDS):
        for name in ("cora-gcn-discrete", "cora-gcnode-rk4"):
            _, cfg = get_config(name)
            model = cfg.model
            if (model, seed, EPOCHS) in done:
                continue
            cfg = dataclasses.replace(
                cfg, seed=seed, epochs=EPOCHS, patience=EPOCHS
            )
            data = synthetic_planetoid("cora", seed=seed, calibrated=True)
            res = fit_node_classifier(cfg, data)
            rec = dict(
                model=model, seed=seed, epochs=EPOCHS,
                test_acc=float(res["best"]["test_acc"]),
                val_acc=float(res["best"]["val_acc"]),
                best_epoch=int(res["best"]["epoch"]),
                seconds=round(res["seconds"], 1),
            )
            with open(OUT, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
