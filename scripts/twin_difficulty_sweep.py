"""Controlled twin-difficulty sweep: does the cora GCN-ODE-vs-GCN accuracy
delta track twin difficulty, or is it an ODE-model deficiency?  (VERDICT r4
missing #1 / weak #4.)

Round 3 (easy twin, noise_words=18) measured GCN-ODE +3.3 pts over GCN;
round 4 (calibrated hard twin, noise_words=46) measured −4.4.  Two points
is a hypothesis, not a result.  This sweep holds every other knob at the
cora calibration (homophily .82, class_vocab_frac .6) and walks
noise_words 18 → 46 with PAIRED seeds (same twin instance for both models
at each (noise, seed)), so the per-seed delta is free of twin-sampling
variance.

Appends to artifacts/twin_difficulty.jsonl (resumable); prints the paired
delta table at the end.  CPU job (~40 min).

Usage: python scripts/twin_difficulty_sweep.py [n_seeds]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graph_odenet_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from graph_odenet_tpu.data import synthetic_planetoid  # noqa: E402
from graph_odenet_tpu.train import (  # noqa: E402
    NodeClassConfig, fit_node_classifier,
)

OUT = "artifacts/twin_difficulty.jsonl"
NOISES = [18, 25, 32, 39, 46]
MODELS = {
    "gcn": dict(model="gcn", hidden=16, dropout=0.5, lr=0.01,
                weight_decay=5e-4, epochs=200, patience=100),
    "gcnode": dict(model="gcnode", hidden=16, method="rk4", steps=4,
                   dropout=0.5, lr=0.01, weight_decay=5e-4, epochs=200,
                   patience=100),
}


def main():
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    os.makedirs("artifacts", exist_ok=True)
    done = set()
    if os.path.exists(OUT):
        for line in open(OUT):
            r = json.loads(line)
            done.add((r["noise_words"], r["model"], r["seed"]))
    for noise in NOISES:
        for seed in range(n_seeds):
            data = None
            for name, recipe in MODELS.items():
                if (noise, name, seed) in done:
                    continue
                if data is None:
                    # One twin instance per (noise, seed), shared by both
                    # models — the pairing that makes deltas meaningful.
                    data = synthetic_planetoid(
                        "cora", seed=seed, homophily=0.82,
                        class_vocab_frac=0.6, noise_words=noise,
                    )
                cfg = NodeClassConfig(seed=seed, **recipe)
                res = fit_node_classifier(cfg, data)
                rec = dict(
                    noise_words=noise, model=name, seed=seed,
                    test_acc=res["best"]["test_acc"],
                    val_acc=res["best"]["val_acc"],
                    epoch=res["best"]["epoch"],
                    seconds=round(res["seconds"], 1),
                )
                with open(OUT, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(json.dumps(rec), flush=True)

    # Paired-delta summary.
    import collections

    import numpy as np

    acc = collections.defaultdict(dict)
    for line in open(OUT):
        r = json.loads(line)
        acc[(r["noise_words"], r["seed"])][r["model"]] = r["test_acc"]
    print("\n| noise_words | gcn | gcnode | paired Δ (ode − discrete) |")
    print("|---|---|---|---|")
    for noise in NOISES:
        pairs = [
            (v["gcn"], v["gcnode"])
            for (nw, s), v in sorted(acc.items())
            if nw == noise and "gcn" in v and "gcnode" in v
        ]
        if not pairs:
            continue
        a = np.asarray(pairs)
        d = a[:, 1] - a[:, 0]
        print(
            f"| {noise} | {a[:,0].mean():.3f} | {a[:,1].mean():.3f} | "
            f"{d.mean():+.3f} ± {d.std():.3f} (n={len(d)}) |"
        )


if __name__ == "__main__":
    main()
