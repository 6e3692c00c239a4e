"""Multi-seed accuracy table on difficulty-calibrated twins (VERDICT r1
missing #1 / next #5): mean ± std for the canonical configs plus the
reference's full dataset × model sweep, on twins calibrated so discrete
GCN lands at the published real-data accuracy.

Appends one JSON line per run to artifacts/accuracy.jsonl (resumable) and
prints a markdown table at the end.

Usage: python scripts/accuracy_table.py [n_seeds] [config ...]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graph_odenet_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from graph_odenet_tpu.configs import run_config  # noqa: E402

DEFAULT = [
    0,                 # cora-gcn-discrete
    1,                 # cora-gcnode-rk4
    2,                 # citeseer-gatode-dopri5
    "citeseer-gcn",
    "pubmed-gcn",
    "cora-gat",
    "citeseer-gat",
    "pubmed-gat",
    # round 5: the paper's full model × dataset matrix (residual + ODE
    # families on every citation set; see scripts/paired_deltas.py)
    "cora-resgcn", "citeseer-resgcn", "pubmed-resgcn",
    "cora-resgat", "citeseer-resgat", "pubmed-resgat",
    "citeseer-gcnode", "pubmed-gcnode",
    "cora-gatode", "pubmed-gatode",
]

OUT = "artifacts/accuracy.jsonl"


def main():
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    configs = [
        int(c) if c.isdigit() else c for c in sys.argv[2:]
    ] or DEFAULT
    os.makedirs("artifacts", exist_ok=True)
    done = set()
    if os.path.exists(OUT):
        for line in open(OUT):
            r = json.loads(line)
            done.add((r["config"], r["seed"]))
    for c in configs:
        for seed in range(n_seeds):
            key = (str(c) if isinstance(c, str) else run_config.__module__, seed)
            # resumability key: config label + seed
            label = c if isinstance(c, str) else f"idx{c}"
            if (label, seed) in done:
                continue
            res = run_config(c, calibrated=True, seed=seed)
            rec = dict(
                config=label, canonical=res["config"], seed=seed,
                test_acc=res["best"]["test_acc"],
                val_acc=res["best"]["val_acc"],
                epoch=res["best"]["epoch"], seconds=res["seconds"],
            )
            with open(OUT, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)

    # Summarise.
    import collections

    import numpy as np

    by = collections.defaultdict(list)
    canon = {}
    for line in open(OUT):
        r = json.loads(line)
        by[r["config"]].append(r["test_acc"])
        canon[r["config"]] = r["canonical"]
    print("\n| config | test acc (mean ± std) | seeds |")
    print("|---|---|---|")
    for k, v in by.items():
        a = np.asarray(v)
        print(f"| {canon[k]} | {a.mean():.3f} ± {a.std():.3f} | {len(a)} |")


if __name__ == "__main__":
    main()
