"""Config 3 end-to-end: train discrete IN + IN-ODE on the spring n-body
system and record the rollout-MSE-vs-horizon curves — the reference's
physics deliverable (SURVEY.md §2 R11, round-2 VERDICT #3).

Writes artifacts/physics_rollout.json and artifacts/physics_rollout.png.
Runs on JAX's default device; ``JAX_PLATFORMS=cpu`` picks the CPU.
The deliverable itself lives in ``train.physics.physics_rollout_curves``
and is also reachable via ``cli.py config 3 --rollout N``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from graph_odenet_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()

from graph_odenet_tpu.configs import get_config
from graph_odenet_tpu.train.physics import physics_rollout_curves
from graph_odenet_tpu.utils.plots import plot_rollout_mse

HORIZON = int(os.environ.get("GODE_HORIZON", "50"))
N_TEST = int(os.environ.get("GODE_NTEST", "64"))


def main():
    _, cfg = get_config(3)
    # Smoke-scale overrides for time-boxed runs (full config is default;
    # a small host completes GODE_NSIMS=64 GODE_EPOCHS=5 in minutes).
    if os.environ.get("GODE_EPOCHS"):
        cfg = dataclasses.replace(cfg, epochs=int(os.environ["GODE_EPOCHS"]))
    if os.environ.get("GODE_NSIMS"):
        cfg = dataclasses.replace(cfg, n_sims=int(os.environ["GODE_NSIMS"]))

    out = physics_rollout_curves(cfg, horizon=HORIZON, n_test=N_TEST)

    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/physics_rollout.json", "w") as f:
        json.dump(out, f, indent=1)
    plot_rollout_mse(
        [out["rollout_mse_discrete"], out["rollout_mse_inode"]],
        labels=["discrete IN", "IN-ODE"],
        path="artifacts/physics_rollout.png",
    )
    for h in (1, 5, 10, 20, 50):
        if h <= HORIZON:
            print(
                f"h={h:3d}  discrete={out['rollout_mse_discrete'][h]:.4e}"
                f"  inode={out['rollout_mse_inode'][h]:.4e}",
                flush=True,
            )
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, (list, dict))}))


if __name__ == "__main__":
    main()
