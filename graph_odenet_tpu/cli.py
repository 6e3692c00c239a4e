"""CLI — reference ``python train.py --flags`` parity (SURVEY.md §2 R7/R11).

Subcommands:
  node      citation-network node classification (configs 0–2)
              python -m graph_odenet_tpu.cli node --model gcnode --dataset cora
  physics   interaction-network n-body training + rollout eval (config 3)
              python -m graph_odenet_tpu.cli physics --ode --rollout 50
  config    run a canonical BASELINE config by index
              python -m graph_odenet_tpu.cli config 1
  bench     throughput benchmarks (spmm | ode | scaling)

Flags mirror the reference argparse surface (--lr, --hidden, --dropout,
--epochs, --seed, --method, --rtol/--atol …); datasets resolve to the real
pygcn files when ``--data-path`` is given, else the synthetic twins.
"""

from __future__ import annotations

import argparse
import json
import sys


def _node(args):
    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.data.planetoid import load_planetoid
    from graph_odenet_tpu.train import NodeClassConfig, fit_node_classifier

    if args.data_path:
        data = load_planetoid(args.dataset, args.data_path)
    else:
        data = synthetic_planetoid(
            args.dataset, seed=args.seed, scale=args.scale,
            calibrated=args.calibrated,
        )
    cfg = NodeClassConfig(
        model=args.model, hidden=args.hidden, heads=args.heads,
        dropout=args.dropout, t1=args.t1, method=args.method,
        steps=args.steps, rtol=args.rtol, atol=args.atol,
        adjoint=args.adjoint, lr=args.lr, weight_decay=args.weight_decay,
        epochs=args.epochs, patience=args.patience, seed=args.seed,
        representation=args.representation, log_path=args.log_path,
        echo=not args.quiet,
    )
    res = fit_node_classifier(cfg, data)
    if args.ckpt_dir:
        from graph_odenet_tpu.utils.checkpoint import Checkpointer

        ck = Checkpointer(args.ckpt_dir)
        ck.save(max(res["best"]["epoch"], 0), dict(params=res["params"]))
    print(json.dumps(dict(best=res["best"], epochs_run=res["epochs_run"],
                          seconds=round(res["seconds"], 2))))


def _predict(args):
    """Restore trained params and evaluate/serve logits — the inference
    path (same model-building code as training; params from the
    checkpoint)."""
    import jax

    from graph_odenet_tpu.data import synthetic_planetoid
    from graph_odenet_tpu.data.planetoid import load_planetoid
    from graph_odenet_tpu.train import NodeClassConfig, build_model
    from graph_odenet_tpu.utils.checkpoint import Checkpointer
    from graph_odenet_tpu.utils.metrics import masked_accuracy

    if args.data_path:
        data = load_planetoid(args.dataset, args.data_path)
    else:
        data = synthetic_planetoid(
            args.dataset, seed=args.seed, scale=args.scale,
            calibrated=args.calibrated,
        )
    cfg = NodeClassConfig(
        model=args.model, hidden=args.hidden, heads=args.heads,
        method=args.method, steps=args.steps,
    )
    model = build_model(cfg, data.n_class)
    adj = data.graph
    params_like = model.init(jax.random.PRNGKey(0), adj, data.features)
    ck = Checkpointer(args.ckpt_dir)
    params = ck.restore(dict(params=params_like))["params"]

    @jax.jit
    def predict(params):
        return model.apply(params, adj, data.features, deterministic=True)[0]

    lp = predict(params)
    print(json.dumps(dict(
        test_acc=float(masked_accuracy(lp, data.labels, data.idx_test)),
        val_acc=float(masked_accuracy(lp, data.labels, data.idx_val)),
        n_node=int(data.graph.n_node),
    )))


def _physics(args):
    from graph_odenet_tpu.train.physics import (
        PhysicsConfig, fit_inode, fit_interaction_network,
        rollout_discrete, rollout_mse,
    )

    cfg = PhysicsConfig(
        n_bodies=args.n_bodies, n_sims=args.n_sims, n_steps=args.n_steps,
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed,
    )
    if args.ode:
        res = fit_inode(cfg)
    else:
        res = fit_interaction_network(cfg)
    out = {k: v for k, v in res.items() if isinstance(v, (int, float))}
    if args.rollout:
        import jax.numpy as jnp

        trajs = res["trajs"][:8]
        pred = rollout_discrete(
            res["forward"], res["params"], res["system"],
            trajs[:, 0], args.rollout,
        )
        out["rollout_mse"] = float(
            jnp.mean(rollout_mse(pred, trajs[:, : args.rollout + 1]))
        )
    print(json.dumps(out))


def _config(args):
    from graph_odenet_tpu.configs import run_config

    idx = int(args.index) if args.index.isdigit() else args.index
    print(json.dumps(run_config(
        idx, scale=args.scale, calibrated=args.calibrated, seed=args.seed,
        rollout=args.rollout,
    ), default=float))


def _bench(args):
    from graph_odenet_tpu import bench

    fn = dict(spmm=bench.spmm_bench, gat=bench.gat_bench,
              ode=bench.ode_bench, ode_model=bench.ode_model_bench,
              scaling=bench.scaling_bench)[args.which]
    print(json.dumps(fn(), default=float))


def main(argv=None):
    p = argparse.ArgumentParser(prog="graph_odenet_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    n = sub.add_parser("node", help="citation-network node classification")
    n.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    n.add_argument("--data-path", default=None,
                   help="dir with <name>.content/<name>.cites (else synthetic)")
    n.add_argument("--scale", type=float, default=1.0)
    n.add_argument("--model", default="gcn",
                   choices=["gcn", "resgcn", "gcnode", "gat", "resgat", "gatode"])
    n.add_argument("--hidden", type=int, default=16)
    n.add_argument("--heads", type=int, default=8)
    n.add_argument("--dropout", type=float, default=0.5)
    n.add_argument("--t1", type=float, default=1.0)
    n.add_argument("--method", default="rk4")
    n.add_argument("--steps", type=int, default=4)
    n.add_argument("--rtol", type=float, default=1e-3)
    n.add_argument("--atol", type=float, default=1e-4)
    n.add_argument(
        "--adjoint", nargs="?", const=True, default=False,
        type=lambda v: {"true": True, "false": False}.get(v.lower(), v),
        help="true | checkpoint (checkpointed-forward adjoint) | false",
    )
    n.add_argument("--lr", type=float, default=0.01)
    n.add_argument("--weight-decay", type=float, default=5e-4)
    n.add_argument("--epochs", type=int, default=200)
    n.add_argument("--patience", type=int, default=100)
    n.add_argument("--seed", type=int, default=42)
    n.add_argument("--representation", default="segment",
                   choices=["segment", "dense"],
                   help="dense: aggregate through a dense Â (GCN family)")
    n.add_argument("--log-path", default=None)
    n.add_argument("--calibrated", action="store_true",
                   help="difficulty-calibrated twin (GCN ~ published acc)")
    n.add_argument("--ckpt-dir", default=None,
                   help="save best params for `predict`")
    n.add_argument("--quiet", action="store_true")
    n.set_defaults(fn=_node)

    pr = sub.add_parser(
        "predict", help="restore trained params and evaluate (inference)"
    )
    pr.add_argument("--ckpt-dir", required=True)
    pr.add_argument("--dataset", default="cora",
                    choices=["cora", "citeseer", "pubmed"])
    pr.add_argument("--data-path", default=None)
    pr.add_argument("--scale", type=float, default=1.0)
    pr.add_argument("--calibrated", action="store_true")
    pr.add_argument("--model", default="gcn",
                    choices=["gcn", "resgcn", "gcnode", "gat", "resgat",
                             "gatode"])
    pr.add_argument("--hidden", type=int, default=16)
    pr.add_argument("--heads", type=int, default=8)
    pr.add_argument("--method", default="rk4")
    pr.add_argument("--steps", type=int, default=4)
    pr.add_argument("--seed", type=int, default=42)
    pr.set_defaults(fn=_predict)

    ph = sub.add_parser("physics", help="n-body interaction network")
    ph.add_argument("--ode", action="store_true", help="IN-ODE instead of discrete")
    ph.add_argument("--n-bodies", type=int, default=6)
    ph.add_argument("--n-sims", type=int, default=256)
    ph.add_argument("--n-steps", type=int, default=200)
    ph.add_argument("--lr", type=float, default=1e-3)
    ph.add_argument("--epochs", type=int, default=20)
    ph.add_argument("--batch-size", type=int, default=128)
    ph.add_argument("--seed", type=int, default=0)
    ph.add_argument("--rollout", type=int, default=0,
                    help="rollout horizon for eval (0 = skip)")
    ph.set_defaults(fn=_physics)

    c = sub.add_parser(
        "config", help="run canonical config (index 0-4 or a name like "
        "cora-gat; see configs.EXTRA_CONFIGS)"
    )
    c.add_argument("index")
    c.add_argument("--scale", type=float, default=1.0)
    c.add_argument("--seed", type=int, default=None)
    c.add_argument("--calibrated", action="store_true")
    c.add_argument("--rollout", type=int, default=0,
                   help="config 3: rollout-MSE horizon for the full "
                   "discrete-IN + IN-ODE deliverable (0 = train only)")
    c.set_defaults(fn=_config)

    b = sub.add_parser("bench", help="throughput benchmarks")
    b.add_argument(
        "which", choices=["spmm", "gat", "ode", "ode_model", "scaling"]
    )
    b.set_defaults(fn=_bench)

    args = p.parse_args(argv)
    from graph_odenet_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
