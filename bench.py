#!/usr/bin/env python
"""SpMM forward+backward edges/s on one device (BASELINE metric).

Builds an OGBN-arxiv-scale synthetic power-law graph (the config [4]
workload shape) and times the segment-sum aggregation path
(``ops.spmm_segment``) through a jitted forward+backward pass.

Prints exactly one JSON line:
  {"metric": "spmm_fwd_bwd_edges_per_s_per_chip", "value": ..., "unit":
   "edges/s", "n_node": ..., "n_edge": ..., "feat": ..., "device": ...}

Sizes: BENCH_NODES, BENCH_EDGES, BENCH_FEAT, BENCH_ITERS.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax

    from graph_odenet_tpu.bench import spmm_bench
    from graph_odenet_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    n_nodes = int(os.environ.get("BENCH_NODES", 169_343))
    n_edges = int(os.environ.get("BENCH_EDGES", 1_166_243))
    feat = int(os.environ.get("BENCH_FEAT", 128))
    iters = int(os.environ.get("BENCH_ITERS", 30))

    rec = spmm_bench(n_nodes, n_edges, feat=feat, iters=iters)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "spmm_fwd_bwd_edges_per_s_per_chip",
        "value": rec["edges_per_s"],
        "unit": "edges/s",
        "n_node": n_nodes,
        "n_edge": rec["n_edge"],
        "feat": feat,
        "device": f"{dev.platform}:{dev.device_kind}",
    }))


if __name__ == "__main__":
    main()
