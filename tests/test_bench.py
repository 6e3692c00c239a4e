"""Bench harness smoke tests (tiny sizes) — the BASELINE metric plumbing."""

import pytest

from graph_odenet_tpu.bench import (
    gat_bench, ode_bench, scaling_bench, spmm_bench,
)


def test_spmm_bench_smoke():
    r = spmm_bench(n_nodes=512, n_edges=4_000, feat=32, iters=2)
    assert r["edges_per_s"] > 0
    assert r["n_edge"] >= 4_000  # symmetrised + self loops


def test_gat_bench_smoke():
    r = gat_bench(n_nodes=512, n_edges=4_000, heads=2, feat=8, iters=2)
    assert r["edges_per_s"] > 0
    assert r["ms"] > 0 and r["heads"] == 2


def test_ode_bench_smoke():
    r = ode_bench(n_nodes=256, feat=16, iters=2)
    assert r["nfe"] >= 8  # at least two dopri5 steps
    assert r["nfe_per_s"] > 0


def test_scaling_bench_smoke():
    import jax

    nd = min(4, len(jax.devices()))
    if nd < 2:
        pytest.skip("needs a multi-device mesh")
    r = scaling_bench(n_devices=nd, n_nodes=256, deg=8, feat=32, iters=2)
    assert r["speedup"] > 0
