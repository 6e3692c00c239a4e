"""chip_smoke.py's own logic, on the CPU: it refuses to run without a GPU,
prints the exact last line of the contract, runs the sharded phase alone
under ``--four-cards``, and its 4-against-1 mesh comparison holds on 4
virtual CPU devices."""

import json
import types

import jax
import pytest

import chip_smoke
from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv


def fake_devices(n, platform="gpu", kind="NVIDIA H100 80GB HBM3"):
    return [types.SimpleNamespace(platform=platform, device_kind=kind)] * n


def test_refuses_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert out == ""                      # no phase line, no ok line
    assert "not a GPU" in err


def test_ok_line_is_exact():
    assert chip_smoke.ok_line(fake_devices(1)) == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    rec = json.loads(chip_smoke.ok_line(fake_devices(4)))
    assert rec == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_phase_selection_and_device_checks():
    parse, pick = chip_smoke.parse_args, chip_smoke.selected_phases
    assert pick(parse(["--four-cards"])) == ("sharded",)
    assert pick(parse([])) == (
        "ops", "train", "physics", "reference", "repr",
    )
    with pytest.raises(SystemExit):  # no option picks a subset of phases
        parse(["--phases", "ops"])
    chip_smoke.check_devices(fake_devices(4), need=4)
    with pytest.raises(chip_smoke.NoAccelerator):
        chip_smoke.check_devices(fake_devices(1), need=4)
    with pytest.raises(chip_smoke.NoAccelerator):
        chip_smoke.check_devices(fake_devices(1, platform="cpu"), need=1)


@pytest.fixture(scope="module")
def tiny_arxiv():
    return synthetic_ogbn_arxiv(seed=0, scale=0.004)


@pytest.mark.usefixtures("no_compile_cache")
@pytest.mark.parametrize(
    "model,mode,width",
    [
        ("gcnode", "ring", dict(hidden=16, dropout=0.5)),
        ("gcnode", "allgather", dict(hidden=16, dropout=0.5)),
        ("gatode", "ring", dict(hidden=4, heads=2, dropout=0.6)),
    ],
)
def test_sharded_parity_four_virtual_devices(tiny_arxiv, model, mode, width):
    rec = chip_smoke.sharded_parity(
        tiny_arxiv, model, mode, jax.devices()[:4], steps=2, **width
    )
    assert rec["n_devices"] == 4
    assert rec["loss_rel"] <= chip_smoke.PARITY_TOL, rec
    assert rec["grad_rel"] <= chip_smoke.PARITY_TOL, rec
