"""The plain references against the port at smoke sizes on the CPU: a
sound run is correct with tight limits, and the reference's gate is the
program's draw."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import check, mesh_cell, program
from portbench import run as prun
from portbench.reference import mll as ref_mll
from portbench.tests import smallcells
from repro_torch.core import protocol

TIGHT = {k: 1e-4 for k in check.NUMBERS}


def test_port_equals_reference_in_float32():
    cell = smallcells.small("qwen3-1.7b.w4.train", limits=TIGHT)
    out = prun.run_one(cell, 2 ** 31 + 12345, 0.3, False, "cpu",
                       time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_port_within_bfloat16_rounding_of_reference():
    cell = smallcells.small("qwen3-1.7b.w4.train", dtype="bfloat16",
                            limits={"loss": 1e-2, "grad1": 0.2,
                                    "mix_subnet": 1e-6, "mix_hub": 1e-6,
                                    "change": 0.2})
    out = prun.run_one(cell, 77, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["mix_subnet"]["value"] == 0.0
    assert out["checks"]["mix_hub"]["value"] == 0.0


def test_mesh_on_gloo_equals_reference():
    cell = smallcells.small("qwen3-1.7b.w4.nccl4", limits=TIGHT)
    out = mesh_cell.run(cell, 31337, 0.3, False, time.time(), kind="cpu",
                        log=lambda *_: None)
    assert out["correct"], out["checks"]
    assert out["checks"]["mix_hub"]["value"] < 1e-4
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1, 2 ** 31 + 5,
                                  4_000_000_000])
def test_gate_is_the_programs_draw(seed):
    rates = torch.tensor([1.0, 0.8, 1.0, 0.6])
    s = program.mll_seed(seed)
    for step in (1, 2, 3, 17, 1000):
        want = protocol.gate_sample(s, step, rates).numpy()
        got = ref_mll.gate(s, step, rates.numpy())
        np.testing.assert_array_equal(got, want)


def test_operators_are_the_programs():
    from repro_torch.core.mllsgd import MLLConfig, build_network
    net = {"subnets": 2, "workers_per_subnet": 2, "topology": "ring"}
    ops = ref_mll.operators(net)
    mll = MLLConfig(hub_topology="ring", worker_rates=(1.0, 0.8, 1.0, 0.6))
    network = build_network(mll, 2, 2)
    np.testing.assert_allclose(ops["V"], network.v_matrix())
    np.testing.assert_allclose(ops["Z"], network.z_matrix())
    for d in (3, 5):
        h = ref_mll.hub_matrix("ring", d, np.full(d, 1 / d))
        want = build_network(MLLConfig(hub_topology="ring"), d, 1)
        np.testing.assert_allclose(h, want.hub_net.h)


def test_program_readings_equal_reference_in_float32():
    """`control.py --program` reads the program through a run's own
    set-up: in float32 it agrees with the reference."""
    from portbench import control
    cell = smallcells.small("qwen3-1.7b.w4.train", limits=TIGHT)
    rows = control.readings(cell, 99, "cpu", variants=(),
                            log=lambda *_: None, with_program=True)
    assert [r["variant"] for r in rows] == ["program"]
    assert all(rows[0][k] <= TIGHT[k] for k in check.NUMBERS), rows


def test_compared_ticks_reach_the_hub_event():
    cell = smallcells.small("qwen3-1.7b.w4.train")
    tr = cell.traffic
    assert tr["compare_steps"] >= tr["plan"]["tau"] * tr["plan"]["q"]
    assert check.hub_tick(tr) == 4
    with pytest.raises(ValueError, match="hub event"):
        check.hub_tick(dict(tr, compare_steps=3))
