"""The comparison has to fail: a run of the cell with the timed path
broken underneath, once for each fault a training cell can have, and the
control (the reference in fp8 in the program's place).  At smoke sizes on
the CPU, with the limits of a float32 run."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import check, control, mesh_cell
from portbench import run as prun
from portbench.tests import smallcells
from repro_torch.core import protocol
from repro_torch.launch import harness as harness_mod
from repro_torch.train import train_step

LIMITS = {k: 1e-3 for k in check.NUMBERS}


def _unchanged(monkeypatch):
    real = harness_mod.mll_harness_step

    def step(state, *a, **k):
        params = [x.clone() for x in check._leaves(state.params)]
        new, metrics = real(state, *a, **k)
        with torch.no_grad():
            for dst, src in zip(check._leaves(new.params), params):
                dst.copy_(src)
        return new, metrics
    monkeypatch.setattr(harness_mod, "mll_harness_step", step)


def _half_batch(monkeypatch):
    real = train_step.per_worker_grads

    def grads(params, batch, cfg, **k):
        half = {n: v[:, : v.shape[1] // 2] for n, v in batch.items()}
        return real(params, half, cfg, **k)
    monkeypatch.setattr(train_step, "per_worker_grads", grads)


def _no_exchange(monkeypatch, names=("subnet_with_state", "hub_with_state")):
    for name in names:
        monkeypatch.setattr(protocol.MixingStrategy, name,
                            lambda self, x, st, state, *a: (x, state))


def _no_hub(monkeypatch):
    _no_exchange(monkeypatch, ("hub_with_state",))


def _altered(monkeypatch):
    real = train_step.per_worker_grads

    def grads(params, batch, cfg, **k):
        g, metrics = real(params, batch, cfg, **k)
        with torch.no_grad():
            for x in check._leaves(g):
                x[0].neg_()
        return g, metrics
    monkeypatch.setattr(train_step, "per_worker_grads", grads)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "no_hub": _no_hub,
          "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    cell = smallcells.small("qwen3-1.7b.w4.train", limits=LIMITS)
    out = prun.run_one(cell, 4321, 0.2, False, "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]
    if fault == "no_hub":
        assert out["checks"]["mix_hub"]["value"] > 1e-3


def _keep_rows(local, st, spmd, mix_dtype=None):
    return local


def rank_without_exchange(*args):
    """`mesh_cell.rank_main` with the sub-network and hub collectives left
    out: each rank keeps its own rows."""
    protocol.subnet_average_two_stage_spmd = _keep_rows
    protocol.hub_average_two_stage_spmd = _keep_rows
    return mesh_cell.rank_main(*args)


def rank_without_hub(*args):
    """`mesh_cell.rank_main` with the hub stage's send / recv rolls left
    out: the sub-networks never mix."""
    protocol.hub_average_two_stage_spmd = _keep_rows
    return mesh_cell.rank_main(*args)


@pytest.mark.parametrize("rank_fn,number", [
    (rank_without_exchange, "mix_subnet"), (rank_without_hub, "mix_hub")])
def test_the_exchange_left_out_across_ranks_is_not_correct(rank_fn, number):
    cell = smallcells.small("qwen3-1.7b.w4.nccl4", limits=LIMITS)
    out = mesh_cell.run(cell, 555, 0.2, False, time.time(), kind="cpu",
                        log=lambda *_: None, rank_fn=rank_fn)
    assert not out["correct"], out["checks"]
    assert out["checks"][number]["value"] > 1e-3


def test_control_and_planted_faults_fail_a_number():
    cell = smallcells.small("qwen3-1.7b.w4.train", limits=LIMITS)
    rows = control.readings(cell, 2024, "cpu", log=lambda *_: None)
    assert len(rows) == len(control.VARIANTS)
    for row in rows:
        worst = max(row[k] / LIMITS[k] for k in check.NUMBERS)
        assert worst > 1, row
