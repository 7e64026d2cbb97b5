"""The window's arithmetic and the per-layer readers on a made-up
record."""
from __future__ import annotations

import json
import time

import pytest

from portbench import cells, probe, train_cell
from portbench import run as prun

BENCH = json.load(open(cells.ROOT / "BENCHMARK.json"))


class _Plan:
    slots = 10_000


class _Harness:
    """A stand-in for `TrainHarness.run_span`: each slot takes ``slot_s``
    seconds, and slot ``stall_at`` another ``stall_s``."""

    def __init__(self, slot_s, stall_at=None, stall_s=0.0):
        self.slot_s, self.stall_at, self.stall_s = slot_s, stall_at, stall_s

    def run_span(self, state, plan, batcher, rng, lo, hi):
        for s in range(lo, hi):
            time.sleep(self.slot_s)
            if s == self.stall_at:
                time.sleep(self.stall_s)
        return state, None


def _ctx(harness):
    return {"harness": harness, "plan": _Plan(), "period": 4, "slot": 4,
            "state": None, "batcher": None, "rng": None,
            "tokens_per_slot": 1000}


def test_rate_is_all_tokens_over_all_time():
    ctx = _ctx(_Harness(0.01))
    win = train_cell.window(ctx, 0.1, "cpu")
    assert win["slots"] % 4 == 0 and win["slots"] >= 8
    assert win["tokens"] == 1000 * win["slots"]
    assert win["seconds"] >= 0.01 * win["slots"]
    assert win["tokens"] / win["seconds"] < 1000 / 0.01


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = train_cell.window(_ctx(_Harness(0.005)), 0.12, "cpu")
    stalled = train_cell.window(_ctx(_Harness(0.005, stall_at=6,
                                              stall_s=0.08)), 0.12, "cpu")
    r0 = steady["tokens"] / steady["seconds"]
    r1 = stalled["tokens"] / stalled["seconds"]
    assert r1 < 0.8 * r0


def _record(rows=4):
    slot = {"event": "local", "seconds": 0.2, "collectives": {},
            "stage_s": 0.0, "transfer_s": 0.0}
    ev = dict(slot, event="hub", seconds=0.5,
              collectives={"sendrecv": 6, "all_reduce": 3}, transfer_s=0.1)
    slots = [slot, ev] * 20
    prof = {"window_s": 2.0, "busy_s": 1.5,
            "ops": {"void flash_fwd_tc_kernel<128>": 0.01,
                    "void flash_bwd_tc_kernel<128>": 0.02,
                    "group_sum_kernel": 0.001},
            "ops_in_span": {"grads": 8000}, "span_calls": {"grads": 4},
            "calls": {
                "flash_fwd": [{"args": [
                    {"shape": (2, 2048, 16, 128), "dtype": "bfloat16"},
                    {"shape": (2, 2048, 8, 128), "dtype": "bfloat16"}],
                    "kwargs": {"causal": True, "window": 0}}] * 10,
                "flash_bwd": [{"args": [
                    {"shape": (2, 2048, 16, 128), "dtype": "bfloat16"},
                    {"shape": (2, 2048, 8, 128), "dtype": "bfloat16"}],
                    "kwargs": {"causal": True, "window": 0}}] * 10},
            "gaps": []}
    one = {"rows": rows, "window": {"seconds": 10.0, "slots": 40,
                                    "periods": [1.9, 2.0, 2.1, 2.0, 3.0]},
           "slots": slots, "spans": {"grads": [0.1] * 10,
                                     "update": [0.01] * 40,
                                     "mix": [0.05] * 20},
           "profile": prof, "flops_per_slot": 1e14, "missing": []}
    return dict(one, ranks=[one, one, one, one])


READERS = sorted(p.stem for p in (cells.HERE / "metrics").glob("*.py"))


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_a_record(name):
    reader = cells.metric_reader(name)
    v = reader.read(_record())
    assert v is not None and v > 0
    if reader.UNIT == "%":
        assert v <= 100


def test_readers_values():
    rec = _record()
    read = {name: cells.metric_reader(name).read(rec) for name in READERS}
    assert read["harness.event_slot_ms"] == pytest.approx(500)
    assert read["grads.worker_ms"] == pytest.approx(25)
    assert read["grads.device_ops_per_step"] == pytest.approx(500)
    # the profiled busy seconds over the unprofiled median period
    assert read["device.idle_share"] == pytest.approx(25)
    assert read["mesh.idle_share"] == pytest.approx(25)
    assert read["collectives.calls_per_event"] == pytest.approx(9)
    assert read["collectives.transfer_ms"] == pytest.approx(100)
    assert read["mesh.mfu"] == pytest.approx(read["step.mfu"] / 4)


def test_a_renamed_target_reads_null():
    cell = cells.load("qwen3-1.7b.w4.train")
    rec = _record()
    rec["missing"] = ["repro_torch.train.train_step:per_worker_grads"]
    out = prun.per_layer(cell, rec)
    assert out["grads.worker_ms"]["value"] is None
    assert out["step.mfu"]["value"] > 0


def test_probe_marks_a_missing_target():
    class R:
        SPANS = {"x": ["repro_torch.train.train_step:no_such_function"]}
    p = probe.Probe([R], "cpu").install()
    p.uninstall()
    assert p.missing == ["repro_torch.train.train_step:no_such_function"]
