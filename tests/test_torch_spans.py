"""The spans of a traced training slot (`repro_torch.launch.spans`) on the
CPU: nothing built while tracing is off, nothing imported beyond the
harness's own modules, the span tree of each event kind, the trajectory
unchanged by tracing, the slot record's keys, and the five readings of
`repro_torch.launch.span_readings`.

The model is qwen3-1.7b's smoke config in float32, W = 2 x 2 on a ring,
tau = q = 2, so slots 0-3 are local, sub-network, local and hub events
under ``deadline`` (composed operators under ``gossip``).  The card's
side (events, lags, the clock against the profiler's) is in
`tests/test_torch_cuda.py`.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import protocol
from repro_torch.core.mllsgd import MLLConfig, build_network, build_state
from repro_torch.core.simulator import replicate
from repro_torch.core.timeline import get_policy
from repro_torch.data.pipeline import LMBatcher, make_token_stream
from repro_torch.launch import harness as tharness
from repro_torch.launch import span_readings, spans
from repro_torch.models import model as model_mod
from repro_torch.tree import tree_leaves

CFG = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                          param_dtype="float32", compute_dtype="float32")
RATES = (1.0, 0.8, 1.0, 0.6)
KEYS = {"event", "seconds", "collectives", "stage_s", "transfer_s"}
# (policy, mixing, overlap): the three paths of a mixing round
PATHS = [("deadline", "two_stage", "none"), ("gossip", "dense", "none"),
         ("deadline", "two_stage", "chunked")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(slot_stats, slots=4, policy="deadline", mixing="two_stage",
         overlap="none"):
    """``slots`` plan slots from a fixed start -> (harness, state, the last
    slot's metrics)."""
    mll = MLLConfig(tau=2, q=2, eta=0.05, hub_topology="ring",
                    worker_rates=RATES, mixing=mixing)
    net = build_network(mll, 2, 2)
    st = build_state(mll, net, device="cpu")
    plan = get_policy(policy).plan(net, mll.schedule, 8,
                                   np.random.default_rng(0))
    h = tharness.TrainHarness(CFG, mll, st, gate_mode=plan.gate_mode,
                              overlap=overlap, slot_stats=slot_stats)
    params = model_mod.init_model(torch.Generator().manual_seed(0), CFG,
                                  device="cpu")
    state = protocol.init_train_state(replicate(params, 4), cfg=mll)
    batcher = LMBatcher(make_token_stream(4, 400, vocab_size=CFG.vocab_size,
                                          seed=0), 16, 2)
    state, m = h.run_span(state, plan, batcher, np.random.default_rng(0),
                          0, slots)
    return h, state, m


def test_off_builds_nothing(monkeypatch):
    """With ``slot_stats=None`` a local, a sub-network and a hub slot make
    no tracer and no CUDA event, and every span is the shared null
    context."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made while tracing is off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    opened = []
    monkeypatch.setattr(spans.Tracer, "open",
                        lambda self, name: opened.append(name))
    h, _, m = _run(None)
    assert torch.isfinite(m["loss"]).all()
    assert h._tracer is None and spans._active is None and not opened
    assert spans.span("grads") is spans._NULL


def test_off_imports_nothing_more():
    """In a fresh process: importing the tracer adds no ``torch.*``
    module, and the harness with one CPU slot loads neither dynamo nor
    inductor."""
    here = Path(__file__).resolve().parent
    code = f"""
import json, sys
sys.path[:0] = [{str(here.parent / "src")!r}, {str(here)!r}]
import torch
before = set(sys.modules)
from repro_torch.launch import span_readings, spans
added = sorted(m for m in set(sys.modules) - before
               if m == "torch" or m.startswith("torch."))
import test_torch_spans as t
t._run(None, slots=1)
print(json.dumps({{"added": added, "loaded": [
    m for m in ("torch._dynamo", "torch._inductor") if m in sys.modules]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"added": [], "loaded": []}


def _children(tree, i):
    return [s for s in tree if s["parent"] == i]


@pytest.mark.parametrize("path", PATHS, ids=lambda p: "-".join(p))
def test_span_tree_of_each_event_kind(path):
    policy, mixing, overlap = path
    stats = []
    _run(stats, policy=policy, mixing=mixing, overlap=overlap)
    kinds = {s["event"] for s in stats}
    assert "local" in kinds and (kinds - {"local"})
    for rec in stats:
        tree = rec["spans"]
        root = tree[0]
        assert root["name"] == "slot" and root["parent"] is None
        assert [s["parent"] for s in tree[1:]].count(None) == 0
        top = [s["name"] for s in _children(tree, 0)]
        want = ["grads", "update"] + (["mix"] if rec["event"] != "local"
                                      else [])
        assert top == want
        g = [s["name"] for s in tree].index("grads")
        rows = [s["name"] for s in _children(tree, g)]
        assert rows == ["forward", "backward", "grad_copy"] * 4
        for s in tree:
            assert s["device"] is None
            lo, hi = s["host"]
            assert 0 <= lo <= hi
            if s["parent"] is not None:
                plo, phi = tree[s["parent"]]["host"]
                assert plo <= lo and hi <= phi
        kids = sorted(s["host"] for s in _children(tree, 0))
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))


def test_trajectory_is_the_same_traced():
    """tau * q slots traced and untraced: the same params, optimizer
    state and losses, bit for bit."""
    _, a, ma = _run(None)
    _, b, mb = _run([])
    for x, y in zip(tree_leaves((a.params, a.opt_state, ma)),
                    tree_leaves((b.params, b.opt_state, mb))):
        assert torch.equal(x, y)


def test_slot_record_keeps_its_keys():
    stats = []
    _run(stats)
    assert [s["event"] for s in stats] == ["local", "subnet", "local", "hub"]
    for s in stats:
        assert set(s) == KEYS | {"spans"}
        assert s["seconds"] > 0 and s["collectives"] == {}
        assert s["stage_s"] == s["transfer_s"] == 0
        # the timed interval lies inside the root span
        lo, hi = s["spans"][0]["host"]
        assert s["seconds"] <= hi - lo


def test_spans_lie_in_a_profiler_trace():
    """Under ``torch.profiler`` each span opens a `record_function` range
    of its name, traced or not."""
    from torch.profiler import ProfilerActivity, profile
    for stats in (None, []):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _run(stats, slots=2)
        names = [e.name for e in prof.events()]
        for name, n in (("grads", 2), ("forward", 8), ("grad_copy", 8),
                        ("update", 2), ("mix", 1)):
            assert names.count(name) == n, (name, stats)
        assert names.count("slot") == (0 if stats is None else 2)
    assert spans._active is None


def _made_up(rows, mix):
    """A slot's spans: 1 ms of the executor's own, each worker's 30 ms of
    host time with the card 20 ms behind, a 20 ms update and, with
    ``mix``, a 10 ms mixing round."""
    def span(name, parent, h0, h1, lag):
        return {"name": name, "parent": parent, "host": [h0, h1],
                "device": [h0 + lag, h1 + lag]}
    tree = [span("grads", 0, 0.001, 0.001 + 0.03 * rows, 0.02)]
    for r in range(rows):
        t = 0.001 + 0.03 * r
        tree += [span("forward", 1, t, t + 0.01, 0.02),
                 span("backward", 1, t + 0.01, t + 0.025, 0.02),
                 span("grad_copy", 1, t + 0.025, t + 0.03, 0.02)]
    t = 0.001 + 0.03 * rows
    tree.append(span("update", 0, t, t + 0.02, 0.0))
    if mix:
        tree.append(span("mix", 0, t + 0.02, t + 0.03, 0.0))
    end = t + 0.02 + 0.01 * mix
    return [span("slot", None, 0.0, end, 0.0)] + tree


def _made_up_stats(rows=4):
    local = {"event": "local", "seconds": 0.2, "collectives": {},
             "stage_s": 0.0, "transfer_s": 0.0, "spans": _made_up(rows, False)}
    hub = dict(local, event="hub", spans=_made_up(rows, True))
    return [local, hub] * 20


READINGS = {"harness.self_ms": 1.0, "grads.enqueue_ms": 30.0,
            "grads.device_lag_ms": 20.0, "protocol.update_enqueue_ms": 20.0,
            "protocol.mix_enqueue_ms": 10.0}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reading_of_made_up_spans(name):
    got = span_readings.readings(_made_up_stats())
    assert set(got) == set(READINGS)
    assert got[name] == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reading_is_none_without_spans(name):
    stats = _made_up_stats()
    for slot in stats:
        slot.pop("spans", None)
    assert span_readings.readings(stats)[name] is None


def test_lag_is_none_off_the_card():
    stats = _made_up_stats(rows=2)
    for slot in stats:
        for s in slot["spans"]:
            s["device"] = None
    got = span_readings.readings(stats)
    assert got["grads.device_lag_ms"] is None
    assert got["grads.enqueue_ms"] == pytest.approx(30.0)


def test_readings_of_a_traced_run():
    """tau * q traced CPU slots: every host reading is positive, the lag
    (device times) None, and the executor's own time is what the root
    span holds beyond its children."""
    stats = []
    _run(stats)
    got = span_readings.readings(stats)
    assert got["grads.device_lag_ms"] is None
    for name in READINGS:
        if name != "grads.device_lag_ms":
            assert got[name] > 0, name
    slots = [1e3 * (s["spans"][0]["host"][1] - s["spans"][0]["host"][0])
             for s in stats]
    assert got["harness.self_ms"] < sum(slots) / len(slots)
