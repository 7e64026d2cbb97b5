"""The traced run's instruments, all from the benchmark's side.

* Spans: a per-layer metric names (``SPANS``) the program functions it
  times, as ``"module:attribute.path"``; `Probe` wraps each one so that a
  call synchronises the card before and after and adds its seconds to the
  span's list (and, while the profiler runs, its wall-clock interval).
* Calls: a metric names (``CALLS``) a kernel wrapper whose arguments it
  needs; while the profiler runs, each call's tensor shapes, dtypes and
  keyword arguments are kept.
* The profiler (`profile`): ``torch.profiler`` over a short stretch of
  slots, host and device activity both (on the H100 machines tracing the
  device alone cost ~380 us a launch against ~15 us with the host
  traced too, 9–12 us untraced; PERF.md), reduced to the device's busy
  seconds, the time of each device operation by name, the device
  operations inside each span, and the longest idle gaps labelled by the
  span the host was in (the trace's clock is the wall clock from its
  start, ``trace_start_ns``).

A target that no longer resolves (a function renamed by a later change)
is listed in ``missing``; the metrics that need it then read null.
"""
from __future__ import annotations

import collections
import functools
import importlib
import re
import time

import numpy as np
import torch


def _resolve(target: str):
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    getattr(owner, parts[-1])          # raises AttributeError when gone
    return owner, parts[-1]


def _describe(x):
    if isinstance(x, torch.Tensor):
        return {"shape": tuple(x.shape), "dtype": str(x.dtype).split(".")[-1],
                "numel": x.numel()}
    if isinstance(x, (int, float, bool, str)) or x is None:
        return x
    return None


class Probe:
    def __init__(self, readers, device):
        self.device = torch.device(device)
        self.spans: dict[str, list[float]] = collections.defaultdict(list)
        self.intervals: list[tuple[str, int, int]] = []
        self.calls: dict[str, list[dict]] = collections.defaultdict(list)
        self.recording = False
        self.missing: list[str] = []
        self._patched: list[tuple] = []
        self._span_targets: dict[str, list[str]] = {}
        self._call_targets: dict[str, str] = {}
        for r in readers:
            for name, targets in getattr(r, "SPANS", {}).items():
                self._span_targets.setdefault(name, list(targets))
            for name, target in getattr(r, "CALLS", {}).items():
                self._call_targets.setdefault(name, target)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap_span(self, name, fn):
        probe = self

        @functools.wraps(fn)
        def span(*args, **kwargs):
            probe._sync()
            t0, w0 = time.perf_counter(), time.time_ns()
            out = fn(*args, **kwargs)
            probe._sync()
            probe.spans[name].append(time.perf_counter() - t0)
            if probe.recording:
                probe.intervals.append((name, w0, time.time_ns()))
            return out
        return span

    def _wrap_call(self, name, fn):
        probe = self

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if probe.recording:
                probe.calls[name].append(
                    {"args": [_describe(a) for a in args],
                     "kwargs": {k: _describe(v) for k, v in kwargs.items()}})
            return fn(*args, **kwargs)
        return call

    def install(self) -> "Probe":
        jobs = [(t, n, self._wrap_span) for n, ts in self._span_targets.items()
                for t in ts]
        jobs += [(t, n, self._wrap_call)
                 for n, t in self._call_targets.items()]
        for target, name, wrap in jobs:
            try:
                owner, attr = _resolve(target)
            except (ImportError, AttributeError):
                self.missing.append(target)
                continue
            old = owner.__dict__.get(attr, getattr(owner, attr))
            self._patched.append((owner, attr, old))
            setattr(owner, attr, wrap(name, getattr(owner, attr)))
        return self

    def uninstall(self) -> None:
        for owner, attr, old in reversed(self._patched):
            setattr(owner, attr, old)
        self._patched.clear()


def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)[:64]


def profile(fn, probe: Probe) -> dict:
    """Run ``fn()`` under ``torch.profiler`` with the probe's records on;
    -> {"window_s", "busy_s", "ops": {device operation: seconds},
    "ops_in_span": {span: device operations started inside it},
    "span_calls": {span: calls}, "calls": {...}, "gaps": [[label,
    seconds]] (the ten longest)}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if probe.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = {k: len(v) for k, v in probe.spans.items()}
    probe.calls.clear()
    probe.intervals.clear()
    probe._sync()
    t0 = time.perf_counter()
    probe.recording = True
    with torch_profile(activities=acts) as prof:
        fn()
        probe._sync()
        window_s = time.perf_counter() - t0     # before the trace is read
    probe.recording = False
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kind = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == kind)
    ops = collections.defaultdict(float)
    for a, b, name in dev:
        ops[name] += (b - a) / 1e6
    busy, gaps = 0.0, []
    if dev:
        end = dev[0][1]
        busy = dev[0][1] - dev[0][0]
        for a, b, _ in dev[1:]:
            if a > end:
                gaps.append((a - end, end, a))
                busy += b - a
            elif b > end:
                busy += b - end
            end = max(end, b)
        busy /= 1e6
    gaps.sort(reverse=True)
    spans = [(n, (a - start_ns) / 1e3, (b - start_ns) / 1e3)
             for n, a, b in probe.intervals]           # trace microseconds

    def host_at(t):
        inside = [(a, n) for n, a, b in spans if a <= t <= b]
        return max(inside)[1] if inside else "between_spans"

    d_start = np.array([a for a, _, _ in dev], dtype=np.float64)
    in_span = collections.Counter()
    for name, a, b in spans:
        in_span[name] += int(((d_start >= a) & (d_start <= b)).sum())
    return {"window_s": window_s, "busy_s": busy, "ops": dict(ops),
            "ops_in_span": dict(in_span),
            "span_calls": {k: len(v) - before.get(k, 0)
                           for k, v in probe.spans.items()},
            "calls": {k: list(v) for k, v in probe.calls.items()},
            "gaps": [[host_at((a + b) / 2), g / 1e6]
                     for g, a, b in gaps[:10]]}


def breakdown(prof: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten longest idle gaps."""
    top = sorted(prof["ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[_label(n), s] for n, s in top],
            "idle_gaps": [list(g) for g in prof["gaps"]]}
