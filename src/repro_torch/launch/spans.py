"""Spans of a traced training slot, on the host's clock and on the card's.

``with span(name):`` times the work inside the block.  While no slot is
traced and no profiler runs, `span` returns one shared null context: it
reads two module-level values (the active `Tracer` and
``torch.autograd.profiler._is_profiler_enabled``), allocates nothing and
reads no clock.

`launch.harness.TrainHarness` traces a slot exactly when its
``slot_stats`` is a list, with a `Tracer` it makes on its first traced
slot:

  * `Tracer.begin`, called right after a device synchronise, records an
    anchor event on the current stream, which the idle card passes as soon
    as it arrives, and reads the host clock;
  * each span reads `time.perf_counter_ns` and, on a card, records a
    `torch.cuda.Event` on the current stream when it opens and when it
    closes (no synchronise);
  * `Tracer.stop` turns tracing off; `Tracer.resolve`, called after the
    slot's closing synchronise, reads every event against the anchor and
    returns the events to the tracer's pool for the next slot.

An event E then lies on the host's clock at ``anchor_host +
anchor.elapsed_time(E)``.

While a ``torch.profiler`` run is active, each span also opens a
profiler range of its name, so it lies in the trace, on the trace's own
clock, linked to the device operations it launched.  The range is a
`RecordFunction` of the operator kind
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(`torch.profiler.record_function`): the profiler copies each user
annotation onto the device's timeline as an event of its own, which a
reading of the device's busy time or operation count takes for device
work.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler


_NULL = contextlib.nullcontext()
_active: Tracer | None = None        # the tracer of the slot being traced


def span(name: str):
    """A context manager timing its block as the span ``name``: the null
    context unless a slot is traced or a profiler runs."""
    tracer = _active
    if tracer is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, tracer)


class _Span:
    __slots__ = ("name", "tracer", "rec", "rf")

    def __init__(self, name: str, tracer: Tracer | None):
        self.name, self.tracer, self.rec, self.rf = name, tracer, None, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        if self.tracer is not None:
            self.rec = self.tracer.open(self.name)
        return None

    def __exit__(self, *exc):
        if self.tracer is not None:
            self.tracer.close(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """The spans of one traced slot at a time on ``device``, and the pool
    of timing events they reuse (made on a card only, as spans need
    them)."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.pool: list = []          # free events
        self.taken: list = []         # events recorded in this slot
        self.records: list = []       # [name, parent, host0, host1, ev0, ev1]
        self.stack: list = []         # indices of the open spans
        self.anchor = None
        self.host0 = 0

    def _event(self):
        ev = (self.pool.pop() if self.pool
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        self.taken.append(ev)
        return ev

    def begin(self) -> None:
        """Start tracing a slot; the device has just been synchronised."""
        global _active
        if _active is not None:
            raise RuntimeError("a slot is already being traced")
        self.pool += self.taken       # left by a slot that raised
        self.taken, self.records, self.stack = [], [], []
        self.anchor = self._event() if self.cuda else None
        self.host0 = time.perf_counter_ns()
        _active = self

    def stop(self) -> None:
        global _active
        if _active is self:
            _active = None

    def open(self, name: str) -> list:
        rec = [name, self.stack[-1] if self.stack else None,
               time.perf_counter_ns(), None,
               self._event() if self.cuda else None, None]
        self.stack.append(len(self.records))
        self.records.append(rec)
        return rec

    def close(self, rec: list) -> None:
        if self.cuda:
            rec[5] = self._event()
        rec[3] = time.perf_counter_ns()
        self.stack.pop()

    def resolve(self) -> list[dict]:
        """The slot's spans, in the order they opened: ``{"name",
        "parent"`` (the index of the enclosing span in this list, None for
        the root), ``"host": [start, end]``, ``"device": [start, end]}``
        (None off a card), in seconds from the anchor.  Call after the
        slot's closing device synchronise."""
        out = []
        for name, parent, h0, h1, e0, e1 in self.records:
            dev = (None if e0 is None else
                   [self.anchor.elapsed_time(e0) / 1e3,
                    self.anchor.elapsed_time(e1) / 1e3])
            out.append({"name": name, "parent": parent,
                        "host": [(h0 - self.host0) / 1e9,
                                 (h1 - self.host0) / 1e9],
                        "device": dev})
        self.pool += self.taken
        self.taken, self.records = [], []
        return out
