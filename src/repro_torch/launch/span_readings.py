"""What a traced run's spans say about which side sets the pace.

``readings(slot_stats)`` reduces the ``spans`` of `TrainHarness`
``slot_stats`` entries (`launch.spans`) to five means, in milliseconds:

  * ``harness.self_ms``: per slot, the root span ``slot`` less the host
    time of its children (``grads``, ``update``, ``mix``): the executor's
    own time, which holds the batch draw and its copy to the card, the
    gate draw, the bookkeeping and any synchronise a caller wraps around
    those children;
  * ``grads.enqueue_ms``: the host time of ``grads`` over its worker rows
    (its ``grad_copy`` children): a worker-step's enqueue;
  * ``grads.device_lag_ms``: per worker row, ``grad_copy``'s device end
    less its host end: the queued work the card still holds when the host
    has finished enqueuing a worker-step (near 0 where the host paces the
    card, tens of ms where the card paces);
  * ``protocol.update_enqueue_ms``: the host time of ``update`` per slot;
  * ``protocol.mix_enqueue_ms``: the host time of ``mix`` per event.

A reading is None where no span feeds it: slots recorded without spans,
or, for the lag, spans without device times (the CPU).
"""
from __future__ import annotations


def _host(s: dict) -> float:
    return s["host"][1] - s["host"][0]


def _mean_ms(xs: list) -> float | None:
    return 1e3 * sum(xs) / len(xs) if xs else None


def readings(slot_stats: list[dict]) -> dict[str, float | None]:
    own, enqueue, lag, update, mix = [], [], [], [], []
    for slot in slot_stats:
        tree = slot.get("spans") or []
        for i, s in enumerate(tree):
            kids = [k for k in tree if k["parent"] == i]
            if s["name"] == "slot":
                own.append(_host(s) - sum(_host(k) for k in kids))
            elif s["name"] == "grads":
                rows = sum(k["name"] == "grad_copy" for k in kids)
                enqueue += [_host(s) / rows] * rows if rows else []
            elif s["name"] == "grad_copy" and s["device"] is not None:
                lag.append(s["device"][1] - s["host"][1])
            elif s["name"] == "update":
                update.append(_host(s))
            elif s["name"] == "mix":
                mix.append(_host(s))
    return {"harness.self_ms": _mean_ms(own),
            "grads.enqueue_ms": _mean_ms(enqueue),
            "grads.device_lag_ms": _mean_ms(lag),
            "protocol.update_enqueue_ms": _mean_ms(update),
            "protocol.mix_enqueue_ms": _mean_ms(mix)}
