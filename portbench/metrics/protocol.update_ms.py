"""Milliseconds of the Bernoulli-gated inner update of a slot: a span
around `repro_torch.core.protocol.gated_inner_update` (synchronised), over
its calls in the window."""
UNIT = "ms"
SPANS = {"update": ["repro_torch.core.protocol:gated_inner_update"]}


def read(rec):
    s = rec["spans"].get("update", [])
    return 1e3 * sum(s) / len(s) if s else None
