"""Milliseconds of a mixing event's averaging round: a span around the
strategy's round as `mll_harness_step` calls it
(`MixingStrategy.{subnet,hub}[_spmd]_with_state`, synchronised), over the
window's events."""
UNIT = "ms"
SPANS = {"mix": ["repro_torch.core.protocol:MixingStrategy.subnet_with_state",
                "repro_torch.core.protocol:MixingStrategy.hub_with_state",
                "repro_torch.core.protocol:MixingStrategy.subnet_spmd_with_state",
                "repro_torch.core.protocol:MixingStrategy.hub_spmd_with_state"]}


def read(rec):
    s = rec["spans"].get("mix", [])
    return 1e3 * sum(s) / len(s) if s else None
