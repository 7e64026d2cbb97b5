"""The production trainer: the plan-driven harness and its CLI
(counterpart of `repro/launch/`, single device)."""
