"""The production trainer: the plan-driven harness and its CLI
and the process meshes it runs on (counterpart of `repro/launch/`)."""
