"""Loss, per-worker gradients, the plan-driven protocol slot and
checkpoints (counterpart of `repro/train/`)."""
