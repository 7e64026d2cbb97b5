"""Tree optimizers (counterpart of `repro/optim/`)."""
