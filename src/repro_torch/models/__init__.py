"""The attention transformer: `layers`, `rope`, `attention`, `transformer`,
`model` (counterparts of the modules of `repro/models/` with those names)."""
