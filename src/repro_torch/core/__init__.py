"""MLL-SGD core (counterpart of `repro/core/`): the two-level network,
the protocol engine, the timeline plans and the stacked-worker helpers."""
