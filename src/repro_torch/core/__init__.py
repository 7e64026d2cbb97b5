"""MLL-SGD core (counterpart of `repro/core/`): the two-level network,
the protocol engine, packing, the simulator, the timeline plans and their
executors, the paper's baselines and the outer optimizer."""
from repro_torch.core.simulator import SimConfig, SimResult, simulate
from repro_torch.core.timeline import (EventExecutor, TimelineResult,
                                       run_timeline)

__all__ = ["EventExecutor", "SimConfig", "SimResult", "TimelineResult",
           "run_timeline", "simulate"]
