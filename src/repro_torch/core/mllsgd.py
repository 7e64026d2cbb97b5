"""MLL-SGD configuration and network construction (counterpart of
`repro/core/mllsgd.py`).

Every parameter leaf carries a leading **worker axis** of size W; the
workers diverge between averaging rounds (paper Eq. 5).  The averaging
rounds are the mixing strategies of `repro_torch.core.protocol`
(``MLLConfig(mixing=...)``); the dense strategy is the paper's matrices:

  subnet step:  X <- X V   (v-weighted average within each sub-network)
  hub step:     X <- X Z,  Z_ij = H_{d(i),d(j)} v_i

Worker heterogeneity (Eq. 3) is a Bernoulli(p_i) gate drawn from the
counter-based generator keyed on (seed, step) (`protocol.gate_sample`).
The JAX package maps workers onto a TPU mesh (``granularity``); the port
shards the fleet over the ``workers`` axis of a process mesh
(`launch.mesh`, `launch.harness`) or runs it in one process, so only the
subnet layout matters here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.core.hierarchy import MLLSchedule, MultiLevelNetwork
# re-exported, as in the JAX package
from repro_torch.core.protocol import (  # noqa: F401
    MLLState, MLLTrainState, PHASE_HUB, PHASE_LOCAL, PHASE_SUBNET,
    gate_sample, gated_sgd_update, hub_average_dense, hub_average_int8,
    hub_average_int8_ef, hub_average_ppermute, hub_average_two_stage,
    init_error_feedback, phase_of, state_from_network, subnet_average_dense,
    subnet_average_two_stage)
from repro_torch.optim import optimizers as optim_mod

Tree = Any

GRANULARITIES = ("worker_per_data", "worker_per_chip", "worker_per_pod")


@dataclasses.dataclass(frozen=True)
class MLLConfig:
    """Hierarchy + schedule + protocol configuration (the JAX package's
    fields; ``inner_opt_args`` is a tuple of (key, value) pairs)."""
    tau: int = 8
    q: int = 4
    eta: float = 0.05
    granularity: str = "worker_per_data"    # one of GRANULARITIES
    hub_topology: str = "complete"          # topology over hubs
    worker_rates: tuple[float, ...] | float = 1.0   # p_i (scalar = uniform)
    worker_weights: tuple[float, ...] | None = None  # w_i (None = uniform)
    mixing: str = "dense"                   # protocol.available_mixing()
    mix_dtype: str | None = None            # e.g. "bfloat16"
    accum_dtype: str = "float32"            # microbatch accumulator dtype
    inner_opt: str = "sgd"                  # "sgd" | "momentum" | "adamw"
    inner_opt_args: tuple = ()              # ((key, value), ...)
    seed: int = 0

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}; "
                             f"expected one of {GRANULARITIES}")
        protocol.check_mixing(self.mixing)
        if self.inner_opt not in optim_mod.OPTIMIZERS:
            raise ValueError(f"unknown inner_opt {self.inner_opt!r}; "
                             f"known: {tuple(sorted(optim_mod.OPTIMIZERS))}")

    @property
    def schedule(self) -> MLLSchedule:
        return MLLSchedule(tau=self.tau, q=self.q)

    def mixing_strategy(self) -> protocol.MixingStrategy:
        return protocol.resolve_mixing(self)

    def inner_optimizer(self) -> optim_mod.Optimizer:
        return protocol.resolve_inner_optimizer(self)


def build_network(cfg: MLLConfig, n_pods: int, data_size: int,
                  model_size: int = 1) -> MultiLevelNetwork:
    """The paper's two-level network: ``n_pods`` sub-networks whose worker
    count follows ``cfg.granularity`` as in the JAX package."""
    if cfg.granularity == "worker_per_data":
        per_subnet = [data_size] * n_pods
    elif cfg.granularity == "worker_per_chip":
        per_subnet = [data_size * model_size] * n_pods
    else:
        per_subnet = [1] * n_pods
    n = sum(per_subnet)
    rates = cfg.worker_rates
    rates = [float(rates)] * n if np.isscalar(rates) else list(rates)
    if len(rates) != n:
        raise ValueError(f"need {n} worker rates, got {len(rates)}")
    weights = None if cfg.worker_weights is None else list(cfg.worker_weights)
    return MultiLevelNetwork.build(
        cfg.hub_topology, per_subnet, worker_rates=rates,
        worker_weights=weights, seed=cfg.seed)


def build_state(cfg: MLLConfig, network: MultiLevelNetwork,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> MLLState:
    """Operator bundle on ``device`` (default ``cuda``)."""
    if len(set(network.workers_per_subnet)) != 1:
        raise ValueError("production path assumes equal-size sub-networks")
    return state_from_network(network, dtype=dtype, device=device)


def apply_schedule(stacked: Tree, step: int, cfg: MLLConfig, st: MLLState,
                   *, static_phase: int | None = None) -> Tree:
    """Apply T_k for this step through the registered mixing strategy (in
    place)."""
    strategy = cfg.mixing_strategy()
    out, _ = protocol.schedule_mix(strategy, stacked,
                                   strategy.init_state(stacked), step, st,
                                   cfg.tau, cfg.q, static_phase=static_phase)
    return out


def mll_train_step(stacked_params: Tree, grads: Tree, step: int,
                   cfg: MLLConfig, st: MLLState, *,
                   static_phase: int | None = None) -> Tree:
    """One MLL-SGD tick with the paper's plain SGD inner update; ``step`` is
    the 1-based global tick.  Updates ``stacked_params`` in place."""
    theta = gate_sample(cfg.seed, step, st.rates)
    stacked = gated_sgd_update(stacked_params, grads, theta, cfg.eta)
    return apply_schedule(stacked, step, cfg, st, static_phase=static_phase)
