"""Paper baselines expressed as MLL-SGD configurations (Section 6;
counterpart of `repro/core/baselines.py`).

Distributed SGD : one hub, q = tau = 1, a_i = 1/N, p_i = 1
Local SGD       : fully-connected hub graph treated as one subnet,
                  q = 1, p_i = 1, averaging every tau
HL-SGD          : hub-and-spoke hub network (star), homogeneous workers,
                  q > 1 allowed; workers synchronous (p_i = 1)
MLL-SGD         : the general algorithm

Every baseline runs through the same code path (Algorithm 1); the functions
below build the corresponding MultiLevelNetwork / schedule so experiments
and tests cannot drift from the paper's definitions.  `protocol_config`
expresses the same four as `MLLConfig` points of the protocol engine.  The
wall-clock baselines (`async_local_sgd`, `gossip_sgd`) also name a timeline
readiness policy, returning (network, schedule, policy) triples for
`timeline.run_timeline`.
"""
from __future__ import annotations

from repro_torch.core.hierarchy import MLLSchedule, MultiLevelNetwork
from repro_torch.core.mllsgd import MLLConfig


def distributed_sgd(num_workers: int) -> tuple[MultiLevelNetwork, MLLSchedule]:
    net = MultiLevelNetwork.build("complete", [num_workers])
    return net, MLLSchedule(tau=1, q=1)


def local_sgd(num_workers: int, tau: int = 32) -> tuple[MultiLevelNetwork, MLLSchedule]:
    net = MultiLevelNetwork.build("complete", [num_workers])
    return net, MLLSchedule(tau=tau, q=1)


def hl_sgd(workers_per_subnet: list[int], tau: int = 8, q: int = 4,
           ) -> tuple[MultiLevelNetwork, MLLSchedule]:
    # hierarchical local SGD: a star hub graph (hub 0 = the global server)
    # and homogeneous workers
    net = MultiLevelNetwork.build("star", workers_per_subnet)
    return net, MLLSchedule(tau=tau, q=q)


def mll_sgd(topology: str, workers_per_subnet: list[int], tau: int, q: int,
            worker_rates=None, worker_weights=None, seed: int = 0,
            ) -> tuple[MultiLevelNetwork, MLLSchedule]:
    net = MultiLevelNetwork.build(topology, workers_per_subnet,
                                  worker_rates=worker_rates,
                                  worker_weights=worker_weights, seed=seed)
    return net, MLLSchedule(tau=tau, q=q)


def async_local_sgd(num_workers: int, tau: int = 32, worker_rates=None,
                    ) -> tuple[MultiLevelNetwork, MLLSchedule, str]:
    """Local SGD without the barrier: one fully-connected sub-network whose
    averaging fires at fixed wall-clock deadlines (every tau slots); run
    via ``run_timeline(..., policy="deadline")``."""
    net = MultiLevelNetwork.build("complete", [num_workers],
                                  worker_rates=worker_rates)
    return net, MLLSchedule(tau=tau, q=1), "deadline"


def gossip_sgd(num_workers: int, tau: int = 32, topology: str = "ring",
               worker_rates=None,
               ) -> tuple[MultiLevelNetwork, MLLSchedule, str]:
    """Asynchronous gossip SGD: every worker is its own single-worker
    sub-network on a hub graph and averages with whichever neighbours are
    also ready after tau local steps; run via
    ``run_timeline(..., policy="gossip")``."""
    net = MultiLevelNetwork.build(topology, [1] * num_workers,
                                  worker_rates=worker_rates)
    return net, MLLSchedule(tau=tau, q=1), "gossip"


def protocol_config(name: str, *, tau: int = 8, q: int = 4,
                    eta: float = 0.05, worker_rates=1.0,
                    **overrides) -> MLLConfig:
    """The paper's baselines as protocol-engine config points; keyword
    overrides (mixing, inner_opt, mix_dtype, ...) pass straight through to
    `MLLConfig`."""
    presets = {
        # one big subnet, average every tick, synchronous workers
        "distributed_sgd": dict(tau=1, q=1, hub_topology="complete",
                                worker_rates=1.0),
        # single-level: averaging every tau, no separate hub cadence
        "local_sgd": dict(tau=tau, q=1, hub_topology="complete",
                          worker_rates=1.0),
        # hub-and-spoke global server, homogeneous workers
        "hl_sgd": dict(tau=tau, q=q, hub_topology="star", worker_rates=1.0),
        # the general algorithm: heterogeneous rates allowed
        "mll_sgd": dict(tau=tau, q=q, hub_topology="complete",
                        worker_rates=worker_rates),
    }
    if name not in presets:
        raise ValueError(f"unknown baseline {name!r}; "
                         f"expected one of {tuple(presets)}")
    return MLLConfig(eta=eta, **{**presets[name], **overrides})
