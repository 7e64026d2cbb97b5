"""The system under test, built from a cell's files: the port's model
configuration, the MLL-SGD configuration, network, operator bundle and
readiness plan, and the production harness that executes the plan.

The configuration file names the port's registered architecture and what
it sets on it (``port``); `arch_config` then holds every published key
that ``port.fields`` maps against the configuration as it is run, so a
key that differs and is not listed under ``reduced`` stops the run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.mllsgd import MLLConfig, build_network, build_state
from repro_torch.core.timeline import get_policy
from repro_torch.launch.harness import TrainHarness


def arch_config(conf: dict):
    """The port's `ArchConfig` as the configuration file states it."""
    port = conf["port"]
    cfg = dataclasses.replace(get_config(port["arch"]), **port["set"])
    for key, field in port["fields"].items():
        if key in conf["reduced"]:
            continue
        want, got = conf[key], getattr(cfg, field)
        if want != got:
            raise SystemExit(f"{conf['name']}: published {key}={want!r} but "
                             f"the port runs {field}={got!r}, and "
                             f"'reduced' does not list {key}")
    return cfg


def mll_config(traffic: dict, seed: int) -> MLLConfig:
    net, proto, plan = traffic["network"], traffic["protocol"], \
        traffic["plan"]
    return MLLConfig(tau=plan["tau"], q=plan["q"], eta=proto["eta"],
                     hub_topology=net["topology"], mixing=proto["mixing"],
                     inner_opt=proto["inner_opt"],
                     worker_rates=tuple(net["rates"]), seed=mll_seed(seed))


def mll_seed(seed: int) -> int:
    """The gate's seed: the run's seed folded into 31 bits."""
    return int(seed) % (2 ** 31)


def network_and_state(mll: MLLConfig, traffic: dict, device):
    net = traffic["network"]
    network = build_network(
        dataclasses.replace(mll, granularity="worker_per_data"),
        net["subnets"], net["workers_per_subnet"])
    return network, build_state(mll, network, device=device)


def plan(network, mll: MLLConfig, traffic: dict, slots: int, seed: int):
    p = traffic["plan"]
    return get_policy(p["policy"]).plan(
        network, mll.schedule, slots, np.random.default_rng(seed),
        rate_model=p["rate_model"])


def harness(cfg, mll, st, the_plan, *, mesh=None) -> TrainHarness:
    return TrainHarness(cfg, mll, st, gate_mode=the_plan.gate_mode,
                        impl="flash", mesh=mesh)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
