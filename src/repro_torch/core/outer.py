"""Beyond-paper extension: hub-level OUTER optimizer, DiLoCo-style
(counterpart of `repro/core/outer.py`).

The paper's hub step replaces each hub model by the H-weighted average of
its neighbours (Eq. 4).  Here the hubs instead treat the change since the
last hub round as an *outer gradient* and apply Nesterov momentum to it:

    avg_k    = Z-average of the worker models          (the paper's y)
    delta_k  = anchor_{k-1} - avg_k                     (outer gradient)
    m_k      = beta * m_{k-1} + delta_k
    anchor_k = anchor_{k-1} - lr_out * (delta_k + beta * m_k)   (Nesterov)
    workers  <- anchor_k                                (restart point)

With lr_out = 1 and beta = 0 this reduces to the paper's hub step
(anchor_k = avg_k).  The Z-average comes from the mixing-strategy registry
(`repro_torch.core.protocol`), so the outer step composes with every
registered strategy, the compression ladder included: pass ``cfg`` to
`init_outer_state` so the outer state carries a stateful strategy's state
(e.g. int8_ef residuals) under ``"mixing"``.  As in the protocol engine,
the stacked params are updated in place (here: replaced by the anchor);
the anchor and momentum are tensors of their own.

Reference: Douillard et al., "DiLoCo: Distributed Low-Communication
Training of Language Models" (arXiv:2311.08105), adapted to the MLL-SGD
two-level schedule and weighted Z operator.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.mllsgd import MLLConfig, MLLState
from repro_torch.core.protocol import (PHASE_LOCAL, PHASE_SUBNET, gate_sample,
                                       gated_sgd_update, phase_of,
                                       resolve_mixing)
from repro_torch.tree import tree_leaves, tree_map, tree_structure, \
    tree_unflatten

Tree = Any


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    lr: float = 0.7
    beta: float = 0.9


def init_outer_state(stacked_params: Tree,
                     cfg: MLLConfig | None = None) -> Tree:
    """anchor = a copy of the current params; momentum = 0.  ``cfg`` also
    carries the mixing strategy's state under ``"mixing"``.

    Contract: call on a subnet-consistent state (normally the replicated
    init); the hub step then keeps anchors identical within each
    sub-network for the whole run."""
    return {
        "anchor": tree_map(torch.clone, stacked_params),
        "momentum": tree_map(torch.zeros_like, stacked_params),
        "mixing": (resolve_mixing(cfg).init_state(stacked_params)
                   if cfg is not None else ()),
    }


@torch.no_grad()
def outer_hub_step(stacked: Tree, outer: Tree, cfg: MLLConfig,
                   st: MLLState, ocfg: OuterConfig) -> tuple[Tree, Tree]:
    """The hub-phase update: Z-average (any registered mixing strategy),
    then Nesterov on the outer delta; the workers restart from the new anchor
    (written into ``stacked`` in place)."""
    strategy = resolve_mixing(cfg)
    mix_state = outer.get("mixing", ())
    empty_slot = isinstance(mix_state, tuple) and not mix_state
    if empty_slot and tree_leaves(strategy.init_state(stacked)):
        raise ValueError(
            f"mixing strategy {strategy.name!r} is stateful; build the outer "
            "state with init_outer_state(params, cfg) so its state (e.g. "
            "error-feedback residuals) is carried between hub rounds")
    avg, new_mix = strategy.hub_with_state(stacked, st, mix_state)
    if empty_slot:
        new_mix = mix_state

    new_anchor, new_mom = [], []
    for anchor, a, m in zip(tree_leaves(outer["anchor"]), tree_leaves(avg),
                            tree_leaves(outer["momentum"])):
        af = anchor.float()
        delta = af - a.float()
        m_new = ocfg.beta * m.float() + delta
        new_anchor.append((af - ocfg.lr * (delta + ocfg.beta * m_new))
                          .to(anchor.dtype))
        new_mom.append(m_new.to(m.dtype))
    for dst, src in zip(tree_leaves(stacked), new_anchor):
        dst.copy_(src)
    structure = tree_structure(outer["anchor"])
    new_outer = {"anchor": tree_unflatten(structure, new_anchor),
                 "momentum": tree_unflatten(structure, new_mom)}
    if "mixing" in outer:
        new_outer["mixing"] = new_mix
    return stacked, new_outer


def mll_outer_train_step(stacked: Tree, outer: Tree, grads: Tree, step: int,
                         cfg: MLLConfig, st: MLLState,
                         ocfg: OuterConfig) -> tuple[Tree, Tree]:
    """One MLL-SGD tick (1-based ``step``) with the outer optimizer on hub
    rounds: local and subnet phases follow the paper; hub phases run the
    Nesterov outer update instead of plain Z averaging.  ``stacked`` is
    updated in place."""
    strategy = resolve_mixing(cfg)
    theta = gate_sample(cfg.seed, step, st.rates)
    upd = gated_sgd_update(stacked, grads, theta, cfg.eta)
    ph = phase_of(step, cfg.tau, cfg.q)
    if ph == PHASE_LOCAL:
        return upd, dict(outer)
    if ph == PHASE_SUBNET:
        new_p, new_mix = strategy.subnet_with_state(upd, st,
                                                    outer.get("mixing", ()))
        o2 = dict(outer)
        if "mixing" in outer:
            o2["mixing"] = new_mix
        return new_p, o2
    return outer_hub_step(upd, outer, cfg, st, ocfg)
