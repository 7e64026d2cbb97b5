"""Loss, per-worker gradients and the plan-driven protocol slot (counterpart
of `repro/train/train_step.py`).

One production MLL-SGD slot is:

  1. each worker computes grads on its own minibatch -- a loop over the
     worker axis with plain autograd, one worker at a time (JAX's ``vmap``
     cannot see into a hand-written kernel; the arithmetic per worker is
     the same, and the loop bounds the activation memory to one worker),
  2. the Bernoulli-gated inner-optimizer update (paper Eq. 2-3),
  3. the averaging event of the slot through the mixing strategy, or a
     composed dense (W, W) operator for partial-participation policies.

With ``impl="flash"`` attention trains through the hand-written kernels
(forward K3, backward K4; `repro_torch.kernels.ops.flash_attention`).
``microbatch > 1`` (gradient accumulation) is not ported yet (ROADMAP.md
Queue 1).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import protocol
from repro_torch.core.mllsgd import MLLConfig, MLLState
from repro_torch.core.protocol import MLLTrainState
from repro_torch.core.timeline import apply_event_operator
from repro_torch.models import model as model_mod
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over (optionally masked) positions, in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(params: Tree, batch: dict, cfg: ArchConfig, *,
            impl: str = "flash") -> tuple[torch.Tensor, dict]:
    logits, aux = model_mod.forward_train(params, batch, cfg, impl=impl)
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def _worker(tree: Tree, i: int) -> Tree:
    return tree_map(lambda x: x[i], tree)


def per_worker_grads(params: Tree, batch: dict, cfg: ArchConfig, *,
                     impl: str = "flash", microbatch: int = 1
                     ) -> tuple[Tree, dict]:
    """value_and_grad per worker over the leading worker axis of params and
    batch.  -> (stacked grads in the params' dtypes, {"loss", "ce", "aux"}
    each (W,) float32)."""
    if microbatch != 1:
        raise NotImplementedError(
            "microbatch > 1 (gradient accumulation) is not ported yet "
            "(ROADMAP.md Queue 1)")
    grads = tree_map(torch.empty_like, params)
    w = tree_leaves(params)[0].shape[0]
    rows = []
    for i in range(w):
        wp = tree_map(lambda x: x[i].detach().requires_grad_(), params)
        loss, m = loss_fn(wp, _worker(batch, i), cfg, impl=impl)
        g = torch.autograd.grad(loss, tree_leaves(wp))
        with torch.no_grad():
            for dst, src in zip(tree_leaves(_worker(grads, i)), g):
                dst.copy_(src)
        rows.append(torch.stack([loss.detach(), m["ce"].detach(),
                                 m["aux"].detach()]).float())
    table = torch.stack(rows)
    return grads, {"loss": table[:, 0], "ce": table[:, 1], "aux": table[:, 2]}


@torch.no_grad()
def per_worker_losses(params: Tree, batch: dict, cfg: ArchConfig, *,
                      impl: str = "flash") -> dict:
    """The per-worker loss metrics without a backward pass."""
    w = tree_leaves(params)[0].shape[0]
    rows = []
    for i in range(w):
        loss, m = loss_fn(_worker(params, i), _worker(batch, i), cfg,
                          impl=impl)
        rows.append(torch.stack([loss, m["ce"], m["aux"]]).float())
    table = torch.stack(rows)
    return {"loss": table[:, 0], "ce": table[:, 1], "aux": table[:, 2]}


def mll_harness_step(train_state: MLLTrainState, batch: dict,
                     active, cfg: ArchConfig, mll: MLLConfig,
                     st: MLLState, *, gate_mode: str = "bernoulli",
                     phase: int = protocol.PHASE_LOCAL,
                     op: torch.Tensor | None = None,
                     compute_grads: bool = True, impl: str = "flash",
                     microbatch: int = 1) -> tuple[MLLTrainState, dict]:
    """One PLAN-DRIVEN slot: the protocol tick with the gate and the mixing
    event decided host-side by a `core.timeline` readiness policy.

      * ``active`` is the plan's (W,) progress mask for the slot.  Under
        ``gate_mode="bernoulli"`` it multiplies the counter-based
        Bernoulli(p_i) draw of Eq. (3); under ``"forced"`` it IS the gate.
      * ``phase`` is the slot's mixing event (local slots mix nothing);
        partial-participation policies pass a composed dense (W, W)
        operator as ``op`` instead.
      * ``compute_grads=False`` is the all-idle event slot of a forced plan:
        the backward pass and the θ = 0 no-op update are skipped; only the
        per-worker losses (the metrics) and the mixing event run.

    The params and optimizer state of ``train_state`` are updated in place
    (`core.protocol`); the returned state holds the same tensors."""
    if gate_mode not in ("bernoulli", "forced"):
        raise ValueError(f"unknown gate_mode {gate_mode!r}")
    step = int(train_state.step) + 1
    params, opt_state = train_state.params, train_state.opt_state
    if compute_grads:
        grads, metrics = per_worker_grads(params, batch, cfg, impl=impl,
                                          microbatch=microbatch)
        act = torch.as_tensor(np.asarray(active), dtype=st.rates.dtype)
        theta = (protocol.gate_sample(mll.seed, step, st.rates) * act
                 if gate_mode == "bernoulli" else act)
        params, opt_state = protocol.gated_inner_update(
            protocol.resolve_inner_optimizer(mll), params, opt_state, grads,
            theta)
        del grads
    else:
        metrics = per_worker_losses(params, batch, cfg, impl=impl)
    mix_state = train_state.mix_state
    if op is not None:
        params = apply_event_operator(params, op)
    elif phase == protocol.PHASE_SUBNET:
        params, mix_state = protocol.resolve_mixing(mll).subnet_with_state(
            params, st, mix_state)
    elif phase == protocol.PHASE_HUB:
        params, mix_state = protocol.resolve_mixing(mll).hub_with_state(
            params, st, mix_state)
    return MLLTrainState(params, opt_state, mix_state,
                         torch.tensor(step, dtype=torch.int32)), metrics

