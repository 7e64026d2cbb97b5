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
(forward K3, backward K4; `repro_torch.kernels.ops.flash_attention`), and
so does the sLSTM recurrence (forward K7, backward K8;
`repro_torch.kernels.ops.slstm_scan`).  ``microbatch > 1`` accumulates
each worker's gradient over that many chunks of its batch.  ``remat``
("none" | "full" | "dots", the JAX package's choices) rematerialises each
super-block in the backward (`models.transformer.stack_train`): the same
gradients, bit for bit, for less activation memory.

`mll_transformer_step` is the stateless tick (plain gated SGD + the mixing
strategy with fresh state), `mll_transformer_state_step` carries a full
`MLLTrainState`, and `mll_harness_step` is the plan-driven slot the
production harness runs, on one device or, on a mesh, on one rank's rows
of the fleet.  No collective crosses the worker axis in a local slot:
that is the paper's communication saving.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import protocol
from repro_torch.core.mllsgd import MLLConfig, MLLState, mll_train_step
from repro_torch.core.protocol import MLLTrainState, protocol_step
from repro_torch.core.timeline import (apply_event_operator,
                                       chunked_apply_operator)
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
            impl: str = "flash", remat: str = "none"
            ) -> tuple[torch.Tensor, dict]:
    logits, aux = model_mod.forward_train(params, batch, cfg, impl=impl,
                                          remat=remat)
    if cfg.input_mode == "tokens+patches":
        # patches are prepended: only text positions carry labels
        logits = logits[:, cfg.num_patches:]
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def _worker(tree: Tree, i: int) -> Tree:
    return tree_map(lambda x: x[i], tree)


def _chunks(wbatch: dict, k: int) -> list[dict]:
    """One worker's batch as ``k`` gradient-accumulation chunks of equal
    size, in order (``positions`` carries a leading streams dim: its batch
    is axis 1)."""
    def cut(name, x, j):
        axis = 1 if name == "positions" else 0
        n = x.shape[axis] // k
        return x.narrow(axis, j * n, n)
    return [{name: cut(name, x, j) for name, x in wbatch.items()}
            for j in range(k)]


def per_worker_grads(params: Tree, batch: dict, cfg: ArchConfig, *,
                     impl: str = "flash", remat: str = "none",
                     microbatch: int = 1,
                     accum_dtype: str = "float32") -> tuple[Tree, dict]:
    """value_and_grad per worker over the leading worker axis of params and
    batch.  -> (stacked grads, {"loss", "ce", "aux"} each (W,) float32).

    ``microbatch`` > 1 splits each worker's batch into that many chunks and
    accumulates their gradients in ``accum_dtype`` (the JAX package's
    ``lax.scan``: zeros, + each chunk's gradient in order, times
    1/microbatch; loss, ce and aux averaged alike); the grads are then in
    ``accum_dtype``, else in the params' dtypes."""
    if microbatch > 1:
        b = batch["labels"].shape[1]
        if b % microbatch:
            raise ValueError(f"batch {b} not divisible by microbatch "
                             f"{microbatch}")
        acc = getattr(torch, accum_dtype)
        grads = tree_map(lambda p: torch.empty(p.shape, dtype=acc,
                                               device=p.device), params)
    else:
        grads = tree_map(torch.empty_like, params)
    w = tree_leaves(params)[0].shape[0]
    rows = []
    for i in range(w):
        wp = tree_map(lambda x: x[i].detach().requires_grad_(), params)
        chunks = (_chunks(_worker(batch, i), microbatch) if microbatch > 1
                  else [_worker(batch, i)])
        total = None
        for j, chunk in enumerate(chunks):
            loss, m = loss_fn(wp, chunk, cfg, impl=impl, remat=remat)
            # a leaf the loss does not read (the token table of a model fed
            # frame embeddings) gets a zero gradient, as under jax.grad
            g = torch.autograd.grad(loss, tree_leaves(wp), allow_unused=True,
                                    materialize_grads=True)
            with torch.no_grad():
                for dst, src in zip(tree_leaves(_worker(grads, i)), g):
                    if microbatch == 1:
                        dst.copy_(src)
                    elif j == 0:
                        dst.copy_(src.to(dst.dtype))
                    else:
                        dst.add_(src.to(dst.dtype))
            row = torch.stack([loss.detach(), m["ce"].detach(),
                               m["aux"].detach()]).float()
            total = row if total is None else total + row
        rows.append(total)
    table = torch.stack(rows)
    if microbatch > 1:
        inv = 1.0 / microbatch
        with torch.no_grad():
            for x in tree_leaves(grads):
                x.mul_(inv)
        table = table * inv
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


def mll_transformer_step(stacked_params: Tree, batch: dict, step: int,
                         cfg: ArchConfig, mll: MLLConfig, st: MLLState, *,
                         impl: str = "flash", remat: str = "none",
                         microbatch: int = 1,
                         static_phase: int | None = None,
                         spmd: protocol.SpmdAxis | None = None
                         ) -> tuple[Tree, dict]:
    """One production MLL-SGD tick over the whole fleet, stateless: plain
    gated SGD, then the mixing strategy with fresh per-round state
    (`core.mllsgd.mll_train_step`).  ``step`` is the 1-based tick; the
    params are updated in place.

    With ``spmd`` (the JAX package's ``spmd_axis_name``) the params and
    batch are this rank's rows of the fleet: the gate is drawn at full
    width and sliced, and the slot's mixing round lowers to the
    strategy's collectives (``subnet_spmd`` / ``hub_spmd``).  The phase is
    ``static_phase``, or the schedule's at ``step``."""
    grads, metrics = per_worker_grads(stacked_params, batch, cfg, impl=impl,
                                      remat=remat, microbatch=microbatch,
                                      accum_dtype=mll.accum_dtype)
    if spmd is None or spmd.size == 1:
        stacked = mll_train_step(stacked_params, grads, step, mll, st,
                                 static_phase=static_phase)
        return stacked, metrics
    lo = spmd.offset()
    theta = protocol.gate_sample(mll.seed, step, st.rates)
    stacked = protocol.gated_sgd_update(
        stacked_params, grads, theta[lo:lo + spmd.per_shard], mll.eta)
    del grads
    phase = (protocol.phase_of(step, mll.tau, mll.q) if static_phase is None
             else static_phase)
    if phase != protocol.PHASE_LOCAL:
        strategy = protocol.resolve_mixing(mll)
        fn = (strategy.hub_spmd if phase == protocol.PHASE_HUB
              else strategy.subnet_spmd)
        stacked = fn(stacked, st, spmd)
    return stacked, metrics


def mll_transformer_state_step(train_state: MLLTrainState, batch: dict,
                               cfg: ArchConfig, mll: MLLConfig, st: MLLState,
                               *, impl: str = "flash", remat: str = "none",
                               microbatch: int = 1,
                               static_phase: int | None = None
                               ) -> tuple[MLLTrainState, dict]:
    """One production protocol tick carrying a full `MLLTrainState`: the
    inner optimizer's per-worker state and the mixing state thread through
    (`core.protocol.protocol_step`); the tick lives in
    ``train_state.step``."""
    grads, metrics = per_worker_grads(train_state.params, batch, cfg,
                                      impl=impl, remat=remat,
                                      microbatch=microbatch,
                                      accum_dtype=mll.accum_dtype)
    return protocol_step(train_state, grads, mll, st,
                         static_phase=static_phase), metrics


def mll_harness_step(train_state: MLLTrainState, batch: dict,
                     active, cfg: ArchConfig, mll: MLLConfig,
                     st: MLLState, *, gate_mode: str = "bernoulli",
                     phase: int = protocol.PHASE_LOCAL,
                     op: torch.Tensor | None = None,
                     compute_grads: bool = True, impl: str = "flash",
                     remat: str = "none", microbatch: int = 1,
                     spmd: protocol.SpmdAxis | None = None,
                     overlap: str = "none",
                     overlap_chunks: int = 4) -> tuple[MLLTrainState, dict]:
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
      * ``overlap="chunked"`` replaces the mixing contraction (only: the
        inner update stays per leaf) with `timeline.chunked_apply_operator`
        in place: the dense (W, W) operator (``op``, or st.v_op / st.z_op
        for a subnet / hub phase) over the packed columns one chunk at a
        time.  Packed per-chunk products and the dense form of the
        structured strategies are the JAX package's documented
        reduction-order change: equal to ``overlap="none"`` to float32
        tolerance, not bit for bit.
      * On a mesh (``spmd`` of more than one shard) the step sees only this
        rank's (W/size, ...) rows of state, batch and ``active``.  The
        Bernoulli gate is drawn at FULL width and then sliced (the
        counter-based draw depends on the shape), so every layout gates as
        the single-device path does; mixing events lower to the strategy's
        collectives (``*_spmd_with_state``, `timeline.apply_event_operator`
        with ``spmd``), and a local slot makes none.

    The params and optimizer state of ``train_state`` are updated in place
    (`core.protocol`); the returned state holds the same tensors."""
    if gate_mode not in ("bernoulli", "forced"):
        raise ValueError(f"unknown gate_mode {gate_mode!r}")
    if overlap not in ("none", "chunked"):
        raise ValueError(f"unknown overlap {overlap!r}; "
                         "expected none|chunked")
    step = int(train_state.step) + 1
    sharded = spmd is not None and spmd.size > 1
    params, opt_state = train_state.params, train_state.opt_state
    if compute_grads:
        grads, metrics = per_worker_grads(params, batch, cfg, impl=impl,
                                          remat=remat, microbatch=microbatch,
                                          accum_dtype=mll.accum_dtype)
        act = torch.as_tensor(np.asarray(active), dtype=st.rates.dtype)
        if gate_mode == "bernoulli":
            theta = protocol.gate_sample(mll.seed, step, st.rates)
            if sharded:
                theta = theta[spmd.offset():spmd.offset() + spmd.per_shard]
            theta = theta * act
        else:
            theta = act
        params, opt_state = protocol.gated_inner_update(
            protocol.resolve_inner_optimizer(mll), params, opt_state, grads,
            theta)
        del grads
    else:
        metrics = per_worker_losses(params, batch, cfg, impl=impl)
    mix_state = train_state.mix_state
    chunked = overlap == "chunked"
    if op is not None:
        params = (chunked_apply_operator(params, op, overlap_chunks,
                                         out=params) if chunked
                  else apply_event_operator(params, op, spmd=spmd))
    elif chunked and phase != protocol.PHASE_LOCAL:
        op_mat = st.v_op if phase == protocol.PHASE_SUBNET else st.z_op
        params = chunked_apply_operator(params, op_mat, overlap_chunks,
                                        out=params)
    elif phase != protocol.PHASE_LOCAL:
        strategy = protocol.resolve_mixing(mll)
        hub = phase == protocol.PHASE_HUB
        if sharded:
            fn = (strategy.hub_spmd_with_state if hub
                  else strategy.subnet_spmd_with_state)
            params, mix_state = fn(params, st, mix_state, spmd)
        else:
            fn = strategy.hub_with_state if hub else strategy.subnet_with_state
            params, mix_state = fn(params, st, mix_state)
    return MLLTrainState(params, opt_state, mix_state,
                         torch.tensor(step, dtype=torch.int32)), metrics

