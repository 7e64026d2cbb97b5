"""Faithful MLL-SGD simulator: Algorithm 1 via the matrix form
X' = (X - eta G) T_k (counterpart of `repro/core/simulator.py`).

All N worker replicas are carried as a stacked leading axis on every param
leaf; per-worker minibatch gradients are computed one worker at a time
with autograd, gradient gating theta_k^i ~ Bernoulli(p_i) follows Eq. (3),
and the scheduled averaging round is applied through the **protocol
engine** (`repro_torch.core.protocol`): the same mixing-strategy registry
and gated inner-optimizer update that drive the production trainer.  The
batch indices and gates are drawn with `repro_torch.core.prng`, bit for
bit the JAX package's ``jax.random`` draws, so a run follows the
reference's trajectory without injected randomness.

Config knobs (`SimConfig`, the JAX package's fields, so a config crosses
unchanged):

  * ``mixing``    -- any registered strategy ("dense" reproduces the
                     paper's X T_k matrix form exactly; unequal-size
                     sub-networks require "dense").
  * ``inner_opt`` -- any `repro_torch.optim.optimizers` optimizer;
                     per-worker state rides the carry and is frozen for
                     gated-off workers.
  * ``kernel``    -- ``"xla"`` (default): the unfused torch ops (gated
                     update, then the strategy's mix); ``"pallas"``: the
                     hand-written fused update + mix kernel
                     (``csrc/hier_mix.cu`` through
                     `repro_torch.kernels.ops`), its plain version on the
                     CPU.  The names are the JAX package's.  ``"pallas"``
                     requires inner_opt="sgd" and mix_dtype=None.
  * ``block_c``   -- the TPU kernel's lane-block size; kept so configs
                     cross unchanged, unused here (the CUDA kernel picks
                     its own column tile).

This module is the reference implementation behind the paper-figure
experiments.  The stacked tree is updated in place where the protocol
engine updates in place (`core.protocol`); `simulate` and
`timeline.run_timeline` replicate ``init_params`` first, so the caller's
tree is never touched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packing, prng, protocol
from repro_torch.core.hierarchy import MLLSchedule, MultiLevelNetwork
from repro_torch.optim import optimizers as optim_mod
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


# --------------------------------------------------------------------- params
def replicate(params: Tree, num_workers: int) -> Tree:
    """Stack identical replicas along a new leading worker axis.  Unlike
    JAX's ``broadcast_to`` these are real copies: the port updates the
    workers in place."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((num_workers,) + tuple(x.shape))
        .contiguous(), params)


def _device(stacked: Tree) -> torch.device:
    return tree_leaves(stacked)[0].device


def weighted_average(stacked: Tree, a: torch.Tensor) -> Tree:
    """u = X a (Eq. 8).  As in JAX, ``tensordot(a f32, x)`` promotes: u of
    a bf16 fleet is float32.  Where `packing.flat_paths_enabled` (on the
    card) all-f32 trees take the packed flat path: one (W,) x (W, C)
    contraction instead of one per leaf."""
    if packing.flat_paths_enabled(_device(stacked)) and \
            packing.all_f32(stacked):
        return packing.weighted_average_packed(stacked, a)

    def avg(x):
        dt = torch.promote_types(a.dtype, x.dtype)
        return torch.tensordot(a.to(x.device, dt), x.to(dt), dims=1)
    return tree_map(avg, stacked)


def apply_operator(stacked: Tree, t: torch.Tensor) -> Tree:
    """X <- X T for stacked leaves: new[j] = sum_i T[i, j] x_i (a new tree,
    promoted like JAX's einsum).  Where `packing.flat_paths_enabled` (on
    the card) all-f32 trees take the packed flat path: ONE (W, W) x (W, C)
    product replaces the per-leaf loop."""
    if packing.flat_paths_enabled(_device(stacked)) and \
            packing.all_f32(stacked):
        return packing.apply_operator_packed(stacked, t)

    def mix(x):
        dt = torch.promote_types(t.dtype, x.dtype)
        return torch.einsum("ij,i...->j...", t.to(x.device, dt), x.to(dt))
    return tree_map(mix, stacked)


# ------------------------------------------------------------------ simulator
@dataclasses.dataclass(frozen=True)
class SimConfig:
    eta: float = 0.05
    batch_size: int = 32
    eval_every: int = 32          # matches the paper: metrics every 32 iterations
    mixing: str = "dense"         # any registered mixing strategy
    mix_dtype: str | None = None
    inner_opt: str = "sgd"        # any repro_torch.optim.optimizers optimizer
    inner_opt_args: tuple = ()    # ((key, value), ...) extra kwargs
    kernel: str = "xla"           # "xla" (torch ops) | "pallas" (fused kernel)
    block_c: int = 512            # TPU lane-block size; unused by the port
    overlap: str = "none"         # "none" | "chunked": mix the packed buffer
                                  # chunk by chunk (event executor only)
    overlap_chunks: int = 4       # column chunks per mixing event


@dataclasses.dataclass
class SimResult:
    steps: np.ndarray             # eval step indices (1-based, inclusive)
    train_loss: np.ndarray        # F(u_k) on the full training set
    test_acc: np.ndarray
    final_avg_params: Tree


def _phase_ids(schedule: MLLSchedule, k0: int, num: int) -> np.ndarray:
    """Operator index (0=I, 1=V, 2=Z) for steps k0+1 .. k0+num (paper 1-based)."""
    ids = np.zeros(num, dtype=np.int32)
    for i in range(num):
        k = k0 + i + 1
        ph = schedule.phase(k)
        ids[i] = {"local": 0, "subnet": 1, "hub": 2}[ph]
    return ids


def _sim_optimizer(cfg: SimConfig) -> optim_mod.Optimizer:
    return protocol.resolve_inner_optimizer(cfg)


def _sim_strategy(cfg: SimConfig) -> protocol.MixingStrategy:
    return protocol.resolve_mixing(cfg)


def _check_kernel(cfg: SimConfig, *, structured_ok: bool = False) -> None:
    if cfg.kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {cfg.kernel!r}; expected xla|pallas")
    if cfg.kernel != "pallas":
        return
    mixings = ("dense", "two_stage", "ppermute") if structured_ok \
        else ("dense",)
    if (cfg.inner_opt != "sgd" or cfg.mixing not in mixings
            or cfg.mix_dtype is not None):
        raise ValueError(
            "kernel='pallas' fuses the plain-SGD update with the f32 "
            "operator contraction; it requires inner_opt='sgd', "
            f"mix_dtype=None, and mixing in {mixings} (the structured "
            "two_stage/ppermute fusions run through the event-sparse "
            "timeline executor only)")


def _check_overlap(cfg: SimConfig) -> None:
    """Validate the chunked-overlap knob (shared by every executor).

    ``overlap="chunked"`` fuses the plain-SGD update with a dense (W, W)
    operator contraction chunk by chunk over the PACKED buffer, so it
    carries the fused kernel's restrictions: inner_opt='sgd' (the fused
    u = x - eta*theta*g IS the update), mix_dtype=None, and a mixing
    strategy whose rounds are expressible as dense operators
    (dense/two_stage/ppermute)."""
    if cfg.overlap not in ("none", "chunked"):
        raise ValueError(f"unknown overlap {cfg.overlap!r}; "
                         "expected none|chunked")
    if cfg.overlap != "chunked":
        return
    if cfg.overlap_chunks < 1:
        raise ValueError(f"overlap_chunks must be >= 1, "
                         f"got {cfg.overlap_chunks}")
    if (cfg.inner_opt != "sgd" or cfg.mix_dtype is not None
            or cfg.mixing not in ("dense", "two_stage", "ppermute")):
        raise ValueError(
            "overlap='chunked' fuses the plain-SGD update with a dense "
            "(W, W) operator contraction per packed-lane chunk; it "
            "requires inner_opt='sgd', mix_dtype=None, and mixing in "
            "('dense', 'two_stage', 'ppermute')")


def make_step_fn(loss_fn: Callable[[Tree, Tree], torch.Tensor],
                 network: MultiLevelNetwork, cfg: SimConfig, *,
                 device: str | torch.device | None = None):
    """The lock-step slot loop over the protocol engine.

    loss_fn(params, batch) -> scalar tensor; batch is a tree whose leaves
    have a leading sample axis.  Per-worker data is a tree with leading
    axes (num_workers, samples_per_worker, ...).  The returned function is

      scan_steps(carry, data, op_ids) -> carry

    with ``carry = (stacked, opt_state, mix_state, key)`` (see
    `init_sim_carry`).  It is the timeline's full scan
    (`timeline.make_timeline_step_fn`) with an all-ones active mask: the
    lock-step simulator IS the slot clock where every slot is a tick for
    every worker.  ``device`` holds the mixing operators (default
    ``cuda``; pass ``device="cpu"`` without a GPU).
    """
    from repro_torch.core.timeline import make_timeline_step_fn
    n = network.num_workers
    scan_slots = make_timeline_step_fn(loss_fn, network, cfg,
                                       gate_mode="bernoulli", device=device)

    def scan_steps(carry, data, op_ids):
        ones = np.ones((len(op_ids), n), np.float32)
        return scan_slots(carry, data, op_ids, ones)

    return scan_steps


def init_sim_carry(stacked: Tree, cfg: SimConfig, seed: int = 0):
    """(params, gated inner-opt state, mixing state, PRNG key); the key is
    `prng.prng_key` (``jax.random.PRNGKey(seed)``'s two words)."""
    optimizer = _sim_optimizer(cfg)
    strategy = _sim_strategy(cfg)
    return (stacked, protocol.init_gated_opt_state(optimizer, stacked),
            strategy.init_state(stacked), prng.prng_key(seed))


def to_device(tree: Tree, device: torch.device) -> Tree:
    """Every tensor leaf of ``tree`` on ``device`` (numpy leaves become
    tensors)."""
    return tree_map(lambda x: torch.as_tensor(x).to(device), tree)


@torch.no_grad()
def evaluate(fn: Callable[[Tree, Tree], torch.Tensor], params: Tree,
             data: Tree) -> float:
    return float(fn(params, data))


def simulate(loss_fn: Callable[[Tree, Tree], torch.Tensor],
             accuracy_fn: Callable[[Tree, Tree], torch.Tensor],
             init_params: Tree,
             worker_data: Tree,
             eval_data: Tree,
             test_data: Tree,
             network: MultiLevelNetwork,
             schedule: MLLSchedule,
             *,
             steps: int,
             cfg: SimConfig = SimConfig(),
             seed: int = 0,
             device: str | torch.device | None = None) -> SimResult:
    """Run MLL-SGD for `steps` iterations; evaluate u_k every
    cfg.eval_every.  The params and data are moved to ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    n = network.num_workers
    a = torch.as_tensor(np.asarray(network.a), dtype=torch.float32,
                        device=device)
    worker_data, eval_data, test_data = (
        to_device(t, device) for t in (worker_data, eval_data, test_data))
    stacked = replicate(to_device(init_params, device), n)
    carry = init_sim_carry(stacked, cfg, seed)
    scan_steps = make_step_fn(loss_fn, network, cfg, device=device)

    rec_steps, rec_loss, rec_acc = [], [], []
    done = 0
    while done < steps:
        chunk = min(cfg.eval_every, steps - done)
        op_ids = _phase_ids(schedule, done, chunk)
        carry = scan_steps(carry, worker_data, op_ids)
        done += chunk
        u = weighted_average(carry[0], a)
        rec_steps.append(done)
        rec_loss.append(evaluate(loss_fn, u, eval_data))
        rec_acc.append(evaluate(accuracy_fn, u, test_data))
    u = weighted_average(carry[0], a)
    return SimResult(np.asarray(rec_steps), np.asarray(rec_loss),
                     np.asarray(rec_acc), u)
