"""Protocol engine: the paper's algorithm family as (mixing x inner-opt x
schedule) -- counterpart of `repro/core/protocol.py`, single device.

Every execution path drives the same three pluggable pieces:

  1. a **MixingStrategy** from the registry below -- how the subnet (V) and
     hub (Z) averaging rounds are realised: ``dense`` (the paper's W x W
     matrices as einsums), ``two_stage`` (grouped subnet mean, then the
     D x D hub mix as weighted rolls) and ``ppermute`` (circulant-H hub mix
     as rolls with nonzero coefficients only),
  2. an **inner optimizer** (`repro_torch.optim.optimizers`) applied per
     worker under the Bernoulli(p_i) gate of Eq. (3) -- a gated worker
     skips the step entirely: params, optimizer state and step count stay
     frozen,
  3. the (tau, q) **schedule** choosing local / subnet / hub per tick.

The compression strategies of the JAX package (int8, int8_ef, int4_ef,
bf16, topk_ef, powersgd) and every ``*_spmd`` collective lowering are not
ported yet (ROADMAP.md Queue 1); asking for one raises
`NotImplementedError`.

Differences from the JAX package, by design:

* **In place.**  Mixing rounds and the gated inner update write their
  results into the stacked tensors they are given (under
  ``torch.no_grad()``) and return the same tree: at qwen3-1.7b width with
  W = 4 a functional update would hold a second 16 GB copy of the fleet.
  Each new value is computed exactly as the JAX expression computes it and
  then copied over the old one, so the arithmetic is unchanged.
* **Host-side gate.**  θ is drawn on the host with `repro_torch.core.prng`,
  bit for bit the reference's ``jax.random`` draw, and the gated update
  loops over the workers whose gate is on.  ``st.rates`` and
  ``MLLTrainState.step`` live on the CPU for that reason.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.optim import optimizers as optim_mod
from repro_torch.tree import tree_leaves, tree_map

Tree = Any

PHASE_LOCAL, PHASE_SUBNET, PHASE_HUB = 0, 1, 2
# registered in the JAX package, not ported yet
UNPORTED_MIXING = ("bf16", "int4_ef", "int8", "int8_ef", "powersgd",
                   "topk_ef")
_UNPORTED = ("is not ported yet (ROADMAP.md Queue 1, 'Compression ladder + "
             "chunked overlap'); the port has dense, two_stage and ppermute")


@dataclasses.dataclass(frozen=True)
class MLLState:
    """Operator bundle used inside train steps.  ``v_op``, ``z_op``,
    ``v_weights`` and ``h`` live on the params' device; ``rates`` on the
    CPU, where the gate is drawn.  ``workers_per_subnet`` is 0 when
    sub-networks have unequal sizes (dense mixing only)."""
    v_op: torch.Tensor           # (W, W)
    z_op: torch.Tensor           # (W, W)
    v_weights: torch.Tensor      # (W,) within-subnet weights
    h: torch.Tensor              # (D, D)
    rates: torch.Tensor          # (W,) on the CPU
    num_subnets: int
    workers_per_subnet: int


def state_from_network(network, dtype: torch.dtype = torch.float32,
                       device: str | torch.device | None = None) -> MLLState:
    """Operator bundle for any MultiLevelNetwork on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    nd = set(network.workers_per_subnet)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return MLLState(
        v_op=t(network.v_matrix()), z_op=t(network.z_matrix()),
        v_weights=t(network.v), h=t(network.hub_net.h),
        rates=torch.as_tensor(np.asarray(network.worker_rates), dtype=dtype),
        num_subnets=network.num_subnets,
        workers_per_subnet=int(next(iter(nd))) if len(nd) == 1 else 0)


# ----------------------------------------------------------------- primitives
def phase_of(step: int, tau: int, q: int) -> int:
    """Phase of 1-based step: 0 local / 1 subnet / 2 hub (Eq. 6)."""
    if step % (q * tau) == 0:
        return PHASE_HUB
    return PHASE_SUBNET if step % tau == 0 else PHASE_LOCAL


def gate_sample(seed: int, step: int, rates: torch.Tensor) -> torch.Tensor:
    """theta_k ~ Bernoulli(p_i): ``jax.random.uniform(fold_in(PRNGKey(seed),
    step), (W,)) < rates``, bit for bit, as a float32 CPU tensor."""
    r = rates.detach().cpu().to(torch.float32).numpy()
    u = prng.uniform(prng.fold_in(prng.prng_key(seed), int(step)), r.shape[0])
    return torch.from_numpy((u < r).astype(np.float32))


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.dim()))


@torch.no_grad()
def gated_sgd_update(stacked: Tree, grads: Tree, theta: torch.Tensor,
                     eta: float) -> Tree:
    """x_i <- x_i - eta * theta_i * g_i  per worker (Eq. 2/3), in place."""
    dev = tree_leaves(stacked)[0].device
    theta = theta.to(dev)

    def upd(x, g):
        gate = _bcast(theta.to(x.dtype), x.dim())
        eta_x = torch.tensor(eta, dtype=x.dtype).item()   # JAX rounds eta
        x.copy_(x - eta_x * gate * g.to(x.dtype))
        return x
    return tree_map(upd, stacked, grads)


@torch.no_grad()
def _mix_in_place(stacked: Tree, fn: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Tree:
    """Each leaf x <- fn(x), one leaf at a time (peak: one leaf's copy)."""
    def one(x):
        x.copy_(fn(x))
        return x
    return tree_map(one, stacked)


def _einsum_operator(t: torch.Tensor, stacked: Tree,
                     mix_dtype: str | None) -> Tree:
    """new[j] = sum_i T[i, j] x_i per leaf, in the leaf's (or mix) dtype."""
    def mix(x):
        xm = x.to(getattr(torch, mix_dtype)) if mix_dtype else x
        y = torch.einsum("ij,i...->j...", t.to(xm.dtype), xm)
        return y.to(x.dtype)
    return _mix_in_place(stacked, mix)


def _grouped_dims(st: MLLState) -> tuple[int, int]:
    if st.workers_per_subnet <= 0:
        raise ValueError(
            "grouped mixing (two_stage/ppermute) requires equal-size "
            "sub-networks; use mixing='dense' for unequal subnets")
    return st.num_subnets, st.workers_per_subnet


def subnet_average_dense(stacked: Tree, st: MLLState,
                         mix_dtype: str | None = None) -> Tree:
    return _einsum_operator(st.v_op, stacked, mix_dtype)


def hub_average_dense(stacked: Tree, st: MLLState,
                      mix_dtype: str | None = None) -> Tree:
    return _einsum_operator(st.z_op, stacked, mix_dtype)


def _product_mean(v: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """Within-subnet weighted mean of (D, Nd, ...) as rounded per-worker
    products + an explicit reduce over Nd (the JAX package's term-for-term
    form of the SPMD psum)."""
    return (_bcast(v, xg.dim()) * xg).sum(dim=1)


def _roll_mix(h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y_e = sum_o H[(e+o) mod D, e] * z_{(e+o) mod D}, accumulated in
    ascending roll order o."""
    d = z.shape[0]
    e = torch.arange(d, device=h.device)
    y = None
    for o in range(d):
        w = _bcast(h[(e + o) % d, e], z.dim())
        term = w * (torch.roll(z, -o, dims=0) if o else z)
        y = term if y is None else y + term
    return y


def _grouped(stacked: Tree, st: MLLState, mix_dtype: str | None,
             hub: Callable[[torch.Tensor, torch.dtype], torch.Tensor] | None
             ) -> Tree:
    """Subnet mean of every leaf, then ``hub(z)`` over the D hub models
    (None: no hub stage), broadcast back to the subnet's workers."""
    d, nd = _grouped_dims(st)
    v = st.v_weights.reshape(d, nd)

    def mix(x):
        xm = x.to(getattr(torch, mix_dtype)) if mix_dtype else x
        xg = xm.reshape((d, nd) + tuple(x.shape[1:]))
        z = _product_mean(v.to(xm.dtype), xg)
        if hub is not None:
            z = hub(z, xm.dtype)
        return z[:, None].expand(xg.shape).reshape(x.shape).to(x.dtype)
    return _mix_in_place(stacked, mix)


def subnet_average_two_stage(stacked: Tree, st: MLLState,
                             mix_dtype: str | None = None) -> Tree:
    """Grouped weighted mean: reshape W -> (D, Nd), reduce Nd, broadcast."""
    return _grouped(stacked, st, mix_dtype, None)


def hub_average_two_stage(stacked: Tree, st: MLLState,
                          mix_dtype: str | None = None) -> Tree:
    """Subnet average, then H-mix the D hub models as weighted rolls."""
    return _grouped(stacked, st, mix_dtype,
                    lambda z, dt: _roll_mix(st.h.to(dt), z))


def _circulant_coeffs(st: MLLState) -> np.ndarray:
    """H as circulant coefficients c_o with y_e = sum_o c_o z_{(e+o) mod D}.
    Valid when H is circulant (ring, or complete with uniform weights)."""
    h = st.h.detach().cpu().numpy()
    d = h.shape[0]
    c = h[:, 0]
    want = np.empty_like(h)
    for e in range(d):
        for o in range(d):
            want[(e + o) % d, e] = c[o]
    if not np.allclose(want, h, atol=1e-9):
        raise ValueError("mixing='ppermute' needs a circulant H (ring or "
                         "complete hub graph with uniform hub weights)")
    return c


def hub_average_ppermute(stacked: Tree, st: MLLState,
                         mix_dtype: str | None = None) -> Tree:
    """Circulant-H hub mixing as a sum of rolls, one per nonzero
    coefficient (non-neighbour rolls are skipped)."""
    coeffs = _circulant_coeffs(st)

    def hub(z, dt):
        y = None
        for o, c in enumerate(coeffs):
            if abs(float(c)) < 1e-12:
                continue
            zo = torch.roll(z, -o, dims=0) if o else z
            term = torch.tensor(float(c), dtype=zo.dtype).item() * zo
            y = term if y is None else y + term
        return y
    return _grouped(stacked, st, mix_dtype, hub)


# ------------------------------------------------------------------- registry
class MixingStrategy:
    """How subnet (V) and hub (Z) averaging rounds are realised.  Stateless
    strategies implement ``subnet`` and ``hub``; the engine always calls the
    ``*_with_state`` forms so a stateful strategy threads its state."""
    name: str = "?"

    def __init__(self, mix_dtype: str | None = None):
        self.mix_dtype = mix_dtype

    def subnet(self, stacked: Tree, st: MLLState) -> Tree:
        raise NotImplementedError

    def hub(self, stacked: Tree, st: MLLState) -> Tree:
        raise NotImplementedError

    def init_state(self, stacked_params: Tree) -> Tree:
        return ()

    def subnet_with_state(self, stacked, st, state):
        return self.subnet(stacked, st), state

    def hub_with_state(self, stacked, st, state):
        return self.hub(stacked, st), state


MIXING_REGISTRY: dict[str, type[MixingStrategy]] = {}


def register(name: str) -> Callable[[type[MixingStrategy]], type[MixingStrategy]]:
    """Class decorator: make a MixingStrategy reachable as
    MLLConfig(mixing=name)."""
    def deco(cls: type[MixingStrategy]) -> type[MixingStrategy]:
        cls.name = name
        MIXING_REGISTRY[name] = cls
        return cls
    return deco


def check_mixing(name: str) -> None:
    if name in UNPORTED_MIXING:
        raise NotImplementedError(f"mixing={name!r} {_UNPORTED}")
    if name not in MIXING_REGISTRY:
        raise ValueError(f"unknown mixing {name!r}; registered strategies: "
                         f"{available_mixing()}")


def get_mixing(name: str, mix_dtype: str | None = None) -> MixingStrategy:
    check_mixing(name)
    return MIXING_REGISTRY[name](mix_dtype)


def available_mixing() -> tuple[str, ...]:
    return tuple(sorted(MIXING_REGISTRY))


@register("dense")
class DenseMixing(MixingStrategy):
    """The paper's matrices verbatim: X V and X Z as W x W einsums; works
    for unequal-size sub-networks."""

    def subnet(self, stacked, st):
        return subnet_average_dense(stacked, st, self.mix_dtype)

    def hub(self, stacked, st):
        return hub_average_dense(stacked, st, self.mix_dtype)


@register("two_stage")
class TwoStageMixing(MixingStrategy):
    """Structured V/Z: grouped subnet mean + small D x D hub mix as rolls."""

    def subnet(self, stacked, st):
        return subnet_average_two_stage(stacked, st, self.mix_dtype)

    def hub(self, stacked, st):
        return hub_average_two_stage(stacked, st, self.mix_dtype)


@register("ppermute")
class PPermuteMixing(TwoStageMixing):
    """Circulant-H hub mixing as coefficient-weighted rolls; subnet rounds
    stay two-stage."""

    def hub(self, stacked, st):
        return hub_average_ppermute(stacked, st, self.mix_dtype)


# ------------------------------------------------------------ engine: mixing
def schedule_mix(strategy: MixingStrategy, stacked: Tree, mix_state: Tree,
                 step: int, st: MLLState, tau: int, q: int, *,
                 static_phase: int | None = None) -> tuple[Tree, Tree]:
    """Apply T_k for this (1-based) step; ``static_phase`` pins the phase.
    -> (mixed params, new mixing state)."""
    if isinstance(mix_state, tuple) and not mix_state:
        mix_state = strategy.init_state(stacked)
    ph = phase_of(step, tau, q) if static_phase is None else static_phase
    if ph == PHASE_SUBNET:
        return strategy.subnet_with_state(stacked, st, mix_state)
    if ph == PHASE_HUB:
        return strategy.hub_with_state(stacked, st, mix_state)
    return stacked, mix_state


# --------------------------------------------------- engine: gated inner opt
def init_gated_opt_state(optimizer: optim_mod.Optimizer,
                         stacked_params: Tree) -> Tree:
    """``{"inner": optimizer state, "counts": (W,) int32}``; the counts feed
    the optimizer's ``step`` per ACTUAL update."""
    lead = tree_leaves(stacked_params)[0]
    return {"inner": optimizer.init(stacked_params),
            "counts": torch.zeros((lead.shape[0],), dtype=torch.int32,
                                  device=lead.device)}


@torch.no_grad()
def gated_inner_update(optimizer: optim_mod.Optimizer, stacked: Tree,
                       opt_state: Tree, grads: Tree, theta: torch.Tensor,
                       ) -> tuple[Tree, Tree]:
    """Bernoulli-gated inner-optimizer step on the worker axis, in place: a
    gated-off worker keeps params, optimizer state AND its step count.

    The JAX package updates every worker and selects with ``where(gate)``;
    here the optimizer runs on each gated-on worker's slice (views of the
    stacked tensors) with its own count as ``step``, and the result is
    copied into the slice -- the same elementwise arithmetic, without a
    second copy of the fleet."""
    gate = theta.detach().cpu() != 0
    counts = opt_state["counts"] + gate.to(opt_state["counts"].device,
                                           torch.int32)
    inner = opt_state["inner"]
    for i in torch.nonzero(gate).flatten().tolist():
        def take(x, i=i):
            return x[i]
        new_p, new_s = optimizer.update(tree_map(take, grads),
                                        tree_map(take, inner),
                                        tree_map(take, stacked), counts[i])
        for dst, src in zip(tree_leaves(tree_map(take, (stacked, inner))),
                            tree_leaves((new_p, new_s))):
            dst.copy_(src)
    return stacked, {"inner": inner, "counts": counts}


def resolve_inner_optimizer(cfg) -> optim_mod.Optimizer:
    """Inner optimizer from any config carrying (inner_opt, inner_opt_args,
    eta)."""
    name = getattr(cfg, "inner_opt", "sgd")
    args = dict(getattr(cfg, "inner_opt_args", ()) or ())
    return optim_mod.get(name, cfg.eta, **args)


def resolve_mixing(cfg) -> MixingStrategy:
    """Mixing strategy from any config carrying (mixing, mix_dtype)."""
    return get_mixing(cfg.mixing, getattr(cfg, "mix_dtype", None))


# --------------------------------------------------------- engine: full step
class MLLTrainState(NamedTuple):
    """Everything a protocol run carries between ticks, worker axis leading.
    ``step`` counts completed ticks (0-d int32 on the CPU)."""
    params: Tree         # stacked params, leading worker axis on every leaf
    opt_state: Tree      # {"inner": ..., "counts": (W,) int32}
    mix_state: Tree      # per-strategy mixing state (() when stateless)
    step: torch.Tensor   # 0-d int32: completed ticks


def init_train_state(stacked_params: Tree,
                     optimizer: optim_mod.Optimizer | None = None,
                     strategy: MixingStrategy | None = None, *,
                     cfg=None) -> MLLTrainState:
    """Fresh protocol state from (optimizer, strategy) or a config."""
    if optimizer is None:
        optimizer = resolve_inner_optimizer(cfg)
    if strategy is None:
        strategy = resolve_mixing(cfg)
    return MLLTrainState(
        params=stacked_params,
        opt_state=init_gated_opt_state(optimizer, stacked_params),
        mix_state=strategy.init_state(stacked_params),
        step=torch.zeros((), dtype=torch.int32))


def protocol_step(state: MLLTrainState, grads: Tree, cfg, st: MLLState, *,
                  optimizer: optim_mod.Optimizer | None = None,
                  strategy: MixingStrategy | None = None,
                  static_phase: int | None = None) -> MLLTrainState:
    """One full protocol tick: gate, inner-optimizer update, scheduled
    mixing.  ``grads`` carry the worker axis leading on every leaf.  The
    params and optimizer state of ``state`` are updated in place."""
    if optimizer is None:
        optimizer = resolve_inner_optimizer(cfg)
    if strategy is None:
        strategy = resolve_mixing(cfg)
    step = int(state.step) + 1
    theta = gate_sample(cfg.seed, step, st.rates)
    params, opt_state = gated_inner_update(optimizer, state.params,
                                           state.opt_state, grads, theta)
    params, mix_state = schedule_mix(strategy, params, state.mix_state, step,
                                     st, cfg.tau, cfg.q,
                                     static_phase=static_phase)
    return MLLTrainState(params, opt_state, mix_state,
                         torch.tensor(step, dtype=torch.int32))
