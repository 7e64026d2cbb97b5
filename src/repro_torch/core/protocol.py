"""Protocol engine: the paper's algorithm family as (mixing x inner-opt x
schedule) -- counterpart of `repro/core/protocol.py`.

Every execution path drives the same three pluggable pieces:

  1. a **MixingStrategy** from the registry below -- how the subnet (V) and
     hub (Z) averaging rounds are realised: ``dense`` (the paper's W x W
     matrices as einsums), ``two_stage`` (grouped subnet mean, then the
     D x D hub mix as weighted rolls), ``ppermute`` (circulant-H hub mix
     as rolls with nonzero coefficients only) and the compression ladder,
     which compresses what the hub wire carries: ``bf16``, ``int8``,
     ``int8_ef`` / ``int4_ef`` (integer wire with error feedback),
     ``topk_ef`` (top-k sparsification) and ``powersgd`` (low-rank
     factors), each with the JAX package's `wire_bytes` accounting,
  2. an **inner optimizer** (`repro_torch.optim.optimizers`) applied per
     worker under the Bernoulli(p_i) gate of Eq. (3) -- a gated worker
     skips the step entirely: params, optimizer state and step count stay
     frozen,
  3. the (tau, q) **schedule** choosing local / subnet / hub per tick.

Multi-device execution: with the stacked (W, ...) fleet sharded over the
``workers`` axis of a process mesh (`launch.mesh`; one `torch.distributed`
rank per JAX device), the ``*_spmd`` methods lower each averaging round to
the collective the JAX package lowers it to (`core.collectives`): the
subnet mean to a grouped all-reduce over the sub-network's ranks, the hub
stage to send / recv rolls along the workers axis, ``dense`` to an
all-gather and a local product into the rank's rows.  ``spmd_capable``
marks the strategies that have them (``[mesh]`` in `describe_mixing`).

Differences from the JAX package, by design:

* **In place.**  Mixing rounds and the gated inner update write their
  results into the stacked tensors they are given (under
  ``torch.no_grad()``) and return the same tree: at qwen3-1.7b width with
  W = 4 a functional update would hold a second 16 GB copy of the fleet.
  Each new value is computed exactly as the JAX expression computes it and
  then copied over the old one, so the arithmetic is unchanged.
* **JAX leaves.**  The compressed rungs reduce over whole leaves (a
  quantization scale, a top-k count, a low-rank factor per leaf).  They
  reduce over the JAX package's leaves: under a ``blocks`` list the
  super-blocks' leaves form one (W, n_sb, ...) leaf, as in the JAX
  layout (`interop.map_groups`), so a scale or a factor spans every
  super-block as there.
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

from repro_torch import interop, resolve_device
from repro_torch.core import collectives, packing, prng
from repro_torch.launch import spans
from repro_torch.optim import optimizers as optim_mod
from repro_torch.tree import tree_leaves, tree_map

Tree = Any

PHASE_LOCAL, PHASE_SUBNET, PHASE_HUB = 0, 1, 2


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


# ------------------------------------------------------------ SPMD lowering
@dataclasses.dataclass(frozen=True)
class SpmdAxis:
    """The mesh axis the worker dim is sharded over, from one rank's view.

    The mesh harness (`launch.harness.TrainHarness(mesh=...)`) gives each
    rank the (W/size, ...) rows of the stacked state; strategies lower
    their averaging rounds to collectives among the axis' ranks through the
    ``*_spmd`` methods below.  ``index`` is the rank's coordinate on the
    axis, ``ranks`` the global ranks along it by coordinate, and ``groups``
    {b: process group of the rank's contiguous block of b shards} (b =
    ``size`` for the whole axis), made once by `launch.mesh.make_mesh`.

    The ``data`` mesh axis (when present) replicates compute, as in the JAX
    package: sharding the within-worker batch would sum partial losses and
    change the float32 reduction order."""
    name: str          # mesh axis name the worker dim is sharded over
    size: int          # number of shards on that axis
    num_workers: int   # global W
    index: int = 0
    ranks: tuple[int, ...] = ()
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def __post_init__(self):
        if self.size < 1 or self.num_workers % self.size:
            raise ValueError(
                f"workers mesh axis of size {self.size} must divide "
                f"W={self.num_workers}")

    @property
    def per_shard(self) -> int:
        return self.num_workers // self.size

    def offset(self) -> int:
        """Global index of this shard's first worker row."""
        return self.index * self.per_shard

    def group(self, block: int | None = None):
        """The group of this rank's block of ``block`` shards (default:
        the whole axis)."""
        return self.groups[self.size if block is None else block]


def spmd_capable_mixing() -> tuple[str, ...]:
    """Registered strategies with a collective (SPMD) lowering."""
    return tuple(sorted(n for n, c in MIXING_REGISTRY.items()
                        if c.spmd_capable))


def grouped_spmd_layout(st: MLLState, spmd: SpmdAxis) -> int:
    """Shards per sub-network for the grouped collective lowerings.

    Returns 0 when the whole worker axis lives on one shard (the round is
    the single-device math), otherwise the number of shards each
    sub-network spans.  The all-reduce / roll lowerings need
    subnet-ALIGNED shards -- every shard entirely inside one sub-network --
    so the subnet mean is one grouped all-reduce and the hub stage one
    send / recv per roll."""
    d, nd = _grouped_dims(st)
    ps = spmd.per_shard
    if spmd.size == 1:
        return 0
    if nd % ps:
        raise ValueError(
            f"grouped SPMD mixing needs subnet-aligned shards: {ps} workers "
            f"per shard must divide Nd={nd} (W={spmd.num_workers} over "
            f"{spmd.size} shards, D={d} sub-networks); use mixing='dense' "
            "or a workers axis that divides the subnet size")
    return nd // ps


def _einsum_operator_spmd(t: torch.Tensor, local: Tree,
                          mix_dtype: str | None, spmd: SpmdAxis, *,
                          packed: bool = False) -> Tree:
    """SPMD lowering of `_einsum_operator`, in place: all-gather the
    contracted worker axis, contract into this shard's output rows only.
    Each output row's contraction runs over the same gathered operand with
    the same length, so the rows equal the single-device product's.  One
    all-gather per leaf, or with ``packed`` (an all-float32 fleet where
    `packing.flat_paths_enabled`, the single-device event operator's flat
    path) one of the packed (W/size, sum C) buffer."""
    lo, hi = spmd.offset(), spmd.offset() + spmd.per_shard
    group = spmd.group()
    if packed and mix_dtype in (None, "float32"):
        spec = packing.pack_spec(local)
        full = collectives.all_gather_rows(packing.pack(local, spec), group)
        tl = t.to(full.device, torch.float32)[:, lo:hi]
        mixed = packing.unpack(torch.einsum("ij,ic->jc", tl, full), spec)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(local), tree_leaves(mixed)):
                dst.copy_(src)
        return local

    def mix(x):
        xm = x.to(getattr(torch, mix_dtype)) if mix_dtype else x
        full = collectives.all_gather_rows(xm, group)
        tl = t.to(xm.device, xm.dtype)[:, lo:hi]
        return torch.einsum("ij,i...->j...", tl, full).to(x.dtype)
    return _mix_in_place(local, mix)


def _grouped_spmd_z(x: torch.Tensor, st: MLLState, spmd: SpmdAxis, sps: int,
                    mix_dtype: str | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """This shard's sub-network mean (no worker axis): the weighted
    per-worker products of the shard's rows summed, then a grouped
    all-reduce over the sub-network's ``sps`` shards.  Equal bit for bit
    to `_product_mean` when the sub-network's workers lie on at most two
    shards, one each or all on one (the add orders coincide, and a + b is
    exact in either order); over three or more shards the library's add
    order may differ from the serial sum in the last bits."""
    xm = x.to(getattr(torch, mix_dtype)) if mix_dtype else x
    lo = spmd.offset()
    vl = st.v_weights.to(xm.dtype)[lo:lo + spmd.per_shard]
    part = (_bcast(vl, xm.dim()) * xm).sum(dim=0)
    if sps > 1:
        part = collectives.all_reduce_sum(part, spmd.group(sps))
    return xm, part


def subnet_average_two_stage_spmd(local: Tree, st: MLLState, spmd: SpmdAxis,
                                  mix_dtype: str | None = None) -> Tree:
    """`subnet_average_two_stage` on a mesh: the sub-network mean is a
    grouped all-reduce over its shards, broadcast back over this shard's
    worker rows."""
    sps = grouped_spmd_layout(st, spmd)
    if sps == 0:                    # whole worker axis on this shard
        return subnet_average_two_stage(local, st, mix_dtype)

    def mix(x):
        xm, z = _grouped_spmd_z(x, st, spmd, sps, mix_dtype)
        return z[None].expand(xm.shape).to(x.dtype)
    return _mix_in_place(local, mix)


def _hub_spmd_rolls(local: Tree, st: MLLState, spmd: SpmdAxis,
                    mix_dtype: str | None, terms) -> Tree:
    """Shared hub-stage skeleton: the subnet mean by grouped all-reduce,
    then ``terms(dtype, z, roll)`` summed over the rolls the strategy
    emits.  Roll o receives the hub model of the sub-network o further on:
    shard s sends to shard (s - o*sps) mod size and receives from
    (s + o*sps) mod size (the JAX ``ppermute`` pairs)."""
    sps = grouped_spmd_layout(st, spmd)
    assert sps > 0, "callers handle the single-shard case"
    s, n = spmd.index, spmd.size

    def roll(z, o):
        if not o:
            return z
        return collectives.sendrecv(z, spmd.ranks[(s - o * sps) % n],
                                    spmd.ranks[(s + o * sps) % n],
                                    spmd.group())

    def mix(x):
        xm, z = _grouped_spmd_z(x, st, spmd, sps, mix_dtype)
        y = None
        for term in terms(xm.dtype, z, roll):
            y = term if y is None else y + term
        return y[None].expand(xm.shape).to(x.dtype)
    return _mix_in_place(local, mix)


def _receiver_weights(st: MLLState, spmd: SpmdAxis, dtype: torch.dtype
                      ) -> list[torch.Tensor]:
    """H[(e + o) mod D, e] for this shard's sub-network e, o = 0..D-1, as
    0-d tensors of ``dtype`` (the `_roll_mix` weights)."""
    d, _ = _grouped_dims(st)
    e = spmd.index // grouped_spmd_layout(st, spmd)
    h = st.h.to(dtype)
    return [h[(e + o) % d, e] for o in range(d)]


def hub_average_two_stage_spmd(local: Tree, st: MLLState, spmd: SpmdAxis,
                               mix_dtype: str | None = None) -> Tree:
    """`hub_average_two_stage` on a mesh: the hub models' rolls as send /
    recv, each weighted by the receiver's H column entry (general H) --
    add for add the `_roll_mix` accumulation."""
    if grouped_spmd_layout(st, spmd) == 0:
        return hub_average_two_stage(local, st, mix_dtype)

    def terms(dtype, z, roll):
        for o, w in enumerate(_receiver_weights(st, spmd, dtype)):
            yield w * roll(z, o)
    return _hub_spmd_rolls(local, st, spmd, mix_dtype, terms)


def hub_average_ppermute_spmd(local: Tree, st: MLLState, spmd: SpmdAxis,
                              mix_dtype: str | None = None) -> Tree:
    """`hub_average_ppermute` on a mesh: one send / recv per NONZERO
    circulant coefficient (wire traffic scales with the hub graph's
    degree); zero-coefficient rolls are skipped as in the single-device
    loop."""
    if grouped_spmd_layout(st, spmd) == 0:
        return hub_average_ppermute(local, st, mix_dtype)
    coeffs = _circulant_coeffs(st)

    def terms(dtype, z, roll):
        for o, c in enumerate(coeffs):
            if abs(float(c)) < 1e-12:
                continue                     # non-neighbour: no traffic
            yield torch.tensor(float(c), dtype=dtype).item() * roll(z, o)
    return _hub_spmd_rolls(local, st, spmd, mix_dtype, terms)


def _f32(c) -> float:
    """A coefficient as the float32 the JAX package multiplies by."""
    return float(np.float32(c))


def _gather(leaves: list, blocks: bool) -> torch.Tensor:
    """One JAX leaf in float32: the leaf, or its super-blocks stacked on
    axis 1 (a new tensor either way when the leaf is not float32)."""
    if blocks:
        return torch.stack([x.float() for x in leaves], dim=1)
    return leaves[0].float()


def _scatter(leaves: list, blocks: bool, y: torch.Tensor, nd: int) -> None:
    """Write the D hub values ``y`` (D, ...) of one JAX leaf into every
    worker of its subnet, in place, rounded once to each leaf's dtype."""
    for i, x in enumerate(leaves):
        yi = y[:, i] if blocks else y
        x.unflatten(0, (y.shape[0], nd)).copy_(yi[:, None])


def _compensated_mean(v: torch.Tensor, x: torch.Tensor, e: torch.Tensor,
                      d: int, nd: int) -> torch.Tensor:
    """The within-subnet v-weighted mean of x + e: (W, ...) -> (D, ...)."""
    shape = (d, nd) + tuple(x.shape[1:])
    return torch.einsum("dn,dn...->d...", v, (x + e).reshape(shape))


def _sym_quantize(x: torch.Tensor, levels: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-hub integer quantization of (D, ...) float32: scale =
    max|x| / ``levels`` over all dims but the hub dim, values clipped to
    [-levels, levels], round half to even.  ``levels=127`` is the int8
    wire, ``levels=7`` the int4 wire (carried in int8; `wire_bytes`
    charges 4 bits)."""
    axes = tuple(range(1, x.dim()))
    amax = x.abs().amax(dim=axes, keepdim=True) if axes else x.abs()
    scale = torch.clamp(amax, min=1e-12) / float(levels)
    q = torch.clamp(torch.round(x / scale), -levels, levels)
    return q.to(torch.int8), scale


def _int8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _sym_quantize(x, 127)


def _int_rolls(coeffs: np.ndarray, own: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """y_e = sum_o c_o z_{(e+o) mod D}: the own model (o = 0) from
    ``own``, every neighbour from its integer wire values times its scale,
    accumulated in ascending o over the nonzero coefficients."""
    y = None
    for o, c in enumerate(coeffs):
        if abs(float(c)) < 1e-12:
            continue
        if o:
            deq = (torch.roll(q, -o, dims=0).float()
                   * torch.roll(scale, -o, dims=0))
            term = _f32(c) * deq
        else:
            term = _f32(c) * own
        y = term if y is None else y + term
    return y


@torch.no_grad()
def hub_average_int8(stacked: Tree, st: MLLState) -> Tree:
    """int8-quantized hub mixing over a circulant H: the subnet average
    stays float32, neighbour hub models arrive as int8 + one float32 scale
    per hub model and leaf; the own hub model stays exact.  Biased (the
    ``int8_ef`` strategy removes the bias with error feedback)."""
    d, nd = _grouped_dims(st)
    v = st.v_weights.reshape(d, nd)
    coeffs = _circulant_coeffs(st)
    for _, leaves, blocks in interop.leaf_groups(stacked):
        x = _gather(leaves, blocks)
        z = torch.einsum("dn,dn...->d...", v,
                         x.reshape((d, nd) + tuple(x.shape[1:])))
        q, scale = _int8_quantize(z)
        _scatter(leaves, blocks, _int_rolls(coeffs, z, q, scale), nd)
        del x, z, q
    return stacked


def init_error_feedback(stacked_params: Tree) -> Tree:
    """Residual state for error-feedback mixing: a float32 zero tensor per
    leaf, in the params' layout."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), stacked_params)


@torch.no_grad()
def hub_average_intq_ef(stacked: Tree, ef: Tree, st: MLLState, *,
                        levels: int = 127) -> tuple[Tree, Tree]:
    """Integer-quantized hub mixing with error feedback: each round's
    quantization residual is added back before the next round's
    quantization, so the long-run average is unbiased.  ``levels=127`` is
    the int8 wire, ``levels=7`` the int4 wire.  Every worker carries its
    subnet's full hub residual (the next round's v-weighted mean returns it
    exactly).  -> (mixed params, new residuals), both written in place
    into ``stacked`` and ``ef``."""
    d, nd = _grouped_dims(st)
    v = st.v_weights.reshape(d, nd)
    coeffs = _circulant_coeffs(st)
    groups = zip(interop.leaf_groups(stacked), interop.leaf_groups(ef))
    for (_, leaves, blocks), (_, eleaves, _) in groups:
        z = _compensated_mean(v, _gather(leaves, blocks),
                              _gather(eleaves, blocks), d, nd)
        q, scale = _sym_quantize(z, levels)
        deq_own = q.float() * scale
        y = _int_rolls(coeffs, deq_own, q, scale)
        _scatter(leaves, blocks, y, nd)
        _scatter(eleaves, blocks, z - deq_own, nd)   # what the wire lost
        del z, q, deq_own, y
    return stacked, ef


def hub_average_int8_ef(stacked: Tree, ef: Tree, st: MLLState
                        ) -> tuple[Tree, Tree]:
    """`hub_average_intq_ef` at the int8 wire (levels=127)."""
    return hub_average_intq_ef(stacked, ef, st, levels=127)


def hub_average_bf16(stacked: Tree, st: MLLState) -> Tree:
    """bf16-wire hub mixing over a general H: neighbour hub models arrive
    as bf16 and widen to float32 before the weighted accumulation; the own
    hub model (o = 0) stays float32.  Elementwise, so per port leaf."""
    d, nd = _grouped_dims(st)
    v = st.v_weights.reshape(d, nd)
    h = st.h.float()
    e = torch.arange(d, device=h.device)

    def mix(x):
        xg = x.float().reshape((d, nd) + tuple(x.shape[1:]))
        z = _product_mean(v, xg)
        wire = z.to(torch.bfloat16)
        y = None
        for o in range(d):
            w = _bcast(h[(e + o) % d, e], z.dim())
            zo = z if o == 0 else torch.roll(wire, -o, dims=0).float()
            term = w * zo
            y = term if y is None else y + term
        return y[:, None].expand(xg.shape).reshape(x.shape).to(x.dtype)
    return _mix_in_place(stacked, mix)


def hub_average_bf16_spmd(local: Tree, st: MLLState, spmd: SpmdAxis) -> Tree:
    """`hub_average_bf16` on a mesh: the rolls carry the BF16 wire buffers
    (2 bytes per element on the wire), widened to float32 on arrival; the
    own hub model (o = 0) stays float32 -- add for add the single-device
    accumulation, which is in float32 whatever the params' dtype."""
    if grouped_spmd_layout(st, spmd) == 0:
        return hub_average_bf16(local, st)

    def terms(dtype, z, roll):
        wire = z.to(torch.bfloat16)
        for o, w in enumerate(_receiver_weights(st, spmd, torch.float32)):
            yield w * (z if o == 0 else roll(wire, o).float())
    return _hub_spmd_rolls(local, st, spmd, "float32", terms)


def _topk_count(cols: int, ratio: float) -> int:
    """Entries kept per hub model for a leaf with ``cols`` elements."""
    return max(1, min(cols, int(-(-cols * ratio // 1))))


def _topk_mask(a: torch.Tensor, k: int) -> torch.Tensor:
    """(D, C) bool: the k largest of each row of ``a`` (>= 0), ties kept
    lowest index first, as ``jax.lax.top_k`` keeps them (``torch.topk``
    promises no order among equal values): every entry above the row's
    k-th largest value v, then the first entries equal to v until k are
    kept."""
    v = torch.topk(a, k, dim=1, sorted=False).values.amin(dim=1,
                                                          keepdim=True)
    above = a > v
    need = k - above.sum(dim=1, keepdim=True)
    tie = a == v
    return above | (tie & (torch.cumsum(tie, dim=1) <= need))


def _topk_sparsify(z: torch.Tensor, k: int) -> torch.Tensor:
    """Dense copy of (D, ...) hub models keeping only each model's k
    largest-|.| entries (the wire carries k (value, index) pairs)."""
    flat = z.reshape(z.shape[0], -1)
    keep = _topk_mask(flat.abs(), k)
    return torch.where(keep, flat, torch.zeros_like(flat)).reshape(z.shape)


@torch.no_grad()
def hub_average_topk_ef(stacked: Tree, ef: Tree, st: MLLState, *,
                        ratio: float, momentum: float) -> tuple[Tree, Tree]:
    """Top-k sparsified hub mixing with momentum error feedback: each hub
    model crosses the wire as its k = ceil(ratio * size) largest-|.|
    entries per leaf; the dropped mass decays into the residual by
    ``momentum`` and compensates the next round.  General H (`_roll_mix`).
    -> (mixed params, new residuals), written in place."""
    d, nd = _grouped_dims(st)
    v = st.v_weights.reshape(d, nd)
    h = st.h.float()
    groups = zip(interop.leaf_groups(stacked), interop.leaf_groups(ef))
    for (_, leaves, blocks), (_, eleaves, _) in groups:
        x = _gather(leaves, blocks)
        u = _compensated_mean(v, x, _gather(eleaves, blocks), d, nd)
        cols = u[0].numel()
        del x
        s = _topk_sparsify(u, _topk_count(cols, ratio))
        _scatter(leaves, blocks, _roll_mix(h, s), nd)
        _scatter(eleaves, blocks, _f32(momentum) * (u - s), nd)
        del u, s
    return stacked, ef


def _powersgd_approx(m: torch.Tensor, q: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One warm-started PowerSGD iteration per hub model: ``m`` (D, n, c),
    ``q`` (D, c, r); P = M Q orthonormalized (reduced QR), Q' = M^T P, and
    the rank-r reconstruction P Q'^T = P P^T M.  -> (approx, Q')."""
    p = torch.einsum("dnc,dcr->dnr", m, q)
    p, _ = torch.linalg.qr(p)
    q_new = torch.einsum("dnc,dnr->dcr", m, p)
    return torch.einsum("dnr,dcr->dnc", p, q_new), q_new


def _powersgd_factor(i: int, c: int, r: int, w: int,
                     device: torch.device) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(i), (c, r))`` for every worker."""
    qi = prng.normal(prng.prng_key(i), c * r).reshape(c, r)
    return torch.from_numpy(qi).to(device).expand(w, c, r).contiguous()


def init_powersgd_state(stacked_params: Tree, rank: int) -> dict:
    """PowerSGD mixing state: ``{"ef": residuals (the params' layout),
    "q": factors (the JAX layout)}``.  A matrix leaf (a JAX leaf with
    per-worker ndim >= 2, flattened to (n, c)) gets a per-worker (c, r)
    Gaussian Q, r = min(rank, n, c), drawn from ``PRNGKey(i)`` for JAX
    leaf position i; vector and scalar leaves cross the wire exact and
    carry an empty (W, 0) placeholder.  ``q`` keeps the JAX layout because
    a factor spans all super-blocks of its leaf."""
    counter = iter(range(1 << 30))

    def factor(_, leaves, blocks):
        i = next(counter)
        x = leaves[0]
        w, dev = x.shape[0], x.device
        shape = (w, len(leaves)) + tuple(x.shape[1:]) if blocks \
            else tuple(x.shape)
        if len(shape) < 3:
            return torch.zeros((w, 0), dtype=torch.float32, device=dev)
        n, c = shape[1], int(np.prod(shape[2:]))
        return _powersgd_factor(i, c, min(rank, n, c), w, dev)
    return {"ef": init_error_feedback(stacked_params),
            "q": interop.map_groups(factor, stacked_params)}


@torch.no_grad()
def hub_average_powersgd(stacked: Tree, ef: Tree, q: Tree, st: MLLState
                         ) -> tuple[Tree, Tree, Tree]:
    """Low-rank hub mixing with warm-started PowerSGD factors and error
    feedback: each hub's compensated model crosses the wire as rank-r
    factors per matrix leaf; the low-rank residual feeds back next round
    and Q' warm-starts the next power iteration.  Vector and scalar leaves
    are sent exact (their residual stays zero).  General H (`_roll_mix`).
    -> (mixed params and residuals, written in place; new factors, a new
    tree in the JAX layout)."""
    d, nd = _grouped_dims(st)
    v = st.v_weights.reshape(d, nd)
    h = st.h.float()
    old_q, new_q = _by_key(q), {}
    groups = zip(interop.leaf_groups(stacked), interop.leaf_groups(ef))
    for (key, leaves, blocks), (_, eleaves, _) in groups:
        qv = old_q[key]
        x = _gather(leaves, blocks)
        u = _compensated_mean(v, x, _gather(eleaves, blocks), d, nd)
        if x.dim() >= 3 and qv.numel():
            n, c, r = x.shape[1], qv.shape[1], qv.shape[2]
            qh = qv.reshape(d, nd, c, r)[:, 0]
            approx, q_new = _powersgd_approx(u.reshape(d, n, c), qh)
            s = approx.reshape(u.shape)
            resid = u - s
            new_q[key] = q_new[:, None].expand(d, nd, c, r).reshape(qv.shape)
        else:
            s, resid, new_q[key] = u, torch.zeros_like(u), qv
        del x
        _scatter(leaves, blocks, _roll_mix(h, s), nd)
        _scatter(eleaves, blocks, resid, nd)
        del u, s, resid
    q_tree = interop.map_with_keys(lambda k, _b, _x: new_q[k], q)
    return stacked, ef, q_tree


def _by_key(tree: Tree) -> dict:
    """{JAX key: leaf} of a tree in the JAX layout."""
    out: dict = {}
    interop.map_with_keys(lambda k, _b, x: out.setdefault(k, x), tree)
    return out


def _hub_edges(st: MLLState) -> int:
    """Directed hub-graph edges that carry wire traffic: nonzero
    off-diagonal entries of H (a hub's own model never leaves the pod)."""
    h = np.abs(st.h.detach().cpu().numpy()) > 1e-12
    return int(h.sum() - np.diag(h).sum())


def wire_spec(stacked: Tree) -> packing.PackSpec:
    """The packed layout of ``stacked``'s JAX leaves (super-blocks stacked
    on axis 1): the ``spec`` that `MixingStrategy.wire_bytes` reads, so a
    leaf's per-leaf wire costs (a scale, a top-k count, a factor) are
    charged as the JAX package charges them.  Equal to
    `packing.pack_spec` for a tree without ``blocks`` lists."""
    def meta(_, leaves, blocks):
        x = leaves[0]
        shape = (x.shape[0], len(leaves)) + tuple(x.shape[1:]) if blocks \
            else tuple(x.shape)
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return packing.pack_spec(interop.map_groups(meta, stacked))


# ------------------------------------------------------------------- registry
class MixingStrategy:
    """How subnet (V) and hub (Z) averaging rounds are realised.  Stateless
    strategies implement ``subnet`` and ``hub``; the engine always calls the
    ``*_with_state`` forms so a stateful strategy threads its state."""
    name: str = "?"
    # strategies with a collective lowering (the ``*_spmd`` methods) set
    # this True; the mesh harness refuses meshes for the rest up front
    spmd_capable: bool = False
    # one-line wire-format description (``--mixing list``)
    wire_format: str = "f32 hub models (4 B/elem; mix_dtype overrides)"

    def __init__(self, mix_dtype: str | None = None):
        self.mix_dtype = mix_dtype

    def hub_payload_bytes(self, st: MLLState, spec: packing.PackSpec) -> int:
        """Bytes ONE hub model costs on the wire, for a stacked tree laid
        out by ``spec`` (`wire_spec`).  Default: every element at the mix
        dtype."""
        dt = getattr(torch, self.mix_dtype) if self.mix_dtype \
            else torch.float32
        return dt.itemsize * spec.total_cols

    def wire_bytes(self, st: MLLState, spec: packing.PackSpec) -> int:
        """Hub-boundary bytes of ONE hub round: one `hub_payload_bytes`
        payload per directed hub edge (`_hub_edges`).  Subnet rounds are
        not counted: the ladder compresses the scarce hub hop."""
        return _hub_edges(st) * self.hub_payload_bytes(st, spec)

    def subnet(self, stacked: Tree, st: MLLState) -> Tree:
        raise NotImplementedError(f"{type(self).__name__} defines no subnet "
                                  "round")

    def hub(self, stacked: Tree, st: MLLState) -> Tree:
        raise NotImplementedError(f"{type(self).__name__} defines no hub "
                                  "round")

    def init_state(self, stacked_params: Tree) -> Tree:
        return ()

    # each ``*_with_state`` method, overrides included, is one mixing
    # round: the ``mix`` span (`launch.spans`) of a traced slot
    def subnet_with_state(self, stacked, st, state):
        with spans.span("mix"):
            return self.subnet(stacked, st), state

    def hub_with_state(self, stacked, st, state):
        with spans.span("mix"):
            return self.hub(stacked, st), state

    # ---- SPMD lowering: inputs and outputs are this rank's (W/size, ...)
    # worker rows; collectives run among the ranks of ``spmd``
    def validate_spmd(self, st: MLLState, spmd: SpmdAxis) -> None:
        """Raise (when the harness is built, before any slot runs) when
        this strategy cannot lower the given mesh layout to collectives."""
        if not self.spmd_capable:
            raise ValueError(
                f"mixing={self.name!r} has no SPMD collective lowering; "
                f"strategies that run on a mesh: {spmd_capable_mixing()}")

    def subnet_spmd(self, local: Tree, st: MLLState, spmd: SpmdAxis) -> Tree:
        raise NotImplementedError(
            f"mixing={self.name!r} has no SPMD subnet lowering")

    def hub_spmd(self, local: Tree, st: MLLState, spmd: SpmdAxis) -> Tree:
        raise NotImplementedError(
            f"mixing={self.name!r} has no SPMD hub lowering")

    def subnet_spmd_with_state(self, local, st, state, spmd):
        with spans.span("mix"):
            return self.subnet_spmd(local, st, spmd), state

    def hub_spmd_with_state(self, local, st, state, spmd):
        with spans.span("mix"):
            return self.hub_spmd(local, st, spmd), state


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
    if name not in MIXING_REGISTRY:
        raise ValueError(f"unknown mixing {name!r}; registered strategies: "
                         f"{available_mixing()}")


def get_mixing(name: str, mix_dtype: str | None = None) -> MixingStrategy:
    check_mixing(name)
    return MIXING_REGISTRY[name](mix_dtype)


def available_mixing() -> tuple[str, ...]:
    return tuple(sorted(MIXING_REGISTRY))


def describe_mixing() -> str:
    """One line per registered strategy: name, whether it runs on a mesh
    (``[mesh]``: it has collective lowerings) or only on one device
    (``[vmap]``), wire format (the text of ``--mixing list``)."""
    width = max(len(n) for n in MIXING_REGISTRY)
    lines = []
    for name in available_mixing():
        cls = MIXING_REGISTRY[name]
        spmd = "mesh" if cls.spmd_capable else "vmap"
        lines.append(f"  {name:<{width}}  [{spmd}]  {cls.wire_format}")
    return "registered mixing strategies (wire format on hub edges):\n" + \
        "\n".join(lines)


@register("dense")
class DenseMixing(MixingStrategy):
    """The paper's matrices verbatim: X V and X Z as W x W einsums; works
    for unequal-size sub-networks.  On a mesh: all-gather the worker axis,
    contract into this rank's output rows only."""
    spmd_capable = True
    wire_format = "f32 W x W contraction; full-precision models on every edge"

    def subnet(self, stacked, st):
        return subnet_average_dense(stacked, st, self.mix_dtype)

    def hub(self, stacked, st):
        return hub_average_dense(stacked, st, self.mix_dtype)

    def subnet_spmd(self, local, st, spmd):
        return _einsum_operator_spmd(st.v_op, local, self.mix_dtype, spmd)

    def hub_spmd(self, local, st, spmd):
        return _einsum_operator_spmd(st.z_op, local, self.mix_dtype, spmd)


@register("two_stage")
class TwoStageMixing(MixingStrategy):
    """Structured V/Z: grouped subnet mean + small D x D hub mix as rolls.
    On a mesh: the subnet mean is a grouped all-reduce over the
    sub-network's ranks, the hub stage receiver-weighted send / recv
    rolls."""
    spmd_capable = True
    wire_format = "f32 hub models as rolls (4 B/elem; mix_dtype overrides)"

    def subnet(self, stacked, st):
        return subnet_average_two_stage(stacked, st, self.mix_dtype)

    def hub(self, stacked, st):
        return hub_average_two_stage(stacked, st, self.mix_dtype)

    def validate_spmd(self, st, spmd):
        super().validate_spmd(st, spmd)
        grouped_spmd_layout(st, spmd)      # raises on misaligned shards

    def subnet_spmd(self, local, st, spmd):
        return subnet_average_two_stage_spmd(local, st, spmd, self.mix_dtype)

    def hub_spmd(self, local, st, spmd):
        return hub_average_two_stage_spmd(local, st, spmd, self.mix_dtype)


@register("ppermute")
class PPermuteMixing(TwoStageMixing):
    """Circulant-H hub mixing as coefficient-weighted rolls; subnet rounds
    stay two-stage.  On a mesh: one send / recv per nonzero circulant
    coefficient."""
    wire_format = "f32 hub models, one permute per nonzero circulant coeff"

    def hub(self, stacked, st):
        return hub_average_ppermute(stacked, st, self.mix_dtype)

    def validate_spmd(self, st, spmd):
        super().validate_spmd(st, spmd)
        _circulant_coeffs(st)              # raises on non-circulant H

    def hub_spmd(self, local, st, spmd):
        return hub_average_ppermute_spmd(local, st, spmd, self.mix_dtype)


@register("int8")
class Int8Mixing(TwoStageMixing):
    """Circulant-H hub wire of int8-quantized hub models (biased).
    ``mix_dtype`` applies to the subnet rounds only.  Not spmd-capable
    (though it inherits `TwoStageMixing`): the int8 wire needs typed
    collectives that carry the int8 buffers, not the float32 rolls the
    inherited lowering would send."""
    spmd_capable = False
    wire_format = "int8 values + one f32 scale per hub model per leaf (biased)"

    def hub(self, stacked, st):
        return hub_average_int8(stacked, st)

    def subnet_spmd(self, local, st, spmd):
        raise NotImplementedError(
            f"mixing={self.name!r} has no SPMD lowering (compressed wire "
            f"format needs typed collectives); strategies that run on a "
            f"mesh: {spmd_capable_mixing()}")

    hub_spmd = subnet_spmd

    def hub_payload_bytes(self, st, spec):
        return sum(s.size + 4 for s in spec.slots)


@register("int8_ef")
class Int8EFMixing(Int8Mixing):
    """int8 hub mixing + error feedback: per-worker float32 residuals make
    the long-run average unbiased.  Stateful (the residual tree)."""
    levels = 127               # quantization levels of the integer wire
    wire_format = "int8 values + f32 scales, error-feedback residuals"

    def init_state(self, stacked_params):
        return init_error_feedback(stacked_params)

    def hub(self, stacked, st):
        out, _ = hub_average_intq_ef(stacked, init_error_feedback(stacked),
                                     st, levels=self.levels)
        return out

    def hub_with_state(self, stacked, st, state):
        if isinstance(state, tuple) and not state:   # caller without state
            state = init_error_feedback(stacked)
        with spans.span("mix"):
            return hub_average_intq_ef(stacked, state, st,
                                       levels=self.levels)


@register("int4_ef")
class Int4EFMixing(Int8EFMixing):
    """int4 hub wire (2 elements per byte + one f32 scale per hub model
    and leaf) with ``int8_ef``'s error feedback; carried in int8 tensors,
    charged 4 bits by `hub_payload_bytes`."""
    levels = 7
    wire_format = "int4 values (2 elem/byte) + f32 scales, EF residuals"

    def hub_payload_bytes(self, st, spec):
        return sum((s.size + 1) // 2 + 4 for s in spec.slots)


@register("bf16")
class Bf16Mixing(TwoStageMixing):
    """bf16 hub wire: neighbour hub models arrive as bf16 (half the bytes
    of f32) and widen on arrival; the own hub model stays f32.
    Stateless.  On a mesh the send / recv rolls carry the bf16 buffers."""
    spmd_capable = True
    wire_format = "bf16 hub models (2 B/elem), stateless"

    def hub(self, stacked, st):
        return hub_average_bf16(stacked, st)

    def hub_spmd(self, local, st, spmd):
        return hub_average_bf16_spmd(local, st, spmd)

    def hub_payload_bytes(self, st, spec):
        return 2 * spec.total_cols


@register("topk_ef")
class TopKEFMixing(Int8Mixing):
    """Top-k sparsified hub wire with momentum error feedback: each hub
    model crosses as its k = ceil(size / 32) largest-|.| entries per leaf,
    (f32 value, i32 index) pairs; the dropped mass decays into the
    residual by ``ef_momentum``."""
    k_ratio = 1 / 32           # fraction of entries kept per leaf
    ef_momentum = 0.9          # residual decay (plain EF would be 1.0)
    wire_format = "top-k (f32 value, i32 index) pairs, momentum EF residuals"

    def init_state(self, stacked_params):
        return init_error_feedback(stacked_params)

    def hub(self, stacked, st):
        out, _ = hub_average_topk_ef(stacked, init_error_feedback(stacked),
                                     st, ratio=self.k_ratio,
                                     momentum=self.ef_momentum)
        return out

    def hub_with_state(self, stacked, st, state):
        if isinstance(state, tuple) and not state:   # caller without state
            state = init_error_feedback(stacked)
        with spans.span("mix"):
            return hub_average_topk_ef(stacked, state, st,
                                       ratio=self.k_ratio,
                                       momentum=self.ef_momentum)

    def hub_payload_bytes(self, st, spec):
        return sum(8 * _topk_count(s.size, self.k_ratio) for s in spec.slots)


@register("powersgd")
class PowerSGDMixing(Int8Mixing):
    """Low-rank hub wire: rank-r PowerSGD factors (P n x r, Q c x r, f32)
    per matrix leaf, warm-started Q + EF residual; vector and scalar leaves
    sent exact.  State is {"ef": residual tree, "q": factor tree}."""
    rank = 2                   # target rank (clamped to min(n, c) per leaf)
    wire_format = "rank-r PowerSGD factors per matrix leaf, EF residuals"

    def init_state(self, stacked_params):
        return init_powersgd_state(stacked_params, self.rank)

    def hub(self, stacked, st):
        out, _ = self.hub_with_state(stacked, st, ())
        return out

    def hub_with_state(self, stacked, st, state):
        if isinstance(state, tuple) and not state:   # caller without state
            state = init_powersgd_state(stacked, self.rank)
        with spans.span("mix"):
            params, ef, q = hub_average_powersgd(stacked, state["ef"],
                                                 state["q"], st)
        return params, {"ef": ef, "q": q}

    def hub_payload_bytes(self, st, spec):
        total = 0
        for s in spec.slots:
            if len(s.shape) >= 3:          # (W, n, ...) matrix leaf
                n = s.shape[1]
                c = s.size // n
                total += 4 * min(self.rank, n, c) * (n + c)
            else:
                total += 4 * s.size        # exact wire
        return total


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
    with spans.span("update"):
        gate = theta.detach().cpu() != 0
        counts = opt_state["counts"] + gate.to(opt_state["counts"].device,
                                               torch.int32)
        inner = opt_state["inner"]
        for i in torch.nonzero(gate).flatten().tolist():
            def take(x, i=i):
                return x[i]
            new_p, new_s = optimizer.update(tree_map(take, grads),
                                            tree_map(take, inner),
                                            tree_map(take, stacked),
                                            counts[i])
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
