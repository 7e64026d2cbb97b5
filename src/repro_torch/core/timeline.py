"""Wall-clock timeline plans: readiness policies and event traces
(counterpart of the plan side of `repro/core/timeline.py`).

A **readiness policy** (registry below; `@register_policy`) turns a
multi-level network, a (tau, q) schedule and a slot budget into a
`TimelinePlan`: per slot, which workers make progress and which averaging
round fires.  The policies are the JAX package's, numpy only, and draw from
the same numpy Generator calls, so given the same Generator the port's plan
equals the reference's:

  * ``"barrier"``  -- global barrier: a round completes only when EVERY
    worker has taken tau gradient steps (Local SGD / HL-SGD semantics);
  * ``"deadline"`` -- V every tau slots and Z every q*tau slots no matter
    what (the paper's MLL-SGD timing);
  * ``"gossip"``   -- each sub-network runs its own tau-step barrier and
    ready neighbour hubs gossip over the ready-restricted H (masked dense
    operators).

Rate models: ``"bernoulli"`` (p_i trials; under ``deadline`` the in-step
gate does the draws), ``"deterministic"`` and ``"measured"`` (a 1/p_i
staircase; measured rates come from a `RateCalibration`).

`plan_trace` / `export_trace` / `load_trace` write and read the shared
``mll-timeline-trace/v1`` document.

Plans execute through the protocol engine end to end (every ported mixing
strategy and inner optimizer, per-worker state frozen on idle slots) on the
simulator's carry (`simulator.init_sim_carry`); with p_i = 1 the barrier
policy reproduces the lock-step trajectory bit for bit.  Execution is
**event-sparse** by default (`EventExecutor`): local-only slots run just
the gated inner update -- no identity operator contraction -- and each
mixing event applies its operator once.  Every slot draws the same
randomness as the full every-slot scan (`make_timeline_step_fn`,
``exec_mode="full"``, kept as the reference for op-id plans), so the two
give the same bits.  With ``kernel="pallas"`` events run the hand-written
fused update + mix kernel over the packed (W, sum C_i) float32 buffer
(`repro_torch.kernels.ops.hier_mix_packed`): dense (W, W) matrices for
``mixing="dense"`` (gossip's per-event masked operators included) and
`GroupedOperator`s for ``two_stage`` / ``ppermute``; ``overlap="chunked"``
launches it once per column chunk.  The production harness
(`repro_torch.launch.harness`) executes plans on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packing, prng, protocol
from repro_torch.core.hierarchy import MLLSchedule, MultiLevelNetwork
from repro_torch.core.simulator import SimConfig, _check_kernel, \
    _check_overlap, apply_operator, evaluate, init_sim_carry, replicate, \
    to_device, weighted_average
from repro_torch.tree import tree_leaves, tree_map, tree_structure, \
    tree_unflatten

Tree = Any

RATE_MODELS = ("bernoulli", "deterministic", "measured")


# ------------------------------------------------------------ slot accounting
def barrier_round_slots(rng: np.random.Generator, rates: np.ndarray, tau: int,
                        rounds: int) -> np.ndarray:
    """Slots consumed per synchronous round when every worker must take tau
    gradient steps (Local SGD / HL-SGD semantics): per worker the slot count
    is a negative-binomial(tau, p_i) sample; the round costs the max over
    workers.  Canonical implementation (the `"barrier"` policy draws these
    exact values)."""
    out = np.empty(rounds, dtype=np.int64)
    for r in range(rounds):
        # number of Bernoulli(p) trials until tau successes
        trials = rng.negative_binomial(tau, rates) + tau
        out[r] = trials.max()
    return out


def mll_round_slots(tau: int, rounds: int) -> np.ndarray:
    """MLL-SGD / `"deadline"` rounds always cost exactly tau slots."""
    return np.full(rounds, tau, dtype=np.int64)


def _round_trials(rng: np.random.Generator | None, rates: np.ndarray,
                  tau: int, rate_model: str) -> np.ndarray:
    """Per-worker slots needed for tau gradient steps under the rate model.

    ``"measured"`` is the ``"deterministic"`` staircase with rates that came
    from a profiled `RateCalibration` instead of hand-fed p_i — the draw-free
    1/p_i spacing is exactly what a measured seconds-per-step ratio means.
    """
    if rate_model in ("deterministic", "measured"):
        return np.ceil(tau / np.asarray(rates)).astype(np.int64)
    return rng.negative_binomial(tau, rates) + tau


# --------------------------------------------------- measured rate calibration
@dataclasses.dataclass(frozen=True)
class RateCalibration:
    """Per-worker rates measured from profiled step times, not hand-fed p_i.

    ``step_times[i]`` is worker i's measured seconds per local gradient step
    (warmup timing pass; see `launch.harness.measure_worker_rates`).  The
    induced rate is relative to the fastest worker: p_i = min_j t_j / t_i,
    so the fastest worker advances every slot and a 2x-slower worker every
    other slot — the ``"measured"`` rate model's deterministic staircase.
    """
    step_times: tuple[float, ...]

    def __post_init__(self):
        if not self.step_times or any(t <= 0 for t in self.step_times):
            raise ValueError("calibration needs one positive step time per "
                             f"worker, got {self.step_times!r}")

    @property
    def rates(self) -> np.ndarray:
        t = np.asarray(self.step_times, np.float64)
        return t.min() / t

    def to_json(self) -> dict:
        return {"schema": "mll-rate-calibration/v1",
                "step_times": [float(t) for t in self.step_times],
                "rates": [float(r) for r in self.rates]}

    @staticmethod
    def from_json(d: dict) -> "RateCalibration":
        return RateCalibration(step_times=tuple(float(t)
                                                for t in d["step_times"]))

    def save(self, path: str) -> str:
        import json
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return path

    @staticmethod
    def load(path: str) -> "RateCalibration":
        import json
        with open(path) as f:
            return RateCalibration.from_json(json.load(f))


def network_with_rates(network: MultiLevelNetwork,
                       rates: np.ndarray) -> MultiLevelNetwork:
    """The same network with worker_rates replaced (e.g. by a
    `RateCalibration`'s measured rates); validation re-runs via build-time
    invariants on the replaced field."""
    rates = np.asarray(rates, np.float64)
    if rates.shape != (network.num_workers,):
        raise ValueError(f"need {network.num_workers} rates, got {rates.shape}")
    if not np.all((rates > 0) & (rates <= 1.0)):
        raise ValueError("measured rates must land in (0, 1] — normalize "
                         "step times against the fastest worker")
    return dataclasses.replace(network, worker_rates=rates)


# ------------------------------------------------------------- plan structures
@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    """One averaging round firing on the slot clock (slot is 1-based: the
    round fires at the END of that slot, after its gradient step)."""
    slot: int
    kind: str                       # "subnet" | "hub"
    participants: tuple[int, ...]   # subnet ids taking part
    round_index: int                # per-policy round counter


@dataclasses.dataclass
class TimelinePlan:
    """Host-side bookkeeping a ReadinessPolicy emits; the executor replays it.

    ``active[s, i]`` = 1 when worker i applies a gradient step during slot s;
    under ``gate_mode="bernoulli"`` it is additionally multiplied by the
    in-scan Bernoulli(p_i) draw (the lock-step simulator's gate), under
    ``"forced"`` it is the gate (progress was already drawn host-side).
    ``op_ids[s]`` selects the strategy operator at slot s (0 = I, 1 = V,
    2 = Z); policies mixing a strict subset instead put a composed dense
    (W, W) operator in ``op_mats[s]`` and leave ``op_ids`` zero.

    ``busy_slots``/``idle_slots`` are realized per-worker counts for
    ``"forced"`` plans; under ``gate_mode="bernoulli"`` the progress draws
    happen inside the scan, so ``busy_slots`` is the EXPECTED count (the
    realized one rides the carry as ``opt_state["counts"]``).
    """
    slots: int
    active: np.ndarray                       # (L, W) float32
    op_ids: np.ndarray                       # (L,) int32
    gate_mode: str                           # "bernoulli" | "forced"
    events: list[TimelineEvent]
    busy_slots: np.ndarray                   # (W,) slots spent making progress
    idle_slots: np.ndarray                   # (W,) slots blocked at a barrier
    round_costs: np.ndarray                  # slots per completed global round
    rounds_completed: int
    op_mats: dict[int, np.ndarray] | None = None   # slot -> (W, W) operator
    subnet_round_costs: list[list[int]] | None = None

    @property
    def slots_used(self) -> int:
        """Wall-clock slots consumed by completed rounds.  Rounds are
        sequential per sub-network, so overlapping-round policies report the
        busiest sub-network's clock; for global-round policies this is the
        legacy budget-loop's `used` (sum of round costs)."""
        if self.subnet_round_costs is not None:
            return max((sum(c) for c in self.subnet_round_costs), default=0)
        return int(self.round_costs.sum())


# ----------------------------------------------------------- policy registry
class ReadinessPolicy:
    """When do V and Z rounds fire on the slot clock?

    Subclasses implement ``plan`` producing a `TimelinePlan` for a network +
    (tau, q) schedule + slot budget.  ``needs_dense`` marks policies whose
    events mix a strict subset of workers and therefore execute through
    per-slot dense operators (``mixing="dense"`` only).
    """
    name: str = "?"
    needs_dense: bool = False

    def plan(self, network: MultiLevelNetwork, schedule: MLLSchedule,
             slots: int, rng: np.random.Generator, *,
             rate_model: str = "bernoulli") -> TimelinePlan:
        raise NotImplementedError


POLICY_REGISTRY: dict[str, type[ReadinessPolicy]] = {}


def register_policy(name: str) -> Callable[[type[ReadinessPolicy]],
                                           type[ReadinessPolicy]]:
    def deco(cls: type[ReadinessPolicy]) -> type[ReadinessPolicy]:
        cls.name = name
        POLICY_REGISTRY[name] = cls
        return cls
    return deco


def get_policy(name: str) -> ReadinessPolicy:
    try:
        cls = POLICY_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown readiness policy {name!r}; registered: "
                         f"{available_policies()}") from None
    return cls()


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(POLICY_REGISTRY))


def _check_rate_model(rate_model: str) -> None:
    if rate_model not in RATE_MODELS:
        raise ValueError(f"unknown rate model {rate_model!r}; "
                         f"expected one of {RATE_MODELS}")


# ------------------------------------------------------------------- policies
@register_policy("barrier")
class GlobalBarrierPolicy(ReadinessPolicy):
    """Local SGD / HL-SGD wall-clock semantics: one global round at a time.

    Every worker must take tau gradient steps before the round's averaging
    (V, or Z on each q-th round) fires; the round costs the max over workers
    of their NegBin(tau, p_i) slot count, drawn with the exact calls of the
    legacy `barrier_round_slots` so accounting matches draw-for-draw on a
    shared Generator.  Workers place their tau steps in the round's first
    tau slots (the trajectory only depends on the steps happening before
    the barrier) and idle for the rest.
    """

    def plan(self, network, schedule, slots, rng, *, rate_model="bernoulli"):
        _check_rate_model(rate_model)
        n = network.num_workers
        tau, q = schedule.tau, schedule.q
        rates = np.asarray(network.worker_rates)
        all_subnets = tuple(range(network.num_subnets))
        active = np.zeros((slots, n), np.float32)
        op_ids = np.zeros(slots, np.int32)
        busy = np.zeros(n, np.int64)
        idle = np.zeros(n, np.int64)
        events: list[TimelineEvent] = []
        costs: list[int] = []
        used = 0
        r = 0
        while True:
            trials = _round_trials(rng, rates, tau, rate_model)
            cost = int(trials.max())
            if used + cost > slots:
                break
            active[used:used + tau, :] = 1.0
            r += 1
            kind = "hub" if r % q == 0 else "subnet"
            op_ids[used + cost - 1] = (protocol.PHASE_HUB if kind == "hub"
                                       else protocol.PHASE_SUBNET)
            events.append(TimelineEvent(used + cost, kind, all_subnets, r))
            busy += trials
            idle += cost - trials
            costs.append(cost)
            used += cost
        return TimelinePlan(slots=slots, active=active, op_ids=op_ids,
                            gate_mode="forced", events=events,
                            busy_slots=busy, idle_slots=idle,
                            round_costs=np.asarray(costs, np.int64),
                            rounds_completed=r)


@register_policy("deadline")
class FixedDeadlinePolicy(ReadinessPolicy):
    """The paper's MLL-SGD timing: averaging at fixed wall-clock deadlines.

    V fires every tau slots and Z every q*tau slots (Eq. 6 with k = the slot
    index); workers contribute whatever gradient steps their rate allowed —
    nobody waits, every round costs exactly tau slots (`mll_round_slots`).
    Under the Bernoulli rate model this is tick-for-tick the lock-step
    simulator (`simulator.simulate`), whose in-scan gate does the progress
    draws; the deterministic rate model forces a 1/p_i staircase instead.
    """

    def plan(self, network, schedule, slots, rng, *, rate_model="bernoulli"):
        _check_rate_model(rate_model)
        n = network.num_workers
        tau, q = schedule.tau, schedule.q
        all_subnets = tuple(range(network.num_subnets))
        if rate_model in ("deterministic", "measured"):
            # worker i steps on slots where floor((s+1) p) > floor(s p)
            s = np.arange(slots + 1)[:, None]
            p = np.asarray(network.worker_rates)[None, :]
            stair = np.floor(s * p)
            active = (stair[1:] > stair[:-1]).astype(np.float32)
            gate_mode = "forced"
        else:
            active = np.ones((slots, n), np.float32)
            gate_mode = "bernoulli"
        op_ids = np.zeros(slots, np.int32)
        events: list[TimelineEvent] = []
        r = 0
        for s in range(tau, slots + 1, tau):
            r += 1
            kind = "hub" if s % (q * tau) == 0 else "subnet"
            op_ids[s - 1] = (protocol.PHASE_HUB if kind == "hub"
                             else protocol.PHASE_SUBNET)
            events.append(TimelineEvent(s, kind, all_subnets, r))
        busy = active.sum(axis=0).astype(np.int64) if gate_mode == "forced" \
            else np.round(slots * np.asarray(network.worker_rates)
                          ).astype(np.int64)   # expected under Bernoulli
        return TimelinePlan(slots=slots, active=active, op_ids=op_ids,
                            gate_mode=gate_mode, events=events,
                            busy_slots=busy,
                            idle_slots=np.zeros(n, np.int64),
                            round_costs=mll_round_slots(tau, r),
                            rounds_completed=r)


def _subnet_v_matrix(network: MultiLevelNetwork, d: int) -> np.ndarray:
    """V restricted to sub-network d: its block from the full V, identity
    elsewhere (other subnets keep running — rounds overlap)."""
    n = network.num_workers
    idx = np.nonzero(network.subnet_of == d)[0]
    t = np.eye(n)
    t[np.ix_(idx, idx)] = network.v[idx][:, None]
    return t


def _partial_z_matrix(network: MultiLevelNetwork,
                      ready: tuple[int, ...]) -> np.ndarray:
    """Z restricted to the ready hubs: H's columns renormalized over the
    ready set (H[:, e] has positive diagonal, so the renormalization is
    well-defined), composed with each ready subnet's internal averaging —
    the partial-gossip analogue of Z_ij = H_{d(i),d(j)} v_i.  Workers of
    non-ready hubs are untouched (identity)."""
    n = network.num_workers
    h = network.hub_net.h
    v = network.v
    sub = network.subnet_of
    ready_set = set(int(e) for e in ready)
    hn = np.zeros_like(h)
    idx = sorted(ready_set)
    for e in idx:
        denom = sum(h[f, e] for f in idx)
        for f in idx:
            hn[f, e] = h[f, e] / denom
    t = np.eye(n)
    in_ready = np.isin(sub, idx)
    for j in np.nonzero(in_ready)[0]:
        col = hn[sub, sub[j]] * v * in_ready
        t[:, j] = col
    return t


@register_policy("gossip")
class NeighborReadyGossipPolicy(ReadinessPolicy):
    """Neighbor-ready partial gossip: fully overlapping subnet rounds.

    Each sub-network d runs its OWN tau-step barrier: its round completes
    when all of d's workers took tau steps (max NegBin over d's workers
    only) and fires a V round restricted to d — other subnets never wait.
    After q V-rounds hub d becomes gossip-ready; at the end of any slot
    where a ready hub has at least one ready neighbor, the ready
    neighborhood gossips over the ready-restricted, column-renormalized H
    and their readiness resets.  A ready hub with no ready neighbor keeps
    training (readiness is sticky, never blocking).

    All events mix strict subsets of workers, so execution goes through
    per-slot dense operators at full precision (compressed-wire strategies
    keep their format for full V/Z rounds only).
    """
    needs_dense = True

    def plan(self, network, schedule, slots, rng, *, rate_model="bernoulli"):
        _check_rate_model(rate_model)
        n = network.num_workers
        tau, q = schedule.tau, schedule.q
        nd = network.num_subnets
        rates = np.asarray(network.worker_rates)
        subnet_workers = [np.nonzero(network.subnet_of == d)[0]
                          for d in range(nd)]
        v_mats = [_subnet_v_matrix(network, d) for d in range(nd)]

        active = np.zeros((slots, n), np.float32)
        op_mats: dict[int, np.ndarray] = {}
        events: list[TimelineEvent] = []
        busy = np.zeros(n, np.int64)
        idle = np.zeros(n, np.int64)
        subnet_costs: list[list[int]] = [[] for _ in range(nd)]
        v_done = np.zeros(nd, np.int64)
        pending = np.zeros(nd, bool)
        hub_rounds = 0
        start = np.zeros(nd, np.int64)
        end = np.zeros(nd, np.int64)

        def begin_round(d: int, s: int) -> None:
            w = subnet_workers[d]
            trials = _round_trials(rng, rates[w], tau, rate_model)
            cost = int(trials.max())
            start[d], end[d] = s, s + cost
            hi = min(s + tau, slots)
            active[s:hi, w] = 1.0
            span = min(cost, slots - s)      # accounting clipped to budget
            busy[w] += np.minimum(trials, span)
            idle[w] += np.maximum(span - trials, 0)

        for d in range(nd):
            begin_round(d, 0)
        for s in range(slots):
            fired: list[np.ndarray] = []
            completed = [d for d in range(nd) if end[d] == s + 1]
            for d in completed:
                subnet_costs[d].append(int(end[d] - start[d]))
                v_done[d] += 1
                fired.append(v_mats[d])
                events.append(TimelineEvent(s + 1, "subnet", (d,),
                                            int(v_done[d])))
                if v_done[d] % q == 0:
                    pending[d] = True
            for d in range(nd):
                if pending[d]:
                    ready_nbrs = [int(e) for e in network.hub_net.neighbors(d)
                                  if pending[e]]
                    if ready_nbrs:
                        group = tuple(sorted({d, *ready_nbrs}))
                        hub_rounds += 1
                        fired.append(_partial_z_matrix(network, group))
                        events.append(TimelineEvent(s + 1, "hub", group,
                                                    hub_rounds))
                        for e in group:
                            pending[e] = False
            for d in completed:
                if s + 1 < slots:
                    begin_round(d, s + 1)
            if fired:
                mat = fired[0]
                for f in fired[1:]:
                    mat = mat @ f       # X (T1 T2) = (X T1) T2
                op_mats[s] = mat.astype(np.float32)

        flat_costs = [c for per in subnet_costs for c in per]
        return TimelinePlan(slots=slots, active=active,
                            op_ids=np.zeros(slots, np.int32),
                            gate_mode="forced", events=events,
                            busy_slots=busy, idle_slots=idle,
                            round_costs=np.asarray(flat_costs, np.int64),
                            rounds_completed=int(v_done.sum()),
                            op_mats=op_mats, subnet_round_costs=subnet_costs)


# ---------------------------------------------------------------- execution
def apply_event_operator(stacked: Tree, op: torch.Tensor) -> Tree:
    """Per-event dense (W, W) operator with the engine's dtype semantics:
    all-f32 trees take `simulator.apply_operator` (a new tree; the packed
    flat path where `packing.flat_paths_enabled`); other trees mix each
    leaf in its OWN dtype, in place (an f32 product would promote bf16
    params).  The one implementation the event executor and the production
    `train_step.mll_harness_step` share."""
    if packing.all_f32(stacked):
        return apply_operator(stacked, op)
    return protocol._einsum_operator(op, stacked, None)


def _chunkwise(ins: list[Tree], num_chunks: int,
               fn: Callable[..., torch.Tensor], out: Tree | None) -> Tree:
    """The packed-buffer column chunks of ``ins`` (trees of one layout)
    one at a time: for each `packing.chunk_views` chunk, the (W, hi - lo)
    float32 slab of every input tree is gathered from the leaf slices the
    chunk spans, ``fn(*slabs)`` maps them to the chunk's (W, hi - lo)
    result, and that is written into those slices of ``out``'s leaves
    (``ins[0]``'s layout; None: new leaves), rounded once to each leaf's
    dtype.  Never more than one chunk is packed at a time, and every
    contraction here reduces over the worker axis only, so the result
    equals the whole-buffer form (`packing.pack`, then ``fn`` per column
    range, then `packing.unpack`) bit for bit."""
    spec = packing.pack_spec(ins[0])
    w = spec.num_workers
    leaves = [tree_leaves(t) for t in ins]
    dst = tree_leaves(out) if out is not None \
        else [torch.empty_like(x) for x in leaves[0]]
    for ch in packing.chunk_views(spec, num_chunks):
        parts = [(i, max(ch.lo, s.offset) - s.offset,
                  min(ch.hi, s.offset + s.size) - s.offset)
                 for i, s in enumerate(spec.slots)
                 if s.offset < ch.hi and ch.lo < s.offset + s.size]
        slabs = [torch.cat([ls[i].reshape(w, -1)[:, a:b].float()
                            for i, a, b in parts], dim=1) for ls in leaves]
        y = fn(*slabs)
        del slabs
        col = 0
        for i, a, b in parts:
            dst[i].view(w, -1)[:, a:b].copy_(y[:, col:col + b - a])
            col += b - a
        del y
    return out if out is not None else tree_unflatten(spec.treedef, dst)


def chunked_update_mix(stacked: Tree, grads: Tree, op: torch.Tensor,
                       theta: torch.Tensor, eta: float,
                       num_chunks: int) -> Tree:
    """Torch chunked fused update + mix: the ``overlap="chunked"`` event
    body of ``kernel="xla"`` (a new tree).

    For each column chunk of the packed layout (`packing.chunk_views`,
    gathered one chunk at a time by `_chunkwise`) the gated SGD update
    u_c = x_c - (eta*theta)*g_c and the contraction y_c = T^T u_c run as
    one unit (with ``kernel="pallas"`` the analogous
    `kernels.ops.hier_mix_packed_chunked` launches the kernel per chunk).

    Against ``overlap="none"`` this differs in two documented ways, so the
    two agree to float32 tolerance (1e-6), not bit for bit: the mix
    contracts the PACKED columns (one product per chunk) instead of one
    per leaf, and structured strategies run their equal dense (W, W)
    operator (st.v_op / st.z_op) instead of the grouped mean-then-roll
    form.  The update replicates the kernel's arithmetic (f32,
    ``(eta * theta) * g`` grouping, one rounding to the leaf dtype)."""
    dev = tree_leaves(stacked)[0].device
    a = (theta.to(dev, torch.float32) * float(np.float32(eta)))[:, None]
    t = op.to(dev, torch.float32)
    return _chunkwise([stacked, grads], num_chunks,
                      lambda x, g: torch.einsum("ij,ic->jc", t, x - a * g),
                      None)


def chunked_apply_operator(stacked: Tree, op: torch.Tensor,
                           num_chunks: int, *, out: Tree | None = None
                           ) -> Tree:
    """Mix-only chunked path: the dense (W, W) operator contracts the
    packed columns one chunk at a time (no fused update; `_chunkwise`).
    ``out=stacked`` mixes in place (the production harness: its fleet
    has no room for a second copy); by default the result is a new tree.
    Carries `chunked_update_mix`'s reduction-order contract: agrees with
    ``overlap="none"`` to float32 tolerance, not bit for bit."""
    t = op.to(tree_leaves(stacked)[0].device, torch.float32)
    return _chunkwise([stacked], num_chunks,
                      lambda x: torch.einsum("ij,ic->jc", t, x), out)


def _pallas_opt_state(opt_state: Tree, theta: torch.Tensor) -> Tree:
    """Engine-owned bookkeeping for the kernel path: the fused kernel owns
    the parameter update, but the per-worker step counts advance exactly
    as `protocol.gated_inner_update` would."""
    counts = opt_state["counts"]
    return {"inner": opt_state["inner"],
            "counts": counts + (theta != 0).to(counts.device, torch.int32)}


def _slot_parts(loss_fn, network: MultiLevelNetwork, cfg: SimConfig, *,
                gate_mode: str):
    """Shared per-slot machinery: the gradient/gate sampler (the JAX
    package's PRNG consumption, so every executor built from it follows
    the reference's draws) and the local (mixing-free) update."""
    if gate_mode not in ("bernoulli", "forced"):
        raise ValueError(f"unknown gate_mode {gate_mode!r}")
    n = network.num_workers
    p_rates = np.asarray(network.worker_rates, np.float32)
    optimizer = protocol.resolve_inner_optimizer(cfg)
    eta = float(np.float32(cfg.eta))

    def sample(stacked, key, data, act):
        """(grads, theta, key') for one slot -- the reference's draws:
        ``key, kb, kg = split(key, 3)``, per-worker batch keys
        ``split(kb, n)``, ``randint`` batch indices per worker, then the
        gate ``uniform(kg, (n,)) < p``.  Per-worker gradients are a loop
        over the workers with `torch.autograd.grad` (the flash-attention
        kernel has no vmap rule); they are written into one stacked tree
        in the params' dtypes."""
        key, kb, kg = prng.split(key, 3)
        structure = tree_structure(stacked)
        params = tree_leaves(stacked)
        grads = [torch.empty_like(x) for x in params]
        first = tree_leaves(data)[0]
        # every worker's batch indices, sent to the device in one copy
        idx = torch.from_numpy(np.stack([
            prng.randint(wkey, cfg.batch_size, 0, first.shape[1])
            for wkey in prng.split(kb, n)]).astype(np.int64)).to(first.device)
        for i in range(n):
            batch = tree_map(lambda x: x[i][idx[i]], data)
            wp = [x[i].detach().requires_grad_() for x in params]
            with torch.enable_grad():
                loss = loss_fn(tree_unflatten(structure, wp), batch)
                gs = torch.autograd.grad(loss, wp, allow_unused=True)
            with torch.no_grad():
                for dst, gi in zip(grads, gs):
                    if gi is None:
                        dst[i].zero_()
                    else:
                        dst[i].copy_(gi)
            del loss, gs, wp
        draw = (prng.uniform(kg, n) < p_rates).astype(np.float32)
        act = np.asarray(act, np.float32)
        theta = draw * act if gate_mode == "bernoulli" else act
        return (tree_unflatten(structure, grads), torch.from_numpy(theta),
                key)

    @torch.no_grad()
    def local_update(stacked, opt_state, grads, theta):
        """Gated inner update only -- the event-free slot body, in place.
        The kernel backend replicates the kernel's arithmetic exactly
        (f32, ``(eta * theta) * g`` grouping, one rounding to the leaf
        dtype) so that skipping the identity contraction is bit-for-bit
        invisible."""
        if cfg.kernel == "pallas":
            a = theta.to(tree_leaves(stacked)[0].device,
                         torch.float32) * eta

            def upd(x, g):
                gate = a.reshape(a.shape + (1,) * (x.dim() - 1))
                return x.copy_((x.float() - gate * g.float()).to(x.dtype))

            stacked = tree_map(upd, stacked, grads)
            return stacked, _pallas_opt_state(opt_state, theta)
        return protocol.gated_inner_update(optimizer, stacked, opt_state,
                                           grads, theta)

    return sample, local_update, optimizer


def make_timeline_step_fn(loss_fn: Callable[[Tree, Tree], torch.Tensor],
                          network: MultiLevelNetwork, cfg: SimConfig, *,
                          gate_mode: str, pallas_packed: bool | None = None,
                          device: str | torch.device | None = None):
    """Full (every-slot) scan, the lock-step reference executor (and the
    ``exec_mode="full"`` baseline): every slot samples, updates and applies
    its operator -- the identity at local slots -- with a per-slot
    ``active`` mask multiplying (bernoulli) or replacing (forced) the gate.

    Signature: ``scan_slots(carry, data, ops, active) -> carry`` where
    ``ops`` is (L,) int op ids, ``active`` (L, W), and ``carry`` the
    simulator's (`init_sim_carry`) layout.  With ``kernel="pallas"`` every
    slot launches the fused kernel: packed (K1 over the (W, sum C) buffer,
    one launch a slot) or per leaf (one launch per leaf) as
    ``pallas_packed`` says; None follows `packing.flat_paths_enabled`
    (packed on the card).  Both give the same bits.  ``device`` holds the
    operators (default ``cuda``).
    """
    _check_kernel(cfg)
    if cfg.overlap != "none":
        raise ValueError(
            "overlap='chunked' is an event-executor optimisation (chunked "
            "mixing at plan events); the full every-slot scan has no "
            "chunked form -- use exec_mode='event' or overlap='none'")
    device = resolve_device(device)
    if pallas_packed is None:
        pallas_packed = packing.flat_paths_enabled(device)
    n = network.num_workers
    st = protocol.state_from_network(network, device=device)
    strategy = protocol.resolve_mixing(cfg)
    sample, _, optimizer = _slot_parts(loss_fn, network, cfg,
                                       gate_mode=gate_mode)
    if cfg.kernel == "pallas":
        from repro_torch.kernels import ops as kops
        operators = [torch.eye(n, dtype=torch.float32, device=device),
                     st.v_op, st.z_op]
        mix = kops.hier_mix_packed if pallas_packed else kops.hier_mix_pytree

    def scan_slots(carry, data, ops, active):
        stacked, opt_state, mix_state, key = carry
        for op, act in zip(np.asarray(ops), np.asarray(active)):
            grads, theta, key = sample(stacked, key, data, act)
            if cfg.kernel == "pallas":
                stacked = mix(stacked, grads, operators[int(op)], theta,
                              cfg.eta)
                opt_state = _pallas_opt_state(opt_state, theta)
            else:
                stacked, opt_state = protocol.gated_inner_update(
                    optimizer, stacked, opt_state, grads, theta)
                stacked, mix_state = protocol.schedule_mix(
                    strategy, stacked, mix_state, 0, st, 1, 1,
                    static_phase=int(op))
            del grads
        return (stacked, opt_state, mix_state, key)

    return scan_slots


class EventExecutor:
    """Event-sparse slot execution: local-only slots run ONLY the gated
    inner update (no operator contraction); mixing runs once per event
    with its operator known ahead.

    Built from the same per-slot sampler as the full scan, so a plan
    executed event-sparsely gives the bit-for-bit identical trajectory:
    every slot consumes the same draws and applies the same update; only
    the identity contractions disappear.  Local runs go in power-of-two
    segments, as in the JAX package (where they bound recompilation).
    With ``kernel="pallas"`` events launch the fused kernel over the
    packed buffer (`kernels.ops.hier_mix_packed`, or
    `hier_mix_packed_chunked` under ``overlap="chunked"``): dense (W, W)
    operators for ``mixing="dense"`` (per-event masked gossip matrices
    included) and `GroupedOperator`s for ``two_stage`` / ``ppermute``
    (whose hub matrix must be circulant).  ``device`` holds the operators
    (default ``cuda``).
    """

    def __init__(self, loss_fn, network: MultiLevelNetwork, cfg: SimConfig,
                 *, gate_mode: str, device: str | torch.device | None = None):
        _check_kernel(cfg, structured_ok=True)
        _check_overlap(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.st = protocol.state_from_network(network, device=device)
        if cfg.overlap == "chunked" and cfg.kernel != "pallas":
            # chunked torch events contract the dense (W, W) operator per
            # column chunk; structured strategies map to their dense forms
            self._phase_dense = {protocol.PHASE_SUBNET: self.st.v_op,
                                 protocol.PHASE_HUB: self.st.z_op}
        self.strategy = protocol.resolve_mixing(cfg)
        self._sample, self._local_update, self.optimizer = _slot_parts(
            loss_fn, network, cfg, gate_mode=gate_mode)
        if cfg.kernel == "pallas":
            from repro_torch.kernels import ops as kops
            self._kops = kops
            if cfg.mixing == "dense":
                self._phase_ops = {protocol.PHASE_SUBNET: self.st.v_op,
                                   protocol.PHASE_HUB: self.st.z_op}
            else:           # two_stage / ppermute: fused structured operators
                if cfg.mixing == "ppermute":
                    protocol._circulant_coeffs(self.st)   # validate H
                self._phase_ops = {
                    protocol.PHASE_SUBNET: kops.make_grouped_operator(
                        network.subnet_of, network.v, device=device),
                    protocol.PHASE_HUB: kops.make_grouped_operator(
                        network.subnet_of, network.v, h=network.hub_net.h,
                        device=device),
                }
        self.step_phase = {
            ph: (lambda carry, data, act, ph=ph:
                 self._step(carry, data, act, ph))
            for ph in (protocol.PHASE_SUBNET, protocol.PHASE_HUB)}

    def scan_local(self, carry, data, active):
        """Local-only slots, one per row of ``active``."""
        stacked, opt_state, mix_state, key = carry
        for act in np.asarray(active):
            grads, theta, key = self._sample(stacked, key, data, act)
            stacked, opt_state = self._local_update(stacked, opt_state,
                                                    grads, theta)
            del grads
        return (stacked, opt_state, mix_state, key)

    def _mix_event(self, stacked, opt_state, mix_state, grads, theta, op):
        """``op``: a phase id, or a dense (W, W) tensor (gossip), or (with
        the kernel) the phase's operator."""
        cfg = self.cfg
        if cfg.kernel == "pallas":
            if cfg.overlap == "chunked":
                stacked = self._kops.hier_mix_packed_chunked(
                    stacked, grads, op, theta, cfg.eta,
                    num_chunks=cfg.overlap_chunks)
            else:
                stacked = self._kops.hier_mix_packed(stacked, grads, op,
                                                     theta, cfg.eta)
            return stacked, _pallas_opt_state(opt_state, theta), mix_state
        if cfg.overlap == "chunked":
            op_mat = op if isinstance(op, torch.Tensor) \
                else self._phase_dense[op]
            stacked = chunked_update_mix(stacked, grads, op_mat, theta,
                                         cfg.eta, cfg.overlap_chunks)
            return stacked, _pallas_opt_state(opt_state, theta), mix_state
        stacked, opt_state = protocol.gated_inner_update(
            self.optimizer, stacked, opt_state, grads, theta)
        if isinstance(op, torch.Tensor):
            stacked = apply_event_operator(stacked, op)
        elif op == protocol.PHASE_SUBNET:
            stacked, mix_state = self.strategy.subnet_with_state(
                stacked, self.st, mix_state)
        else:
            stacked, mix_state = self.strategy.hub_with_state(
                stacked, self.st, mix_state)
        return stacked, opt_state, mix_state

    def _step(self, carry, data, act, op):
        stacked, opt_state, mix_state, key = carry
        grads, theta, key = self._sample(stacked, key, data, act)
        if self.cfg.kernel == "pallas" and not isinstance(op, torch.Tensor):
            op = self._phase_ops[op]
        stacked, opt_state, mix_state = self._mix_event(
            stacked, opt_state, mix_state, grads, theta, op)
        return (stacked, opt_state, mix_state, key)

    def step_dense(self, carry, data, act, t: torch.Tensor):
        """One event slot with a dense (W, W) operator (gossip)."""
        return self._step(carry, data, act, t)

    def run(self, carry, data, plan: TimelinePlan, lo: int, hi: int):
        """Execute slots [lo, hi) of the plan event-sparsely."""
        op_mats = plan.op_mats or {}
        device = self.st.v_op.device
        s = lo
        while s < hi:
            e = s
            while e < hi and plan.op_ids[e] == 0 and e not in op_mats:
                e += 1
            run = e - s                       # local-only slots [s, e)
            off = s
            while run:
                k = 1 << (run.bit_length() - 1)   # pow2 segments
                carry = self.scan_local(carry, data,
                                        plan.active[off:off + k])
                off += k
                run -= k
            if e < hi:
                act = plan.active[e]
                if e in op_mats:
                    carry = self.step_dense(carry, data, act, torch.as_tensor(
                        op_mats[e], dtype=torch.float32, device=device))
                else:
                    carry = self.step_phase[int(plan.op_ids[e])](
                        carry, data, act)
            s = e + 1
        return carry


# ------------------------------------------------------------- event traces
TRACE_SCHEMA = "mll-timeline-trace/v1"


def plan_trace(plan: TimelinePlan, **meta: Any) -> dict:
    """The canonical event-trace document for a `TimelinePlan`.

    One schema for every engine consumer: the simulator's `run_timeline`
    plans and the production harness (`launch.harness`) emit identical
    documents, so `benchmarks/` and the nightly gate read either without
    caring which executor produced it.  ``meta`` (policy, rate_model,
    calibration, ...) is merged under ``"meta"``.
    """
    return {
        "schema": TRACE_SCHEMA,
        "slots": int(plan.slots),
        "slots_used": int(plan.slots_used),
        "rounds_completed": int(plan.rounds_completed),
        "gate_mode": plan.gate_mode,
        "busy_slots": [int(b) for b in plan.busy_slots],
        "idle_slots": [int(i) for i in plan.idle_slots],
        "round_costs": [int(c) for c in plan.round_costs],
        "events": [{"slot": int(e.slot), "kind": e.kind,
                    "participants": [int(p) for p in e.participants],
                    "round_index": int(e.round_index)}
                   for e in plan.events],
        "meta": meta,
    }


def export_trace(path: str, plan: TimelinePlan, **meta: Any) -> str:
    """Write `plan_trace` as JSON; returns the path."""
    import json
    with open(path, "w") as f:
        json.dump(plan_trace(plan, **meta), f, indent=2)
    return path


def load_trace(path: str) -> dict:
    """Read a trace document back, validating the schema tag."""
    import json
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"{path}: not a {TRACE_SCHEMA} document "
                         f"(schema={doc.get('schema')!r})")
    return doc


@dataclasses.dataclass
class TimelineResult:
    slots: np.ndarray             # eval slot indices (1-based, inclusive)
    train_loss: np.ndarray        # F(u) on the full training set
    test_acc: np.ndarray
    final_avg_params: Tree
    plan: TimelinePlan


def run_timeline(loss_fn: Callable[[Tree, Tree], torch.Tensor],
                 accuracy_fn: Callable[[Tree, Tree], torch.Tensor],
                 init_params: Tree,
                 worker_data: Tree,
                 eval_data: Tree,
                 test_data: Tree,
                 network: MultiLevelNetwork,
                 schedule: MLLSchedule,
                 *,
                 slots: int,
                 policy: str | ReadinessPolicy = "barrier",
                 cfg: SimConfig = SimConfig(),
                 seed: int = 0,
                 policy_rng: np.random.Generator | None = None,
                 rate_model: str = "bernoulli",
                 exec_mode: str = "event",
                 device: str | torch.device | None = None) -> TimelineResult:
    """Run the network against the slot clock for `slots` slots.

    ``policy_rng`` drives the policy's host-side progress draws (defaults
    to ``np.random.default_rng(seed)``).  ``seed`` also seeds the per-slot
    draws (minibatch sampling + Bernoulli gate), `simulator.simulate`'s
    stream.  Evaluates u every `cfg.eval_every` slots.  The params and data
    are moved to ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``).

    ``exec_mode="event"`` (default) runs the event-sparse executor;
    ``exec_mode="full"`` the every-slot scan (op-id plans only -- policies
    that emit per-slot dense matrices have no full-scan form).  Both give
    the same bits.
    """
    device = resolve_device(device)
    pol = get_policy(policy) if isinstance(policy, str) else policy
    rng = policy_rng if policy_rng is not None else np.random.default_rng(seed)
    plan = pol.plan(network, schedule, slots, rng, rate_model=rate_model)
    n = network.num_workers
    a = torch.as_tensor(np.asarray(network.a), dtype=torch.float32,
                        device=device)
    worker_data, eval_data, test_data = (
        to_device(t, device) for t in (worker_data, eval_data, test_data))
    stacked = replicate(to_device(init_params, device), n)
    carry = init_sim_carry(stacked, cfg, seed)
    dense = pol.needs_dense or plan.op_mats is not None
    # Partial-participation events (gossip) run as per-event masked dense
    # operators whatever cfg.mixing says; full V/Z rounds (op-id events)
    # use the strategy.
    if exec_mode == "full":
        if dense:
            raise ValueError(
                "exec_mode='full' only supports op-id plans: the dense "
                "identity-padded (L, W, W) operator stack was removed in "
                "favour of event-sparse execution")
        scan_slots = make_timeline_step_fn(loss_fn, network, cfg,
                                           gate_mode=plan.gate_mode,
                                           device=device)
    elif exec_mode == "event":
        executor = EventExecutor(loss_fn, network, cfg,
                                 gate_mode=plan.gate_mode, device=device)
    else:
        raise ValueError(f"unknown exec_mode {exec_mode!r}; "
                         f"expected 'event' or 'full'")

    rec_slots, rec_loss, rec_acc = [], [], []
    done = 0
    while done < slots:
        chunk = min(cfg.eval_every, slots - done)
        if exec_mode == "full":
            carry = scan_slots(carry, worker_data,
                               plan.op_ids[done:done + chunk],
                               plan.active[done:done + chunk])
        else:
            carry = executor.run(carry, worker_data, plan, done, done + chunk)
        done += chunk
        u = weighted_average(carry[0], a)
        rec_slots.append(done)
        rec_loss.append(evaluate(loss_fn, u, eval_data))
        rec_acc.append(evaluate(accuracy_fn, u, test_data))
    u = weighted_average(carry[0], a)
    return TimelineResult(np.asarray(rec_slots), np.asarray(rec_loss),
                          np.asarray(rec_acc), u, plan)
