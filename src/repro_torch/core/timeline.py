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
``mll-timeline-trace/v1`` document.  The plan executors of the JAX package
(`make_timeline_step_fn`, `EventExecutor`, `run_timeline`, the chunked
paths) are not ported yet (ROADMAP.md Queue 1); the production harness
(`repro_torch.launch.harness`) executes plans on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.core.hierarchy import MLLSchedule, MultiLevelNetwork

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
    """Per-event dense (W, W) operator, in place: each leaf mixes in its OWN
    dtype (the operator is cast to it), as the JAX package's
    `apply_event_operator` does for mixed-dtype trees and, for all-float32
    trees, its `apply_operator`."""
    return protocol._einsum_operator(op, stacked, None)


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
