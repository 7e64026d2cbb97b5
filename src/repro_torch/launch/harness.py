"""Plan-driven production trainer (counterpart of
`repro/launch/harness.py`).

A `TimelinePlan` compiled by any registered readiness policy (``barrier`` /
``deadline`` / ``gossip``) is the single execution schedule:

  * **local slots** run the gated per-worker grads + inner-optimizer update
    (`train_step.mll_harness_step` with no mixing),
  * **mixing events** apply the registered strategy's subnet or hub round,
    or a composed per-event dense (W, W) operator (gossip),
  * **all-idle slots** of forced plans fast-forward: the data cursor still
    consumes each slot's draw, but no gradients are computed.

The JAX package jit-compiles power-of-two scans of local slots; PyTorch
runs eagerly, so the port executes the same plan slot by slot.  One batch
is drawn per slot in the same order, so both packages consume the same
data.  ``impl`` selects the attention core as in `models.attention`
(``"flash"``, ``"plain"``, ``"chunked"`` or ``"auto"``, the JAX harness's
choices); the launcher offers ``flash`` and ``plain``.

Beyond the executor, the harness owns the run lifecycle: measured worker
rates (`measure_worker_rates`), full-protocol checkpoints every
``checkpoint_every`` slots (`train.checkpoint.save_state`; a killed run
resumed from its last checkpoint replays the uninterrupted trajectory bit
for bit) and event-trace export (`timeline.plan_trace`).

``overlap="chunked"`` mixes each event's dense (W, W) operator over the
packed columns one chunk at a time (`timeline.chunked_apply_operator`, in
place), as the JAX package's chunked path does.

With ``mesh=`` (a `launch.mesh.Mesh` carrying a ``workers`` axis) every
rank holds and trains only its (W/size, ...) rows of the fleet, and each
mixing event lowers to the strategy's collectives among the ranks
(`core.protocol`'s ``*_spmd`` methods): the paper's communication structure
across process boundaries.  Every rank executes the same plan.  At eval
and checkpoint boundaries u_k is reduced one leaf at a time (each leaf's
rows all-gathered, averaged with the weights a, and freed before the
next: `average_rows`), so u_k and the history are computed exactly as on
one device and are the same on every rank, while no rank holds the whole
fleet; the full train state of a checkpoint is gathered into rank 0's host
memory only (`gather_train_state`, the JAX package's ``device_get``), and
rank 0 writes the checkpoints, which stay readable by a single-process run
and by the JAX package.  The full state trajectory
(params, optimizer state, mixing state), every u_k and every loss equal the
single-device run's bit for bit wherever each sub-network's workers lie on
at most two ranks (`protocol._grouped_spmd_z`).  The ``data`` axis
replicates compute.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives, protocol, timeline
from repro_torch.core.mllsgd import MLLConfig, MLLState
from repro_torch.core.simulator import weighted_average
from repro_torch.data.pipeline import LMBatcher, rng_state
from repro_torch.launch import spans
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.attention import check_impl
from repro_torch.train import checkpoint
from repro_torch.train.train_step import loss_fn, mll_harness_step
from repro_torch.tree import tree_leaves, tree_map

Tree = Any

CALIBRATION_FILE = "calibration.json"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------- rate calibration
def measure_worker_rates(cfg: ArchConfig, params_stacked: Tree,
                         batch: dict, *, reps: int = 3,
                         skew: tuple[float, ...] | None = None,
                         impl: str = "flash") -> timeline.RateCalibration:
    """Warmup timing pass: each worker's seconds per local gradient step
    (one untimed call, then the median of ``reps`` timed calls on its own
    slice of params and batch), as relative rates (fastest = 1.0).  ``skew``
    multiplies the measured times per worker (on one device all workers
    share the silicon, so heterogeneity must be injected to be visible)."""
    lead = tree_leaves(params_stacked)[0]
    w, device = lead.shape[0], lead.device
    if skew is not None and len(skew) != w:
        raise ValueError(f"need {w} skew factors, got {len(skew)}")

    def grad_one(i):
        wp = tree_map(lambda x: x[i].detach().requires_grad_(), params_stacked)
        wb = {k: v[i].to(device) for k, v in batch.items()}
        leaves = tree_leaves(wp)
        torch.autograd.grad(loss_fn(wp, wb, cfg, impl=impl)[0], leaves,
                            allow_unused=True)
        _sync(device)

    times = []
    for i in range(w):
        grad_one(i)                                    # warm
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            grad_one(i)
            samples.append(time.perf_counter() - t0)
        times.append(float(np.median(samples)))
    if skew is not None:
        times = [t * float(s) for t, s in zip(times, skew)]
    return timeline.RateCalibration(step_times=tuple(times))


def resolve_measured_network(network, calibration: timeline.RateCalibration):
    """The network re-rated with measured per-worker rates."""
    return timeline.network_with_rates(network, calibration.rates)


# ----------------------------------------------------------------- harness
def _sharded(spmd: protocol.SpmdAxis | None) -> bool:
    return spmd is not None and spmd.size > 1


def shard_train_state(state: protocol.MLLTrainState,
                      spmd: protocol.SpmdAxis | None
                      ) -> protocol.MLLTrainState:
    """This rank's rows of a full-width train state, each leaf a tensor of
    its own (the rank mixes it in place)."""
    if not _sharded(spmd):
        return state
    lo = spmd.offset()

    def take(x):
        return x[lo:lo + spmd.per_shard].clone()
    return state._replace(params=tree_map(take, state.params),
                          opt_state=tree_map(take, state.opt_state),
                          mix_state=tree_map(take, state.mix_state))


def gather_rows(tree: Tree, spmd: protocol.SpmdAxis | None) -> Tree:
    """The full-width tree from every rank's rows (an all-gather per leaf
    over the workers axis; the same on every rank).  Only for small trees
    (the per-worker losses): every rank receives the whole tree."""
    if not _sharded(spmd):
        return tree
    return tree_map(lambda x: collectives.all_gather_rows(x, spmd.group()),
                    tree)


def average_rows(tree: Tree, a: torch.Tensor,
                 spmd: protocol.SpmdAxis | None) -> Tree:
    """u = X a over the whole fleet, the same on every rank.  On a mesh one
    leaf at a time: the leaf's rows all-gathered, reduced with ``a`` as
    one device reduces them, and freed before the next leaf, so a rank
    never holds more than one gathered leaf."""
    if not _sharded(spmd):
        return weighted_average(tree, a)

    return tree_map(lambda x: weighted_average(
        collectives.all_gather_rows(x, spmd.group()), a), tree)


def gather_train_state(state: protocol.MLLTrainState,
                       spmd: protocol.SpmdAxis | None, *, writer: int = 0
                       ) -> protocol.MLLTrainState | None:
    """The full-width train state, on the ``writer`` rank only and in its
    host memory (one leaf gathered at a time); ``None`` on every other
    rank, which only sends its rows.  Ranks whose workers line does not
    hold the writer (the data replicas) send nothing.  Without a mesh the
    state itself."""
    if not _sharded(spmd):
        return state
    if writer not in spmd.ranks:
        return None

    def rows(tree):
        return tree_map(lambda x: collectives.gather_rows_to_host(
            x, writer, spmd.group()), tree)
    full = state._replace(params=rows(state.params),
                          opt_state=rows(state.opt_state),
                          mix_state=rows(state.mix_state))
    return full if spmd.ranks[spmd.index] == writer else None


def spmd_axis(mesh, num_workers: int) -> protocol.SpmdAxis:
    """The ``workers`` axis of ``mesh`` (a `launch.mesh.Mesh`) as this
    rank's `protocol.SpmdAxis` over a fleet of ``num_workers``."""
    sizes = mesh_axis_sizes(mesh)
    if "workers" not in sizes:
        raise ValueError(
            f"mesh axes {sizes} carry no 'workers' axis -- the SPMD "
            "harness shards the worker fleet on it (--mesh W,D)")
    if num_workers % sizes["workers"]:
        raise ValueError(
            f"mesh workers axis ({sizes['workers']}) must divide the fleet "
            f"W={num_workers} -- fix the mesh shape")
    return protocol.SpmdAxis(
        "workers", sizes["workers"], num_workers,
        index=mesh.coordinate[mesh.axis_names.index("workers")],
        ranks=mesh.line("workers"), groups=mesh.axis_groups("workers"))


class TrainHarness:
    """Plan executor for the production (transformer) trainer, on one
    device or on one rank of a mesh.  ``gate_mode`` is fixed per plan:
    ``"bernoulli"`` multiplies the plan's active mask into the
    counter-based gate draw (``deadline`` = the lock-step trainer),
    ``"forced"`` uses the mask as the gate.

    With ``mesh=`` (see the module docstring) the state this harness runs
    is the rank's rows (`shard_train_state`), and so are the batches and
    masks it hands each slot.  Bit-identity contract as in the JAX
    package: the state trajectory and every u_k and loss equal the
    single-device run's.

    ``slot_stats`` (a list) records each slot it runs: the event
    (``"local"``, ``"subnet"``, ``"hub"`` or ``"op"``), its seconds
    between device synchronises, the collectives it made
    (`core.collectives.COUNTS`), their staging and transfer seconds, and
    its ``spans`` (`launch.spans.Tracer.resolve`): ``slot`` (the batch
    draw and the step), ``grads`` with ``forward`` / ``backward`` /
    ``grad_copy`` per worker row, ``update`` and ``mix``."""

    def __init__(self, cfg: ArchConfig, mll: MLLConfig, st: MLLState, *,
                 gate_mode: str, impl: str = "flash", mesh=None,
                 overlap: str = "none", overlap_chunks: int = 4,
                 slot_stats: list | None = None):
        if gate_mode not in ("bernoulli", "forced"):
            raise ValueError(f"unknown gate_mode {gate_mode!r}")
        check_impl(impl)
        if overlap not in ("none", "chunked"):
            raise ValueError(f"unknown overlap {overlap!r}; "
                             "expected none|chunked")
        if overlap == "chunked":
            if mesh is not None:
                raise ValueError(
                    "overlap='chunked' chunks the packed buffer on ONE "
                    "device; under a mesh the collective lowerings already "
                    "overlap by shard -- use overlap='none' with --mesh")
            if (mll.mixing not in ("dense", "two_stage", "ppermute")
                    or mll.mix_dtype is not None):
                raise ValueError(
                    "overlap='chunked' mixes via a dense (W, W) operator "
                    "over the packed f32 buffer; it requires mix_dtype="
                    "None and mixing in ('dense', 'two_stage', 'ppermute')")
            if overlap_chunks < 1:
                raise ValueError(f"overlap_chunks must be >= 1, "
                                 f"got {overlap_chunks}")
        self.cfg, self.mll, self.st, self.gate_mode = cfg, mll, st, gate_mode
        self.impl = impl
        self.overlap, self.overlap_chunks = overlap, overlap_chunks
        self.num_workers = int(st.rates.shape[0])
        self.device = st.v_op.device
        self.mesh, self.spmd = mesh, None
        self.rows = slice(0, self.num_workers)
        self.slot_stats = slot_stats
        self._tracer: spans.Tracer | None = None   # made on a traced slot
        if mesh is not None:
            self.spmd = spmd_axis(mesh, self.num_workers)
            # fail at construction, not at the first event
            protocol.resolve_mixing(mll).validate_spmd(st, self.spmd)
            lo = self.spmd.offset()
            self.rows = slice(lo, lo + self.spmd.per_shard)

    def _batch(self, batcher: LMBatcher, rng: np.random.Generator) -> dict:
        return {k: v[self.rows].to(self.device)
                for k, v in batcher.sample(rng).items()}

    def step(self, state, batch, active, **kw):
        """One slot over this harness' rows (``active`` is the plan's full
        (W,) mask)."""
        return self._slot(state, lambda: batch, active, **kw)

    def _slot(self, state, draw: Callable[[], dict], active, **kw):
        """`step` on the batch ``draw()`` returns.  With ``slot_stats``
        the slot is traced (`launch.spans`): a device synchronise, the
        anchor, then the root span ``slot`` over the draw and the step;
        ``seconds`` runs from a synchronise after the draw to the
        closing one, which lies outside the root span."""
        def run(batch):
            return mll_harness_step(
                state, batch, active[self.rows], self.cfg, self.mll, self.st,
                gate_mode=self.gate_mode, impl=self.impl, spmd=self.spmd,
                overlap=self.overlap, overlap_chunks=self.overlap_chunks,
                **kw)
        if self.slot_stats is None:
            return run(draw())
        if self._tracer is None:
            self._tracer = spans.Tracer(self.device)
        counts, secs = collectives.COUNTS.copy(), dict(collectives.SECONDS)
        collectives.set_timing(True)
        _sync(self.device)
        self._tracer.begin()
        try:
            with spans.span("slot"):
                batch = draw()
                _sync(self.device)
                t0 = time.perf_counter()
                out = run(batch)
            _sync(self.device)
            seconds = time.perf_counter() - t0
        finally:
            self._tracer.stop()
            collectives.set_timing(False)
        event = "op" if kw.get("op") is not None else \
            ("local", "subnet", "hub")[kw.get("phase", protocol.PHASE_LOCAL)]
        self.slot_stats.append(dict(
            event=event, seconds=seconds,
            collectives=dict(collectives.COUNTS - counts),
            stage_s=collectives.SECONDS["stage"] - secs["stage"],
            transfer_s=collectives.SECONDS["transfer"] - secs["transfer"],
            spans=self._tracer.resolve()))
        return out

    def run_span(self, state: protocol.MLLTrainState,
                 plan: timeline.TimelinePlan, batcher: LMBatcher,
                 rng: np.random.Generator, lo: int, hi: int,
                 last_metrics: dict | None = None,
                 ) -> tuple[protocol.MLLTrainState, dict | None]:
        """Execute plan slots [lo, hi).  One batch is drawn per slot (the
        data-cursor contract resumable checkpoints rely on); all-idle local
        slots of forced plans advance the cursor and the step counter
        without computing gradients."""
        op_mats = plan.op_mats or {}
        forced = plan.gate_mode == "forced"
        for s in range(lo, hi):
            act = plan.active[s]
            idle = forced and not act.any()
            draw = functools.partial(self._batch, batcher, rng)
            if plan.op_ids[s] == 0 and s not in op_mats:
                if idle:
                    batcher.skip(rng, 1)
                    state = state._replace(step=state.step + 1)
                    continue
                state, last_metrics = self._slot(state, draw, act)
            elif s in op_mats:
                op = torch.as_tensor(op_mats[s], device=self.device)
                state, last_metrics = self._slot(state, draw, act, op=op,
                                                 compute_grads=not idle)
            else:
                state, last_metrics = self._slot(
                    state, draw, act, phase=int(plan.op_ids[s]),
                    compute_grads=not idle)
        return state, last_metrics


# ----------------------------------------------------------- run lifecycle
def plan_config(mll: MLLConfig, network, plan: timeline.TimelinePlan,
                policy: str, rate_model: str) -> dict:
    """Everything that determines the plan (and hence the trajectory);
    recorded in every full-protocol checkpoint (the JAX package's fields)."""
    return {"policy": policy, "rate_model": rate_model,
            "slots": int(plan.slots), "tau": int(mll.tau), "q": int(mll.q),
            "eta": float(mll.eta), "hub_topology": mll.hub_topology,
            "mixing": mll.mixing, "mix_dtype": mll.mix_dtype,
            "inner_opt": mll.inner_opt,
            "inner_opt_args": [list(kv) for kv in mll.inner_opt_args],
            "seed": int(mll.seed),
            "workers_per_subnet": [int(n) for n in
                                   network.workers_per_subnet],
            "worker_rates": [float(r) for r in network.worker_rates]}


@dataclasses.dataclass
class HarnessRun:
    """What a plan-driven run returns (the launcher's result contract)."""
    history: dict
    avg_params: Tree
    train_state: protocol.MLLTrainState
    plan: timeline.TimelinePlan
    network: Any
    calibration: timeline.RateCalibration | None = None
    trace_path: str | None = None


def _boundaries(start: int, stop: int, eval_every: int,
                checkpoint_every: int) -> list[int]:
    """Host-surface points: eval slots, checkpoint slots, the stop/end."""
    pts = {stop}
    if eval_every:
        pts.update(range(eval_every, stop + 1, eval_every))
    if checkpoint_every:
        pts.update(range(checkpoint_every, stop + 1, checkpoint_every))
    return sorted(p for p in pts if p > start)


def run_plan(cfg: ArchConfig, mll: MLLConfig, network, st: MLLState,
             plan: timeline.TimelinePlan, batcher: LMBatcher,
             rng: np.random.Generator, train_state: protocol.MLLTrainState,
             *, start_slot: int = 0, stop_slot: int | None = None,
             eval_every: int = 16,
             checkpoint_dir: str | None = None, checkpoint_every: int = 0,
             calibration: timeline.RateCalibration | None = None,
             trace_path: str | None = None, policy: str = "deadline",
             rate_model: str = "bernoulli",
             last_worker_loss: list | None = None,
             run_config: dict | None = None, impl: str = "flash",
             mesh=None, overlap: str = "none", overlap_chunks: int = 4,
             slot_stats: list | None = None,
             log: Callable = print) -> HarnessRun:
    """Drive a `TrainHarness` over the whole plan.

    The loop surfaces at eval/checkpoint boundaries only; u_k = X a is
    computed once per boundary and shared by eval and checkpoints.
    ``stop_slot`` executes only slots [start_slot, stop_slot) of the same
    plan and checkpoints there (the kill point of a resumable run).

    With ``mesh``, every rank of it calls this with its own rows of the
    state (`shard_train_state`) and the same everything else; the returned
    ``train_state`` holds the rank's rows (`gather_train_state` joins
    them), the history and u_k are the same on every rank."""
    harness = TrainHarness(cfg, mll, st, gate_mode=plan.gate_mode, impl=impl,
                           mesh=mesh, overlap=overlap,
                           overlap_chunks=overlap_chunks,
                           slot_stats=slot_stats)
    device, spmd = harness.device, harness.spmd
    writer = mesh is None or mesh.rank == 0
    a = torch.as_tensor(np.asarray(network.a), dtype=torch.float32,
                        device=device)
    history = {"step": [], "loss": [], "avg_loss": []}
    # the most recent per-worker loss (this rank's rows); restored on
    # resume so an eval inside an all-idle straggler tail records what the
    # uninterrupted run would
    last_metrics = (None if last_worker_loss is None
                    else {"loss": torch.tensor(last_worker_loss,
                                               dtype=torch.float32)
                          [harness.rows]})
    t0 = time.time()
    done = start_slot
    u = None
    stop = plan.slots if stop_slot is None else min(stop_slot, plan.slots)
    for b in _boundaries(start_slot, stop, eval_every, checkpoint_every):
        train_state, last_metrics = harness.run_span(
            train_state, plan, batcher, rng, done, b, last_metrics)
        done = b
        u = None
        if (eval_every and done % eval_every == 0) or done == plan.slots:
            u = average_rows(train_state.params, a, spmd)
            eb = batcher.sample(rng)
            one = {k: v[0].to(device) for k, v in eb.items()}
            with torch.no_grad():
                avg_loss = float(loss_fn(u, one, cfg, impl=impl)[0])
            wl = (float(gather_rows(last_metrics["loss"], spmd).float()
                        .mean())
                  if last_metrics is not None else float("nan"))
            history["step"].append(done)
            history["loss"].append(wl)
            history["avg_loss"].append(avg_loss)
            log(f"slot {done:5d}  worker-loss {wl:.4f}  u_k-loss "
                f"{avg_loss:.4f}  ({time.time()-t0:.1f}s)")
        want_ckpt = (checkpoint_dir and checkpoint_every
                     and done % checkpoint_every == 0) or \
                    (checkpoint_dir and done == stop)
        if want_ckpt:
            if u is None:
                u = average_rows(train_state.params, a, spmd)
            full = gather_train_state(train_state, spmd)
            wl = (None if last_metrics is None else
                  [float(x) for x in
                   gather_rows(last_metrics["loss"], spmd).tolist()])
            if writer:
                checkpoint.save(checkpoint_dir, u, step=done)
                checkpoint.save_state(
                    checkpoint_dir, full, slot=done,
                    rng_state=rng_state(rng),
                    extra={"policy": policy, "rate_model": rate_model,
                           "last_worker_loss": wl,
                           # informational only -- outside the resume
                           # guard's plan_config, so checkpoints stay
                           # portable across mesh shapes
                           "mesh": (mesh_axis_sizes(mesh) if mesh is not None
                                    else None),
                           "plan_config": run_config
                           if run_config is not None
                           else plan_config(mll, network, plan, policy,
                                            rate_model)})
            del full
    # the last boundary is the stop slot: its u_k, when it computed one
    if u is None:
        u = average_rows(train_state.params, a, spmd)
    out_trace = None
    if trace_path and writer:
        meta = {"policy": policy, "rate_model": rate_model,
                "arch": cfg.name, "source": "launch.harness"}
        if calibration is not None:
            meta["calibration"] = calibration.to_json()
        out_trace = timeline.export_trace(trace_path, plan, **meta)
    return HarnessRun(history=history, avg_params=u, train_state=train_state,
                      plan=plan, network=network, calibration=calibration,
                      trace_path=out_trace)
