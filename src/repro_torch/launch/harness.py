"""Plan-driven production trainer (counterpart of `repro/launch/harness.py`,
single device).

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
data.

Beyond the executor, the harness owns the run lifecycle: measured worker
rates (`measure_worker_rates`), full-protocol checkpoints every
``checkpoint_every`` slots (`train.checkpoint.save_state`; a killed run
resumed from its last checkpoint replays the uninterrupted trajectory bit
for bit) and event-trace export (`timeline.plan_trace`).

Device meshes (``mesh=``) and ``overlap="chunked"`` are not ported yet
(ROADMAP.md Queue 1) and raise `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import protocol, timeline
from repro_torch.core.mllsgd import MLLConfig, MLLState
from repro_torch.core.simulator import weighted_average
from repro_torch.data.pipeline import LMBatcher, rng_state
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
        torch.autograd.grad(loss_fn(wp, wb, cfg, impl=impl)[0], leaves)
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
class TrainHarness:
    """Plan executor for the production (transformer) trainer on one
    device.  ``gate_mode`` is fixed per plan: ``"bernoulli"`` multiplies the
    plan's active mask into the counter-based gate draw (``deadline`` = the
    lock-step trainer), ``"forced"`` uses the mask as the gate."""

    def __init__(self, cfg: ArchConfig, mll: MLLConfig, st: MLLState, *,
                 gate_mode: str, impl: str = "flash", mesh=None,
                 overlap: str = "none"):
        if gate_mode not in ("bernoulli", "forced"):
            raise ValueError(f"unknown gate_mode {gate_mode!r}")
        check_impl(impl)
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (SPMD execution) is not ported yet (ROADMAP.md "
                "Queue 1, 'Multi-device execution'); the port's harness runs "
                "the fleet on one device")
        if overlap != "none":
            raise NotImplementedError(
                f"overlap={overlap!r} is not ported yet (ROADMAP.md Queue 1, "
                "'Compression ladder + chunked overlap')")
        self.cfg, self.mll, self.st, self.gate_mode = cfg, mll, st, gate_mode
        self.impl = impl
        self.num_workers = int(st.rates.shape[0])
        self.device = st.v_op.device

    def _batch(self, batcher: LMBatcher, rng: np.random.Generator) -> dict:
        return {k: v.to(self.device) for k, v in batcher.sample(rng).items()}

    def step(self, state, batch, active, **kw):
        return mll_harness_step(state, batch, active, self.cfg, self.mll,
                                self.st, gate_mode=self.gate_mode,
                                impl=self.impl, **kw)

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
            if plan.op_ids[s] == 0 and s not in op_mats:
                if idle:
                    batcher.skip(rng, 1)
                    state = state._replace(step=state.step + 1)
                    continue
                state, last_metrics = self.step(state, self._batch(batcher,
                                                                   rng), act)
            elif s in op_mats:
                op = torch.as_tensor(op_mats[s], device=self.device)
                state, last_metrics = self.step(
                    state, self._batch(batcher, rng), act, op=op,
                    compute_grads=not idle)
            else:
                state, last_metrics = self.step(
                    state, self._batch(batcher, rng), act,
                    phase=int(plan.op_ids[s]), compute_grads=not idle)
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
             mesh=None, overlap: str = "none",
             log: Callable = print) -> HarnessRun:
    """Drive a `TrainHarness` over the whole plan.

    The loop surfaces at eval/checkpoint boundaries only; u_k = X a is
    computed once per boundary and shared by eval and checkpoints.
    ``stop_slot`` executes only slots [start_slot, stop_slot) of the same
    plan and checkpoints there (the kill point of a resumable run)."""
    harness = TrainHarness(cfg, mll, st, gate_mode=plan.gate_mode, impl=impl,
                           mesh=mesh, overlap=overlap)
    device = harness.device
    a = torch.as_tensor(np.asarray(network.a), dtype=torch.float32,
                        device=device)
    history = {"step": [], "loss": [], "avg_loss": []}
    # the most recent per-worker loss; restored on resume so an eval inside
    # an all-idle straggler tail records what the uninterrupted run would
    last_metrics = (None if last_worker_loss is None
                    else {"loss": torch.tensor(last_worker_loss,
                                               dtype=torch.float32)})
    t0 = time.time()
    done = start_slot
    final_u = None
    stop = plan.slots if stop_slot is None else min(stop_slot, plan.slots)
    for b in _boundaries(start_slot, stop, eval_every, checkpoint_every):
        train_state, last_metrics = harness.run_span(
            train_state, plan, batcher, rng, done, b, last_metrics)
        done = b
        u = None
        if (eval_every and done % eval_every == 0) or done == plan.slots:
            u = weighted_average(train_state.params, a)
            eb = batcher.sample(rng)
            one = {k: v[0].to(device) for k, v in eb.items()}
            with torch.no_grad():
                avg_loss = float(loss_fn(u, one, cfg, impl=impl)[0])
            wl = (float(last_metrics["loss"].float().mean())
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
                u = weighted_average(train_state.params, a)
            checkpoint.save(checkpoint_dir, u, step=done)
            wl = (None if last_metrics is None else
                  [float(x) for x in last_metrics["loss"].tolist()])
            checkpoint.save_state(
                checkpoint_dir, train_state, slot=done,
                rng_state=rng_state(rng),
                extra={"policy": policy, "rate_model": rate_model,
                       "last_worker_loss": wl, "mesh": None,
                       "plan_config": run_config if run_config is not None
                       else plan_config(mll, network, plan, policy,
                                        rate_model)})
        if done == plan.slots:
            final_u = u
        del u
    u = final_u if final_u is not None \
        else weighted_average(train_state.params, a)
    out_trace = None
    if trace_path:
        meta = {"policy": policy, "rate_model": rate_model,
                "arch": cfg.name, "source": "launch.harness"}
        if calibration is not None:
            meta["calibration"] = calibration.to_json()
        out_trace = timeline.export_trace(trace_path, plan, **meta)
    return HarnessRun(history=history, avg_params=u, train_state=train_state,
                      plan=plan, network=network, calibration=calibration,
                      trace_path=out_trace)
