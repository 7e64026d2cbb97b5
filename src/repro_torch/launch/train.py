"""Plan-driven MLL-SGD training launcher (counterpart of
`repro/launch/train.py`, single device).

A readiness policy from `core.timeline` (``--policy barrier|deadline|
gossip``) compiles a `TimelinePlan` for the slot budget, and
`launch.harness` executes it over the attention transformer: per-worker
grads through the hand-written kernels (``--impl flash``: flash-attention
forward and backward) or plain PyTorch (``--impl plain``), the gated inner
optimizer, and the registered mixing strategy at each event.  Per-worker
rates are hand-fed (``--rates``) or measured (``--rate-model measured``).
Checkpoints carry the full protocol state; ``--resume`` continues a killed
run bit for bit.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 8 --tau 2 --q 2 --topology ring --mixing two_stage \\
      --policy deadline --rates 1.0 0.8 1.0 0.6 --seq-len 128 --batch 4 \\
      --impl flash                       # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --device cpu --steps 8 --tau 2 --q 2 --seq-len 32 --batch 2

``--mesh`` and ``--overlap chunked`` are not ported yet (ROADMAP.md
Queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import protocol
from repro_torch.core.mllsgd import MLLConfig, build_network, build_state
from repro_torch.core.simulator import replicate
from repro_torch.core.timeline import (RATE_MODELS, RateCalibration,
                                       available_policies, get_policy)
from repro_torch.data.pipeline import LMBatcher, make_token_stream, rng_from_state
from repro_torch.launch.harness import (CALIBRATION_FILE, measure_worker_rates,
                                        plan_config, resolve_measured_network,
                                        run_plan)
from repro_torch.models import model as model_mod
from repro_torch.models.attention import IMPLS, check_impl
from repro_torch.optim import optimizers as optim_mod
from repro_torch.train import checkpoint


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 64                  # slot budget (ticks under "deadline")
    eval_every: int = 16
    seq_len: int = 128
    batch_per_worker: int = 4
    tokens_per_worker: int = 65536
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    policy: str = "deadline"         # any registered readiness policy
    rate_model: str = "bernoulli"    # bernoulli | deterministic | measured
    resume: bool = False             # continue from checkpoint_dir's state
    stop_slot: int | None = None     # execute only [start, stop_slot) of the
                                     # plan and checkpoint there (kill point)
    trace_path: str | None = None    # export the event trace (JSON)
    impl: str = "flash"              # flash (hand-written kernels) | plain
    mesh: tuple[int, int] | None = None   # not ported (ROADMAP Queue 1)
    overlap: str = "none"            # "chunked" not ported (ROADMAP Queue 1)
    device: str | None = None        # None = cuda; "cpu" runs the plain
                                     # versions of the kernels


def _calibrate(cfg: ArchConfig, loop: TrainLoopConfig, stacked,
               batcher: LMBatcher, log) -> RateCalibration:
    """Measured-rate warmup pass; a calibration already serialized in the
    run directory is reloaded (re-measuring would change the plan).  The
    warmup batch comes from a private rng, so the data cursor is
    untouched."""
    path = (os.path.join(loop.checkpoint_dir, CALIBRATION_FILE)
            if loop.checkpoint_dir else None)
    if path and os.path.exists(path):
        log(f"reusing serialized calibration {path}")
        return RateCalibration.load(path)
    if loop.resume:
        raise FileNotFoundError(
            "rate_model='measured' resume needs the original calibration "
            f"next to the checkpoint ({path})")
    warm = batcher.sample(np.random.default_rng(loop.seed + 0x5eed))
    calibration = measure_worker_rates(cfg, stacked, warm, impl=loop.impl)
    if path:
        os.makedirs(loop.checkpoint_dir, exist_ok=True)
        calibration.save(path)
    log(f"measured step times (s): "
        f"{['%.4f' % t for t in calibration.step_times]} -> rates "
        f"{['%.2f' % r for r in calibration.rates]}")
    return calibration


def run_training(cfg: ArchConfig, mll: MLLConfig, loop: TrainLoopConfig,
                 *, num_subnets: int = 2, workers_per_subnet: int = 2,
                 log=print) -> dict:
    """Build the network, the synthetic data and the protocol state on
    ``loop.device``, compile the readiness policy's plan for ``loop.steps``
    slots and execute it (`launch.harness.run_plan`).  The model is drawn
    from a ``torch.Generator`` seeded with ``loop.seed``.  -> loss history,
    final averaged params, plan, network, train state, calibration,
    trace path."""
    check_impl(loop.impl)
    if loop.mesh is not None:
        raise NotImplementedError(
            "--mesh (SPMD execution) is not ported yet (ROADMAP.md Queue 1, "
            "'Multi-device execution')")
    if loop.resume and not loop.checkpoint_dir:
        raise ValueError("--resume needs --checkpoint-dir")
    if loop.stop_slot is not None and not loop.checkpoint_dir:
        raise ValueError("--stop-slot checkpoints the kill point; it needs "
                         "--checkpoint-dir")
    device = resolve_device(loop.device)
    network = build_network(
        dataclasses.replace(mll, granularity="worker_per_data"),
        num_subnets, workers_per_subnet)
    st = build_state(mll, network, device=device)
    w = network.num_workers
    gen = torch.Generator(device).manual_seed(loop.seed)
    params = model_mod.init_model(gen, cfg, device=device)
    n_params = model_mod.count_params(params)
    stacked = replicate(params, w)
    del params
    log(f"arch={cfg.name} params={n_params/1e6:.1f}M workers={w} "
        f"(D={num_subnets} x N={workers_per_subnet}) tau={mll.tau} q={mll.q} "
        f"policy={loop.policy} rate_model={loop.rate_model} impl={loop.impl} "
        f"device={device}")

    stream = make_token_stream(w, loop.tokens_per_worker,
                               vocab_size=cfg.vocab_size, seed=loop.seed)
    batcher = LMBatcher(stream, loop.seq_len, loop.batch_per_worker)
    rng = np.random.default_rng(loop.seed)

    calibration = None
    if loop.rate_model == "measured":
        calibration = _calibrate(cfg, loop, stacked, batcher, log)
        network = resolve_measured_network(network, calibration)
        st = build_state(mll, network, device=device)

    plan = get_policy(loop.policy).plan(network, mll.schedule, loop.steps,
                                        np.random.default_rng(loop.seed),
                                        rate_model=loop.rate_model)
    log(f"plan: {plan.rounds_completed} rounds / {len(plan.events)} events "
        f"in {plan.slots} slots (used {plan.slots_used}, "
        f"idle worker-slots {int(plan.idle_slots.sum())})")

    train_state = protocol.init_train_state(stacked, cfg=mll)
    start_slot = 0
    last_worker_loss = None
    current = dict(plan_config(mll, network, plan, loop.policy,
                               loop.rate_model),
                   arch=cfg.name, impl=loop.impl, overlap=loop.overlap,
                   eval_every=loop.eval_every, seq_len=loop.seq_len,
                   batch_per_worker=loop.batch_per_worker,
                   tokens_per_worker=loop.tokens_per_worker,
                   loop_seed=loop.seed)
    if loop.resume:
        train_state, start_slot, extra = checkpoint.restore_state(
            loop.checkpoint_dir, train_state)
        saved = extra.get("plan_config")
        if saved is not None and saved != current:
            diff = {k: (saved.get(k), current[k]) for k in current
                    if saved.get(k) != current[k]}
            raise ValueError(
                "resume config mismatch -- the checkpoint was written under "
                "a different plan; resuming would splice two plans into one "
                f"trajectory.  Differing (saved, current): {diff}")
        rng = rng_from_state(extra["rng_state"])
        last_worker_loss = extra.get("last_worker_loss")
        log(f"resumed from slot {start_slot} "
            f"(policy={extra.get('policy')}, saved rng restored)")

    run = run_plan(cfg, mll, network, st, plan, batcher, rng, train_state,
                   start_slot=start_slot, stop_slot=loop.stop_slot,
                   eval_every=loop.eval_every,
                   checkpoint_dir=loop.checkpoint_dir,
                   checkpoint_every=loop.checkpoint_every,
                   calibration=calibration, trace_path=loop.trace_path,
                   policy=loop.policy, rate_model=loop.rate_model,
                   last_worker_loss=last_worker_loss, run_config=current,
                   impl=loop.impl, overlap=loop.overlap, log=log)
    return {"history": run.history, "avg_params": run.avg_params,
            "network": run.network, "plan": run.plan,
            "train_state": run.train_state, "calibration": run.calibration,
            "trace_path": run.trace_path}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=64,
                    help="slot budget (ticks under policy='deadline')")
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--topology", default="complete")
    ap.add_argument("--mixing", default="dense", metavar="NAME",
                    help="registered mixing strategy: "
                         f"{', '.join(protocol.available_mixing())}")
    ap.add_argument("--inner-opt", default="sgd",
                    choices=tuple(sorted(optim_mod.OPTIMIZERS)))
    ap.add_argument("--subnets", type=int, default=2)
    ap.add_argument("--workers-per-subnet", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rates", type=float, nargs="*", default=None,
                    help="per-worker p_i (heterogeneous operating rates)")
    ap.add_argument("--policy", default="deadline",
                    choices=available_policies(),
                    help="readiness policy compiling the timeline plan")
    ap.add_argument("--rate-model", default="bernoulli", choices=RATE_MODELS,
                    help="'measured' profiles per-worker step times in a "
                         "warmup pass instead of using hand-fed p_i")
    ap.add_argument("--impl", default="flash", choices=IMPLS,
                    help="'flash' trains attention through the hand-written "
                         "kernels (forward + backward), 'plain' through "
                         "plain PyTorch")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain versions of the "
                         "kernels)")
    ap.add_argument("--eval-every", type=int, default=16)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the full-protocol checkpoint in "
                         "--checkpoint-dir (bit-identical trajectory)")
    ap.add_argument("--stop-slot", type=int, default=None,
                    help="execute only up to this slot of the plan and "
                         "checkpoint there (simulated kill / partial run)")
    ap.add_argument("--trace", default=None,
                    help="export the event trace (simulator schema) here")
    args = ap.parse_args(argv)
    try:
        protocol.check_mixing(args.mixing)
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rates = tuple(args.rates) if args.rates else 1.0
    mll = MLLConfig(tau=args.tau, q=args.q, eta=args.eta,
                    hub_topology=args.topology, mixing=args.mixing,
                    inner_opt=args.inner_opt, worker_rates=rates)
    loop = TrainLoopConfig(steps=args.steps, eval_every=args.eval_every,
                           seq_len=args.seq_len,
                           batch_per_worker=args.batch,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=max(args.steps // 2, 1)
                           if args.checkpoint_dir else 0,
                           policy=args.policy, rate_model=args.rate_model,
                           resume=args.resume, stop_slot=args.stop_slot,
                           trace_path=args.trace, impl=args.impl,
                           device=args.device)
    out = run_training(cfg, mll, loop, num_subnets=args.subnets,
                       workers_per_subnet=args.workers_per_subnet)
    losses = out["history"]["avg_loss"]
    if losses:
        print(f"final u_k loss: {losses[-1]:.4f} "
              f"(first recorded {losses[0]:.4f})")


if __name__ == "__main__":
    main()
