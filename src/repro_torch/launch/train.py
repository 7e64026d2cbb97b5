"""Plan-driven MLL-SGD training launcher (counterpart of
`repro/launch/train.py`).

A readiness policy from `core.timeline` (``--policy barrier|deadline|
gossip``) compiles a `TimelinePlan` for the slot budget, and
`launch.harness` executes it over the model (attention transformers and
xLSTM): per-worker grads through the hand-written kernels (``--impl
flash``: flash-attention forward and backward, the sLSTM scan forward and
backward) or plain PyTorch (``--impl plain``), the gated inner
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
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --impl flash --steps 8 --tau 2 --q 2 --seq-len 512 --batch 4

``--mixing`` takes any registered strategy, the compression ladder
included (``--mixing list`` prints them with their wire formats);
``--overlap chunked`` mixes each event over the packed columns one chunk
at a time.

``--mesh W,D`` shards the fleet over a (workers, data) mesh of W * D
`torch.distributed` ranks, each averaging round a collective among them
(``--mixing`` dense, two_stage, ppermute or bf16).  Under ``torchrun`` the
launcher joins the world torchrun started; otherwise it starts W * D local
ranks itself (`launch.mesh.spawn`) with ``--backend`` (gloo: the CPU, or
several ranks sharing one card; nccl: one card per rank):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --mesh 2,1 --steps 8 --tau 2 --q 2 \\
      --topology ring --mixing two_stage --seq-len 32 --batch 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-0.5b --mesh 4,1 --backend nccl --mixing two_stage ...

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 8 --tau 2 --q 2 --topology ring \\
      --mixing int8_ef --seq-len 32 --batch 2 --eval-every 4
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import collectives, protocol
from repro_torch.core.mllsgd import MLLConfig, build_network, build_state
from repro_torch.core.simulator import replicate
from repro_torch.core.timeline import (RATE_MODELS, RateCalibration,
                                       available_policies, get_policy)
from repro_torch.data.pipeline import LMBatcher, make_token_stream, rng_from_state
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.harness import (CALIBRATION_FILE,
                                        measure_worker_rates, plan_config,
                                        resolve_measured_network, run_plan,
                                        shard_train_state, spmd_axis)
from repro_torch.models import model as model_mod
from repro_torch.models.attention import KERNEL_IMPLS, check_impl
from repro_torch.optim import optimizers as optim_mod
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, tree_map


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
    mesh: tuple[int, int] | None = None   # (workers, data): shard the
                                     # fleet over a process mesh of that
                                     # shape (--mesh W,D); None = one
                                     # process.  Outside the resume guard:
                                     # checkpoints cross mesh shapes
    overlap: str = "none"            # "chunked": mix the packed buffer
                                     # chunk by chunk (rtol-equivalent)
    overlap_chunks: int = 4          # column chunks per mixing event
    device: str | None = None        # None = cuda; "cpu" runs the plain
                                     # versions of the kernels
    profile_slots: bool = False      # per-slot seconds and collectives
                                     # (`TrainHarness` ``slot_stats``)


def replicate_params(params: dict, w: int) -> dict:
    """``w`` stacked replicas of ``params`` on a new leading worker axis.
    They are real copies, not views (JAX's ``broadcast_to``): the port
    updates the workers in place."""
    return replicate(params, w)


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


def _mesh_of(loop: TrainLoopConfig, w: int, num_subnets: int,
             workers_per_subnet: int, log) -> mesh_mod.Mesh | None:
    if loop.mesh is None:
        return None
    mw, md = loop.mesh
    if mw < 1 or w % mw:
        raise ValueError(
            f"mesh {loop.mesh}: the workers axis ({mw}) must divide the "
            f"fleet W={w} (D={num_subnets} x N={workers_per_subnet}) -- "
            "fix --mesh")
    mesh = mesh_mod.make_mesh((mw, md), ("workers", "data"))
    backend = dist.get_backend() if dist.is_initialized() else "none"
    log(f"mesh: workers={mw} data={md} over {mw * md} ranks "
        f"(backend {backend}, rank {mesh.rank})")
    return mesh


def run_training(cfg: ArchConfig, mll: MLLConfig, loop: TrainLoopConfig,
                 *, num_subnets: int = 2, workers_per_subnet: int = 2,
                 log=print) -> dict:
    """Build the network, the synthetic data and the protocol state on
    ``loop.device``, compile the readiness policy's plan for ``loop.steps``
    slots and execute it (`launch.harness.run_plan`).  The model is drawn
    from a ``torch.Generator`` seeded with ``loop.seed``.  -> loss history,
    final averaged params, plan, network, train state, calibration,
    trace path (and ``slot_stats`` with ``loop.profile_slots``).

    With ``loop.mesh`` every rank of an initialised world calls this (see
    `train_rank`): each draws the same model and plan from the seed and
    keeps its rows of the fleet; the returned train state holds them."""
    check_impl(loop.impl, KERNEL_IMPLS)
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
    mesh = _mesh_of(loop, w, num_subnets, workers_per_subnet, log)
    # a rank holds its rows of the fleet only (all rows start as u_0)
    rows = w // loop.mesh[0] if mesh is not None else w
    gen = torch.Generator(device).manual_seed(loop.seed)
    params = model_mod.init_model(gen, cfg, device=device)
    n_params = model_mod.count_params(params)
    stacked = replicate_params(params, rows)
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
        # one rank measures (on a view of W copies of u_0) and every rank
        # takes its calibration, so all ranks compile the same plan
        if mesh is None or mesh.rank == 0:
            full = tree_map(lambda x: x[:1].expand((w,) + x.shape[1:]),
                            stacked)
            calibration = _calibrate(cfg, loop, full, batcher, log)
            del full
        if mesh is not None:
            calibration = collectives.broadcast_object(calibration)
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
                   overlap_chunks=loop.overlap_chunks,
                   eval_every=loop.eval_every, seq_len=loop.seq_len,
                   batch_per_worker=loop.batch_per_worker,
                   tokens_per_worker=loop.tokens_per_worker,
                   loop_seed=loop.seed)
    if loop.resume:
        # the checkpoint holds the whole fleet: restore it at full width
        # (into views of this rank's rows), then keep this rank's rows
        def wide(tree):
            return tree_map(lambda x: x[:1].expand((w,) + x.shape[1:]), tree)
        like = train_state._replace(params=wide(train_state.params),
                                    opt_state=wide(train_state.opt_state),
                                    mix_state=wide(train_state.mix_state))
        train_state, start_slot, extra = checkpoint.restore_state(
            loop.checkpoint_dir, like)
        if mesh is not None:
            train_state = shard_train_state(train_state, spmd_axis(mesh, w))
        saved = extra.get("plan_config")
        if saved is not None and "overlap_chunks" not in saved:
            # checkpoints written before the chunked overlap ran the
            # unchunked event path
            saved = dict(saved, overlap="none", overlap_chunks=4)
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

    slot_stats = [] if loop.profile_slots else None
    run = run_plan(cfg, mll, network, st, plan, batcher, rng, train_state,
                   start_slot=start_slot, stop_slot=loop.stop_slot,
                   eval_every=loop.eval_every,
                   checkpoint_dir=loop.checkpoint_dir,
                   checkpoint_every=loop.checkpoint_every,
                   calibration=calibration, trace_path=loop.trace_path,
                   policy=loop.policy, rate_model=loop.rate_model,
                   last_worker_loss=last_worker_loss, run_config=current,
                   impl=loop.impl, mesh=mesh, overlap=loop.overlap,
                   overlap_chunks=loop.overlap_chunks,
                   slot_stats=slot_stats, log=log)
    out = {"history": run.history, "avg_params": run.avg_params,
           "network": run.network, "plan": run.plan,
           "train_state": run.train_state, "calibration": run.calibration,
           "trace_path": run.trace_path, "mesh": mesh}
    if slot_stats is not None:
        out["slot_stats"] = slot_stats
    return out


def _quiet(*_a, **_k) -> None:
    pass


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.detach().reshape(-1).contiguous().view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def fleet_digests(tree) -> list[list[str]]:
    """SHA-256 of every worker row of every leaf, ``[leaf][row]``: equal
    digests are equal bits, for fleets too large to ship between
    processes."""
    return [[_digest(row) for row in x] for x in tree_leaves(tree)]


def train_rank(cfg: ArchConfig, runs: list[dict], *,
               ship: str | None = "tensors", quiet: bool = True
               ) -> list[dict]:
    """One rank of a mesh world (the function `launch.mesh.spawn` starts):
    ``run_training(cfg, **run)`` for each ``run`` of ``runs`` in turn
    (keys ``mll``, ``loop`` and optionally ``num_subnets``,
    ``workers_per_subnet``), each with its own ``loop.mesh``.  Per run ->
    ``history``, ``rows`` (this rank's (first, end) worker rows),
    ``slot_stats`` (with ``loop.profile_slots``), ``launches`` (the
    kernels' launch counts of this rank, `kernels.ops.launch_counts`, and
    the bf16 ones of the two attention wrappers as ``tc_...``),
    ``collectives`` (`core.collectives.COUNTS`), ``collective_bytes``
    (`core.collectives.BYTES`: what this rank received),
    ``peak_bytes`` on a card and ``seconds``, plus with ``ship="tensors"``
    the rank's rows of the train state (``state``) and u_k (``u``, rank 0
    only), with ``ship="digests"`` the `fleet_digests` of the rows' params
    and of u_k (one row, rank 0 only).  Rank 0 logs unless ``quiet``."""
    rank = dist.get_rank()
    log = print if rank == 0 and not quiet else _quiet
    out = []
    for run in runs:
        ops.reset_launches()
        collectives.reset()
        device = resolve_device(run["loop"].device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = run_training(cfg, **run, log=log)
        row = dict(
            history=res["history"], slot_stats=res.get("slot_stats"),
            seconds=time.perf_counter() - t0,
            launches=dict(ops.launch_counts(),
                          tc_flash_attention=ops.flash_attention.tc_launches,
                          tc_flash_attention_bwd=(
                              ops.flash_attention_bwd.tc_launches)),
            collectives=dict(collectives.COUNTS),
            collective_bytes=dict(collectives.BYTES),
            peak_bytes=(torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else None))
        mesh = res["mesh"]
        spmd = spmd_axis(mesh, res["network"].num_workers) if mesh else None
        lo = spmd.offset() if spmd else 0
        n = spmd.per_shard if spmd else res["network"].num_workers
        row["rows"] = (lo, lo + n)
        state, u = res["train_state"], res["avg_params"]
        if ship == "tensors":
            row["state"] = tree_map(lambda x: x.detach().cpu(), state)
            row["u"] = (tree_map(lambda x: x.detach().cpu(), u)
                        if rank == 0 else None)
        elif ship == "digests":
            row["state"] = fleet_digests(state.params)
            row["u"] = (fleet_digests(tree_map(lambda x: x[None], u))
                        if rank == 0 else None)
        out.append(row)
        del res, state, u
    return out


def _run_mesh(cfg, mll, loop, args) -> dict:
    """``--mesh``: join the world torchrun started, or start one."""
    kw = dict(num_subnets=args.subnets,
              workers_per_subnet=args.workers_per_subnet)
    if "WORLD_SIZE" in os.environ:                 # under torchrun
        device = resolve_device(loop.device)
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(args.backend, timeout=mesh_mod.TIMEOUT)
        try:
            log = print if dist.get_rank() == 0 else _quiet
            return run_training(cfg, mll, loop, log=log, **kw)
        finally:
            dist.destroy_process_group()
    world = loop.mesh[0] * loop.mesh[1]
    ranks = mesh_mod.spawn(train_rank, world, cfg,
                           [dict(mll=mll, loop=loop, **kw)], ship=None,
                           quiet=False, backend=args.backend,
                           device=args.device)
    return ranks[0][0]


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
                    help="registered mixing strategy; 'list' prints the "
                         "registry with wire-format descriptions and exits")
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
    ap.add_argument("--impl", default="flash", choices=KERNEL_IMPLS,
                    help="'flash' trains attention through the hand-written "
                         "kernels (forward + backward), 'plain' through "
                         "plain PyTorch")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain versions of the "
                         "kernels)")
    ap.add_argument("--mesh", default=None, metavar="W,D",
                    help="shard the fleet over a (workers, data) mesh of "
                         "W * D torch.distributed ranks with real mixing "
                         "collectives, e.g. --mesh 4,1; starts the ranks "
                         "itself unless run under torchrun")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="torch.distributed backend of a --mesh run: gloo "
                         "on the CPU or for ranks sharing one card, nccl "
                         "for one card per rank")
    ap.add_argument("--overlap", default="none", choices=("none", "chunked"),
                    help="'chunked' mixes the packed buffer chunk by chunk "
                         "(requires a dense-operator mixing; rtol-equivalent "
                         "reduction-order change)")
    ap.add_argument("--overlap-chunks", type=int, default=4,
                    help="column chunks per mixing event under --overlap "
                         "chunked")
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
    if args.mixing == "list":
        print(protocol.describe_mixing())
        return
    if args.mixing not in protocol.available_mixing():
        ap.error(f"unknown mixing {args.mixing!r}; registered: "
                 f"{', '.join(protocol.available_mixing())} (or 'list' to "
                 "describe)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh:
        try:
            mesh = tuple(int(x) for x in args.mesh.split(","))
            if len(mesh) != 2:
                raise ValueError
        except ValueError:
            ap.error(f"--mesh must be 'W,D' (two ints), got {args.mesh!r}")
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
                           mesh=mesh, overlap=args.overlap,
                           overlap_chunks=args.overlap_chunks,
                           device=args.device)
    if mesh is not None:
        out = _run_mesh(cfg, mll, loop, args)
        if os.environ.get("RANK", "0") != "0":
            return                                   # torchrun: rank 0 prints
    else:
        out = run_training(cfg, mll, loop, num_subnets=args.subnets,
                           workers_per_subnet=args.workers_per_subnet)
    losses = out["history"]["avg_loss"]
    if losses:
        print(f"final u_k loss: {losses[-1]:.4f} "
              f"(first recorded {losses[0]:.4f})")


if __name__ == "__main__":
    main()
