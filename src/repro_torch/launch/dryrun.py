"""Multi-pod dry run on ``meta`` tensors (counterpart of
`repro/launch/dryrun.py`): run every (architecture x input-shape x mesh)
combination's real program on shape stand-ins, with no device memory and
no card, and count its work on the H100 roofline.

The JAX module lowers and compiles each combination for 256 or 512
placeholder TPU devices (it sets ``XLA_FLAGS`` before importing JAX).  The
port has no devices to fake and sets no environment variable: it runs the
same programs eagerly on ``meta`` tensors --

* ``param_skeleton`` and ``build_state(device="meta")``;
* for ``train``: ONE rank's share of the fleet's step,
  `train_step.mll_transformer_step` over its worker's rows with the slot's
  mixing round lowered to the strategy's collectives (``*_spmd``) among
  stand-in groups of the production mesh (`core.collectives.StandInGroup`:
  the worker axis' global chip ranks, pod axis major); every rank runs the
  same program, so the fleet's count is the rank's times the workers;
* for ``prefill``: the forward over the prompt, its last position's
  logits; for ``decode``: ``serve_step`` of one token at position
  ``seq_len - 1`` against ``init_decode_state(device="meta")`` (the JAX
  module traces the position; eager code needs a number);

-- all of it under `models.pjit_utils.logical_sharding` and a
`launch.cost_analysis.CostCounter`.  For each combination it writes the
JAX module's JSON keys, with these counterparts:

* ``memory_analysis``: per-chip ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, each leaf's bytes over the product of the mesh
  axes its partition spec names (`launch.sharding`); temporaries are not
  counted (eager code frees them op by op, and no compiler plans them);
* ``hlo_costs``: the counter's totals per chip (the fleet's count over the
  chips, the JAX module's per-device costs), and ``rank_costs`` what the
  counter counted for one rank;
* ``roofline``, ``model_flops`` and ``useful_fraction`` keep their JAX
  meanings (`cost_analysis.roofline_terms`, H100 peaks);
* ``raw_cost_analysis``: ``torch.utils.flop_counter``'s own count (the
  library's, as the JAX module keeps XLA's), ``run_s`` in place of
  ``lower_s``; nothing is compiled (``compile_s`` is null).

Not counted: the per-worker tensor / FSDP collectives that the JAX
module's GSPMD inserts (the port never shards inside a worker at runtime),
and ``.lower().compile()`` itself -- a clean ``meta`` run is the port's
proof that the shapes fit together.  ``--phase dynamic`` runs the phase
the schedule gives at the hub step (tau * q) and records it as
``phase_run``; the JAX module lowers every branch of its conditional.

``--impl flash`` (the default) runs each kernel's ``meta`` branch
(`kernels.ops`); ``auto`` and ``plain`` run the plain paths, the plain
sLSTM a Python loop over time (slow for xLSTM at 4,096 tokens).

CLI:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      [--multipod] [--phase hub] [--mixing two_stage] [--out results.json]
  python -m repro_torch.launch.dryrun --all [--multipod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import collectives, protocol
from repro_torch.core.mllsgd import MLLConfig, build_network, build_state
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.input_specs import (SHAPES, adapt_config,
                                            decode_input_specs,
                                            prefill_input_specs,
                                            train_input_specs)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import PRODUCTION, Mesh
from repro_torch.launch.sharding import (ShardingPlan, axis_entry, leaf_dims,
                                         make_plan)
from repro_torch.models import model as model_mod
from repro_torch.models.pjit_utils import logical_sharding
from repro_torch.serve.serve_step import serve_step
from repro_torch.train.train_step import mll_transformer_step
from repro_torch.tree import map_with_path, tree_map

Tree = Any
PHASES = {"local": 0, "subnet": 1, "hub": 2, "dynamic": None}
PHASE_NAMES = {0: "local", 1: "subnet", 2: "hub"}
POD_STRIDE = 256          # global ranks of one pod of the 2 x 16 x 16 mesh


# ------------------------------------------------------------ spec builders
def params_shape(cfg: ArchConfig) -> Tree:
    return model_mod.param_skeleton(cfg)


def stack_worker_axis(shapes: Tree, w: int) -> Tree:
    return tree_map(lambda s: torch.empty((w,) + tuple(s.shape),
                                          dtype=s.dtype, device="meta"),
                    shapes)


def _batch_axis(plan: ShardingPlan, size: int):
    """Mesh axes for a global batch dim of the given size (serving path)."""
    axes = [a for a in ("pod", "data") if a in plan.axis_sizes]
    prod = 1
    keep = []
    for a in axes:
        if size % (prod * plan.axis_sizes[a]) == 0:
            keep.append(a)
            prod *= plan.axis_sizes[a]
    return axis_entry(tuple(keep))


def train_batch_specs(batch: dict, plan: ShardingPlan) -> dict:
    """Partition specs of per-worker training batches (leading worker
    axis)."""
    waxes = axis_entry(plan.worker_axes)
    inner_batch = ("data" if plan.granularity == "worker_per_pod" else None)

    def one(name, leaf):
        rest = [None] * (leaf.dim() - 1)
        # dim 1 is the per-worker batch dim except for "positions" (streams)
        bdim = 2 if name == "positions" else 1
        if inner_batch and leaf.shape[bdim] % plan.data_size == 0:
            rest[bdim - 1] = inner_batch
        return (waxes, *rest)

    return {k: one(k, v) for k, v in batch.items()}


def serve_batch_specs(batch: dict, plan: ShardingPlan) -> dict:
    def one(name, leaf):
        bax = _batch_axis(plan, leaf.shape[0])
        bdim = 1 if name == "positions" else 0
        spec = [None] * leaf.dim()
        spec[bdim] = bax if leaf.shape[bdim] > 1 else None
        return tuple(spec)

    return {k: one(k, v) for k, v in batch.items()}


def decode_state_specs(state_shapes: Tree, plan: ShardingPlan) -> Tree:
    """KV-cache / recurrent-state partition specs: batch -> data(/pod),
    then the head or channel dim -> model when divisible (kv-head first,
    head_dim as fallback).  The port's decode state is a list per
    super-block, so its leaves lack the JAX state's leading stacked dim
    (and their specs its leading ``None``)."""
    ms = plan.model_size

    def div(n):
        return n % ms == 0

    def one(path, leaf):
        name = str(path[-1])
        shp = tuple(leaf.shape)                # (B, ...) one super-block
        nd = leaf.dim()
        bax = _batch_axis(plan, shp[0]) if shp[0] > 1 else None
        spec = [bax] + [None] * (nd - 1)
        if name in ("k", "v") and nd == 4:             # (B,S,hkv,hd)
            if div(shp[2]):
                spec[2] = "model"
            elif div(shp[3]):
                spec[3] = "model"
        elif name == "h" and nd == 3:                  # mamba (B,di,n)
            if div(shp[1]):
                spec[1] = "model"
        elif name == "conv" and nd == 3:               # (B,K-1,di)
            if div(shp[2]):
                spec[2] = "model"
        elif name == "c" and nd == 4:                  # mlstm (B,h,hd,hd)
            if div(shp[1]):
                spec[1] = "model"
            elif div(shp[2]):
                spec[2] = "model"
        elif name == "n" and nd == 3:                  # mlstm (B,h,hd)
            if div(shp[1]):
                spec[1] = "model"
            elif div(shp[2]):
                spec[2] = "model"
        elif nd == 2 and name in ("h", "c", "n", "m"):  # slstm (B,dp)
            if div(shp[1]):
                spec[1] = "model"
        return tuple(spec)

    return map_with_path(one, state_shapes)


# ---------------------------------------------------------- the stand-ins
def standin_spmd(plan: ShardingPlan) -> protocol.SpmdAxis:
    """The worker axis of ``plan``'s production mesh as the first worker's
    `protocol.SpmdAxis`: one rank per worker (its first chip's global
    rank, pod axis major), and a `collectives.StandInGroup` for each
    contiguous block of workers the lowerings may use."""
    sizes = plan.axis_sizes
    names = plan.mesh.axis_names
    waxes = plan.worker_axes
    ranks = []
    for flat in range(plan.num_workers):
        coord = [0] * len(names)
        rem = flat
        for a in reversed(waxes):
            coord[names.index(a)] = rem % sizes[a]
            rem //= sizes[a]
        r = 0
        for i, a in enumerate(names):
            r = r * sizes[a] + coord[i]
        ranks.append(r)
    ranks = tuple(ranks)
    groups = {b: collectives.StandInGroup(ranks[:b], ranks[0])
              for b in mesh_mod._divisors(len(ranks))}
    return protocol.SpmdAxis("workers", len(ranks), len(ranks), index=0,
                             ranks=ranks, groups=groups)


def _chips(plan: ShardingPlan) -> int:
    return math.prod(plan.mesh.shape)


def _spec_bytes(tree: Tree, specs: Tree, plan: ShardingPlan, *,
                with_worker_axis: bool = False) -> int:
    """Per-chip bytes of ``tree``: each leaf's bytes over the product of
    the mesh axes its spec names."""
    sizes = plan.axis_sizes
    total = 0

    def leaf(path, x, spec):
        nonlocal total
        spec = leaf_dims(path, spec, with_worker_axis=with_worker_axis)
        n = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n *= sizes[a]
        total += x.numel() * x.element_size() // n

    map_with_path(leaf, tree, specs,
                  is_leaf=lambda p, x: isinstance(x, torch.Tensor))
    return total


# ----------------------------------------------------------------- programs
def build_train_step(cfg: ArchConfig, plan: ShardingPlan, *,
                     tau: int, q: int, mixing: str, mix_dtype: str | None,
                     phase: int | None, remat: str, impl: str,
                     microbatch: int = 1, accum_dtype: str = "float32"):
    """One rank's step of the fleet: ``step_fn(rank_params, rank_batch,
    step)`` over the rank's worker rows, mixing through the stand-in
    groups of `standin_spmd`."""
    mll = MLLConfig(tau=tau, q=q, granularity=plan.granularity,
                    hub_topology="complete", mixing=mixing,
                    mix_dtype=mix_dtype, accum_dtype=accum_dtype)
    network = build_network(mll, plan.n_pods, plan.data_size,
                            plan.model_size)
    # the (D, D) hub matrix stays readable on the CPU: ppermute's lowering
    # reads its circulant coefficients (a 0-d CPU tensor meets a meta one)
    st = dataclasses.replace(build_state(mll, network, device="meta"),
                             h=build_state(mll, network, device="cpu").h)
    spmd = standin_spmd(plan)
    if spmd.size > 1:
        protocol.resolve_mixing(mll).validate_spmd(st, spmd)

    def step_fn(stacked_params, batch, step):
        return mll_transformer_step(
            stacked_params, batch, step, cfg, mll, st, impl=impl,
            remat=remat, microbatch=microbatch, static_phase=phase,
            spmd=spmd)

    step_fn.spmd = spmd
    return step_fn


def prefill_fn_for(cfg: ArchConfig, *, impl: str, remat: str):
    def prefill(params, batch):
        logits, _ = model_mod.forward_train(params, batch, cfg, impl=impl,
                                            remat=remat)
        return logits[:, -1]        # next-token logits after the prompt
    return prefill


def _rows(tree: Tree, n: int) -> Tree:
    return tree_map(lambda x: x[:n], tree)


def run_one(arch_id: str, shape_name: str, *, multi_pod: bool = False,
            phase: str = "dynamic", mixing: str = "dense",
            mix_dtype: str | None = None, remat: str = "full",
            tau: int = 8, q: int = 4, impl: str = "flash",
            granularity: str | None = None,
            moe_groups: int | None = None,
            rules_override: dict | None = None,
            microbatch: int = 1,
            accum_dtype: str = "float32",
            decode_coshard: bool = True,
            cfg: ArchConfig | None = None,
            shape=None) -> dict:
    """One combination's dry run -> the JSON record (module docstring).
    ``cfg`` / ``shape`` replace the registry's config and `SHAPES`' entry
    (smaller stand-ins for tests)."""
    t0 = time.time()
    shape = SHAPES[shape_name] if shape is None else shape
    cfg = adapt_config(get_config(arch_id) if cfg is None else cfg, shape)
    if moe_groups is not None:
        cfg = dataclasses.replace(cfg, moe_groups=moe_groups)
    if not decode_coshard:
        cfg = dataclasses.replace(cfg, decode_coshard=False)
    mesh = Mesh(*PRODUCTION[multi_pod])
    plan = make_plan(mesh, cfg, granularity=granularity)
    meta = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "phase": phase, "mixing": mixing,
        "mix_dtype": mix_dtype, "remat": remat, "tau": tau, "q": q,
        "granularity": plan.granularity, "num_workers": plan.num_workers,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    serving = shape.kind != "train"
    rules = plan.logical_rules(serving=serving)
    if rules_override:
        rules.update(rules_override)
        meta["rules_override"] = {k: str(v) for k, v in
                                  rules_override.items()}
    if moe_groups is not None:
        meta["moe_groups"] = moe_groups
    meta["microbatch"] = microbatch
    chips = _chips(plan)
    counter = ca.CostCounter(pod_stride=POD_STRIDE if multi_pod else 0)
    flop_mode = FlopCounterMode(display=False)

    with logical_sharding(mesh, rules):
        if shape.kind == "train":
            w = plan.num_workers
            pshapes = stack_worker_axis(params_shape(cfg), w)
            pspecs = plan.param_specs(pshapes, with_worker_axis=True)
            batch = train_input_specs(cfg, shape, w)
            bspecs = train_batch_specs(batch, plan)
            step_fn = build_train_step(
                cfg, plan, tau=tau, q=q, mixing=mixing, mix_dtype=mix_dtype,
                phase=PHASES[phase], remat=remat, impl=impl,
                microbatch=microbatch, accum_dtype=accum_dtype)
            per = step_fn.spmd.per_shard
            ranks = w // per
            step = tau * q                         # the hub step
            ran = (PHASES[phase] if PHASES[phase] is not None
                   else protocol.phase_of(step, tau, q))
            meta["phase_run"] = PHASE_NAMES[ran]
            rank_params = _rows(pshapes, per)
            with counter, flop_mode:
                step_fn(rank_params, _rows(batch, per), step)
            args = (_spec_bytes(pshapes, pspecs, plan, with_worker_axis=True)
                    + _spec_bytes(batch, bspecs, plan) + 4)
            outs = (_spec_bytes(pshapes, pspecs, plan, with_worker_axis=True)
                    + 3 * 4 * w)
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            ranks = 1
            pshapes = params_shape(cfg)
            pspecs = plan.param_specs(pshapes, with_worker_axis=False)
            batch = prefill_input_specs(cfg, shape)
            bspecs = serve_batch_specs(batch, plan)
            fn = prefill_fn_for(cfg, impl=impl, remat=remat)
            with counter, flop_mode, torch.no_grad():
                logits = fn(pshapes, batch)
            args = (_spec_bytes(pshapes, pspecs, plan)
                    + _spec_bytes(batch, bspecs, plan))
            outs = _spec_bytes({"logits": logits}, serve_batch_specs(
                {"logits": logits}, plan), plan)
            tokens = shape.global_batch * shape.seq_len
        else:  # decode
            ranks = 1
            pshapes = params_shape(cfg)
            pspecs = plan.param_specs(pshapes, with_worker_axis=False)
            state = model_mod.init_decode_state(cfg, shape.global_batch,
                                                shape.seq_len, device="meta")
            sspecs = decode_state_specs(state, plan)
            spec_d = decode_input_specs(cfg, shape)
            bspecs = serve_batch_specs(spec_d["batch"], plan)
            args = (_spec_bytes(pshapes, pspecs, plan)
                    + _spec_bytes(state, sspecs, plan)
                    + _spec_bytes(spec_d["batch"], bspecs, plan) + 4)
            with counter, flop_mode, torch.no_grad():
                nxt, new_state = serve_step(pshapes, state, spec_d["batch"],
                                            shape.seq_len - 1, cfg)
            outs = (_spec_bytes(new_state, decode_state_specs(new_state,
                                                              plan), plan)
                    + _spec_bytes({"next": nxt}, serve_batch_specs(
                        {"next": nxt}, plan), plan))
            tokens = shape.global_batch            # one token per sequence
    t_run = time.time()

    fleet = counter.costs.scaled(ranks)
    per_chip = fleet.scaled(1.0 / chips)
    out = dict(meta)
    rl = ca.roofline_terms(per_chip, chips)
    out.update({
        "chips": chips,
        "memory_analysis": {"argument_size_in_bytes": int(args),
                            "output_size_in_bytes": int(outs)},
        "hlo_costs": per_chip.as_dict(),
        "rank_costs": counter.costs.as_dict(),
        "roofline": rl.as_dict(),
        "raw_cost_analysis": {
            "flops": float(flop_mode.get_total_flops()) * ranks / chips},
    })
    # decode steps run in bf16/f32 mixes dominated by memory: MODEL_FLOPS
    # for decode is 2*N_active per token (fwd only); train is 6*N_active
    flops_per_tok = (6.0 if shape.kind == "train" else 2.0) * \
        cfg.active_param_count()
    out["model_flops"] = flops_per_tok * tokens
    global_flops = out["roofline"]["flops"]
    out["useful_fraction"] = (out["model_flops"] / global_flops
                              if global_flops else 0.0)
    out["run_s"] = round(t_run - t0, 2)
    out["compile_s"] = None
    return out


def ok_line(r: dict, phase: str) -> str:
    """The JAX module's ``OK`` line for one record."""
    rl = r["roofline"]
    return (f"OK  {r['arch']:24s} {r['shape']:12s} {r['mesh']:10s} "
            f"phase={phase:8s} compute={rl['compute_s']:.3e}s "
            f"memory={rl['memory_s']:.3e}s coll={rl['collective_s']:.3e}s "
            f"dom={rl['dominant']} run={r['run_s']}s")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry run on meta tensors: every combination's program, "
                    "counted on the H100 roofline (no card needed).")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--phase", default="dynamic", choices=tuple(PHASES))
    ap.add_argument("--mixing", default="dense",
                    choices=protocol.available_mixing())
    ap.add_argument("--mix-dtype", default=None)
    ap.add_argument("--remat", default="full", choices=("none", "full", "dots"))
    ap.add_argument("--impl", default="flash",
                    choices=("flash", "auto", "plain"),
                    help="flash: each kernel's meta branch (default); auto "
                         "and plain run the plain paths, the plain sLSTM a "
                         "Python loop over time (slow for xLSTM)")
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--granularity", default=None,
                    choices=(None, "worker_per_data", "worker_per_pod",
                             "worker_per_chip"))
    ap.add_argument("--moe-groups", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-hlo", default=None,
                    help="the port makes no HLO: writes the combination's "
                         "count (hlo_costs and rank_costs) to this path")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES]
              if args.all else [(args.arch, args.shape)])
    results = []
    for arch, shp in combos:
        try:
            r = run_one(arch, shp, multi_pod=args.multipod, phase=args.phase,
                        mixing=args.mixing, mix_dtype=args.mix_dtype,
                        remat=args.remat, tau=args.tau, q=args.q,
                        impl=args.impl, granularity=args.granularity,
                        moe_groups=args.moe_groups)
            print(ok_line(r, args.phase), flush=True)
            results.append(r)
            if args.save_hlo:
                with open(args.save_hlo, "w") as f:
                    json.dump({k: r[k] for k in ("hlo_costs", "rank_costs")},
                              f, indent=1)
        except Exception as e:
            traceback.print_exc()
            print(f"FAIL {arch} {shp}: {e}", flush=True)
            results.append({"arch": arch, "shape": shp, "error": str(e)})
            if not args.all:
                sys.exit(1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
