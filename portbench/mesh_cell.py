"""A training cell over a mesh of cards: one `torch.distributed` rank a
card, each holding its rows of the worker fleet, the mixing rounds the
port's collectives among them (`repro_torch.launch.mesh`).

The ranks are started through `repro_torch.launch.mesh.spawn` with
`rank_main`, which first gives each rank a disjoint set of host cores
(``cores_per_rank`` of the traffic mix, where the host has them) and a
small thread count, so that four processes on one host disturb each other
less.  Each rank runs `train_cell`'s set-up, window and traced window on
its rows; the window starts and ends at a barrier of all ranks.  Once its
window has closed, its peak memory been read and its state freed, each
rank sends back the program's readings of its rows, and rank 0 the plain
reference of the whole fleet: the compared ticks reach the first hub
event, which mixes every sub-network.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from portbench import cells, check, probe, program, train_cell


class Ranks:
    """The window's agreement among the ranks (the world's default
    group)."""

    def __init__(self, device):
        self.device = device

    def barrier(self) -> None:
        dist.barrier()

    def any(self, flag: bool) -> bool:
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)


def _pin(rank: int, world: int, per_rank: int, threads: int) -> str:
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= world * per_rank:
        os.sched_setaffinity(0, cores[rank * per_rank:(rank + 1) * per_rank])
    torch.set_num_threads(threads)
    return (f"rank {rank}: cores {sorted(os.sched_getaffinity(0))}, "
            f"{torch.get_num_threads()} threads")


def rank_main(cell: cells.Cell, seed: int, seconds: float, trace: bool,
              kind: str = "cuda") -> dict:
    """One rank: set-up, window (and the traced window), its readings;
    ``kind`` "cpu" runs the ranks on the host (tests)."""
    from repro_torch.launch.mesh import make_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    m = cell.traffic["mesh"]
    pinned = _pin(rank, world, m["cores_per_rank"],
                  cell.traffic["host_threads"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if kind == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    else:
        device = torch.device("cpu")
    mesh = make_mesh((m["workers"], m["data"]), ("workers", "data"))
    ranks = Ranks(device)
    ctx = train_cell.setup(cell, seed, seconds, device, mesh=mesh)
    readers = {}
    if trace:
        readers = {x["name"]: cells.metric_reader(x["name"])
                   for x in cell.per_layer}
        win, rec = train_cell.traced(ctx, cell, readers, seconds, device,
                                     ranks)
    else:
        win, rec = train_cell.window(ctx, seconds, device, ranks), None
    peak = torch.cuda.max_memory_allocated(device) if kind == "cuda" else 0
    retries = (torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
               if kind == "cuda" else 0)
    out = {"rank": rank, "pinned": pinned, "window": win, "peak": peak,
           "retries": retries, "readings": ctx["readings"], "rec": rec,
           "rows": (ctx["row0"], ctx["row0"] + ctx["rows"]),
           "flops_per_slot": ctx["flops_per_slot"]}
    train_cell.free(ctx)
    out["ref"] = None
    if rank == 0:
        out["ref"] = check.follow(
            cells.reference(cell.config["reference"]), cell.config,
            cell.traffic, ctx["batcher"].kept, seed, program.mll_seed(seed),
            device)
    out["forbidden"] = sorted({n.split(".")[0] for n in list(sys.modules)}
                              & {"jax", "jaxlib", "flax", "repro"})
    return out


def _joined(ranks: list[dict]) -> dict:
    """The fleet's readings from every rank's rows, in rank order."""
    loss = np.concatenate([r["readings"]["loss"] for r in ranks], axis=1)
    stats = []
    for t in range(len(ranks[0]["readings"]["stats"])):
        stats.append({k: np.concatenate([r["readings"]["stats"][t][k]
                                         for r in ranks], axis=1)
                      for k in ("norm", "proj")})
    return {"loss": loss, "stats": stats}


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        wall_start: float, *, kind: str = "cuda", log=print,
        rank_fn=None) -> dict:
    """Start the ranks, gather what they read, run the reference.  -> the
    result object.  ``kind`` "cpu" runs every rank on the host over gloo,
    and ``rank_fn`` (a module-level stand-in for `rank_main`) lets a test
    break the ranks' path."""
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_mod

    from portbench.run import device_info, end_to_end, per_layer
    if kind == "cuda":
        build.build_all()
    world = cell.traffic["mesh"]["workers"] * cell.traffic["mesh"]["data"]
    backend = cell.traffic["mesh"]["backend"] if kind == "cuda" else "gloo"
    ranks = mesh_mod.spawn(rank_fn or rank_main, world, cell, seed, seconds, trace,
                           kind, backend=backend, device=kind,
                           timeout=330.0)
    for r in ranks:
        log(r["pinned"])
        if r["forbidden"]:
            raise SystemExit(f"rank {r['rank']} loaded {r['forbidden']}")
    win = ranks[0]["window"]
    setup_s = win["wall_start"] - wall_start
    peak = max(r["peak"] for r in ranks)
    per = win["periods"]
    log(f"window {win['slots']} slots in {win['seconds']:.3f} s, set-up "
        f"{setup_s:.2f} s; periods min / median / max {min(per):.3f} / "
        f"{float(np.median(per)):.3f} / {max(per):.3f} s; allocator "
        f"retries {[r['retries'] for r in ranks]}")
    ref = ranks[0]["ref"]
    joined = _joined(ranks)
    got = check.numbers(joined, ref, cell.traffic)
    ok, table = check.verdict(got, cell.limits)
    log(f"numbers {json.dumps(got)}")
    log("reference done; worst gaps "
        f"{json.dumps(check.worst(joined, ref, cell.traffic))}")
    out = {"correct": ok, "attempted": win["slots"], "failed": 0}
    if trace:
        recs = [r["rec"] for r in ranks]
        rec = {"ranks": recs, "window": win, "rows": recs[0]["rows"],
               "flops_per_slot": ranks[0]["flops_per_slot"],
               "missing": sorted({t for x in recs for t in x["missing"]})}
        out["metrics"] = per_layer(cell, rec)
        dev = device_info(cell.chips, peak, kind)
        dev.update(busy_s=float(np.mean([x["profile"]["busy_s"]
                                          for x in recs])),
                   window_s=float(np.mean([x["profile"]["window_s"]
                                            for x in recs])))
        out["device"] = dev
        out["breakdown"] = probe.breakdown(recs[0]["profile"])
    else:
        rate = win["tokens"] / win["seconds"]
        out["metrics"] = end_to_end(cell, {
            "train_tokens_per_s": rate, "mesh_tokens_per_s": rate,
            "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s})
        out["device"] = device_info(cell.chips, peak, kind)
    out["checks"] = table
    return out
