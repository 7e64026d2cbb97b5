"""A training cell's set-up, window and traced window: in one process with
the whole worker fleet on one card, or on one rank of a mesh
(`mesh_cell`).

Set-up makes the weights from the seed on the card, builds the program's
harness and drives it through the plan's first slots, reading after each
of the first ``compare_steps`` ticks what `check` compares, then through
the rest of ``warmup_periods`` whole periods of the plan (tau * q slots:
every local, sub-network and hub shape).  The window then runs whole
periods through the same harness call until ``seconds`` have passed; its
rate is the fleet's tokens of every slot completed over the window's
whole time, from a device synchronise to the synchronise after the last
slot.  Once the window has closed and the peak memory has been read, the
program's state is freed and the plain reference follows the compared
ticks.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import cells, check, probe, program, traffic, yardstick
from repro_torch.core import protocol
from repro_torch.core.simulator import replicate
from repro_torch.data.pipeline import LMBatcher


def flops_per_slot(family, conf, n_params: int, tr: dict) -> float:
    w = tr["network"]["subnets"] * tr["network"]["workers_per_subnet"]
    b, s = tr["batch"]["sequences"], tr["batch"]["seq_len"]
    return w * yardstick.train_flops(n_params, s, b,
                                     family.quadratic_width(conf))


def count_params(tree) -> int:
    return sum(x.numel() for x in check._leaves(tree))


def setup(cell: cells.Cell, seed: int, seconds: float, device, *,
          mesh=None):
    """Everything up to the first timed slot.  -> a dict with the harness,
    the state, the plan, the data cursor and the compared readings.  On a
    mesh (a `repro_torch.launch.mesh.Mesh`), this rank's rows of the fleet
    only."""
    conf, tr = cell.config, cell.traffic
    family = cells.reference(conf["reference"])
    cfg = program.arch_config(conf)
    mll = program.mll_config(tr, seed)
    network, st = program.network_and_state(mll, tr, device)
    period = tr["plan"]["tau"] * tr["plan"]["q"]
    warm = period * tr["warmup_periods"]
    check.hub_tick(tr)
    steps = tr["compare_steps"]
    # the plan must outlast the window: 200 slots a second is far above
    # any cell's rate
    slots = warm + period * math.ceil(200 * seconds / period + 1)
    plan = program.plan(network, mll, tr, slots, seed)
    w = network.num_workers
    rows = w // mesh.shape[0] if mesh is not None else w
    x0 = family.make_params(conf, seed, device)
    n_params = count_params(x0)
    state = protocol.init_train_state(replicate(x0, rows), cfg=mll)
    del x0
    stream = traffic.token_stream(w, tr["tokens"]["per_worker"],
                                  conf["vocab_size"], seed,
                                  tr["tokens"]["zipf"])
    batcher = traffic.recorder(LMBatcher, steps)(
        stream, tr["batch"]["seq_len"], tr["batch"]["sequences"])
    rng = np.random.default_rng(seed)
    harness = program.harness(cfg, mll, st, plan, mesh=mesh)
    readings = {"loss": [], "stats": []}
    for s in range(steps):
        state, m = harness.run_span(state, plan, batcher, rng, s, s + 1)
        readings["loss"].append(m["loss"].float().cpu().numpy())
        x0 = check._leaves(family.make_params(conf, seed, device))
        readings["stats"].append(check.program_stats(state.params, x0, seed))
        del x0
    readings["loss"] = np.stack(readings["loss"])
    state, _ = harness.run_span(state, plan, batcher, rng, steps, warm)
    if not all(traffic.distinct_rows(b) for b in batcher.kept):
        raise RuntimeError("the compared batches repeat a row")
    return dict(family=family, harness=harness, state=state, plan=plan,
                batcher=batcher, rng=rng, slot=warm, period=period,
                readings=readings, mll=mll, rows=rows,
                row0=harness.rows.start,
                flops_per_slot=flops_per_slot(family, conf, n_params, tr),
                tokens_per_slot=(w * tr["batch"]["sequences"]
                                 * tr["batch"]["seq_len"]))


def window(ctx: dict, seconds: float, device, ranks=None) -> dict:
    """Whole periods of the plan until ``seconds`` have passed.  With
    ``ranks`` (a mesh's `mesh_cell.Ranks`) the window starts and ends at a
    barrier of all ranks, and every rank stops after the period in which
    any rank's clock passed ``seconds``."""
    h, plan, period = ctx["harness"], ctx["plan"], ctx["period"]
    if ranks is not None:
        ranks.barrier()
    program.sync(device)
    t0 = time.perf_counter()
    wall0 = time.time()
    start = ctx["slot"]
    ends = []
    while True:
        if ctx["slot"] + period > plan.slots:
            raise RuntimeError("the plan is shorter than the window")
        ctx["state"], _ = h.run_span(ctx["state"], plan, ctx["batcher"],
                                     ctx["rng"], ctx["slot"],
                                     ctx["slot"] + period)
        ctx["slot"] += period
        ends.append(time.perf_counter() - t0)
        done = ends[-1] >= seconds
        if ranks is not None:
            done = ranks.any(done)
        if done:
            break
    program.sync(device)
    if ranks is not None:
        ranks.barrier()
        program.sync(device)
    slots = ctx["slot"] - start
    return {"seconds": time.perf_counter() - t0, "slots": slots,
            "tokens": slots * ctx["tokens_per_slot"], "wall_start": wall0,
            "periods": list(np.diff([0.0] + ends))}


def traced(ctx: dict, cell: cells.Cell, readers: dict, seconds: float,
           device, ranks=None) -> tuple[dict, dict]:
    """The traced run's window (slot statistics and spans on), then one
    profiled period.  -> (the window, the records the readers take)."""
    p = probe.Probe(readers.values(), device).install()
    slot_stats: list = []
    ctx["harness"].slot_stats = slot_stats
    try:
        win = window(ctx, seconds, device, ranks)
        spans = {k: list(v) for k, v in p.spans.items()}
        ctx["harness"].slot_stats = None
        h, plan, period = ctx["harness"], ctx["plan"], ctx["period"]

        def one_period():
            ctx["state"], _ = h.run_span(ctx["state"], plan, ctx["batcher"],
                                         ctx["rng"], ctx["slot"],
                                         ctx["slot"] + period)
            ctx["slot"] += period
        prof = probe.profile(one_period, p)
    finally:
        p.uninstall()
    rec = {"rows": ctx["rows"],
           "window": win, "slots": slot_stats, "spans": spans,
           "profile": prof, "flops_per_slot": ctx["flops_per_slot"],
           "missing": p.missing}
    return win, rec


def reference_numbers(ctx: dict, cell: cells.Cell, seed: int, device
                      ) -> tuple[dict, dict]:
    """-> (the compared numbers, where their worst gaps lie)."""
    ref = check.follow(ctx["family"], cell.config, cell.traffic,
                       ctx["batcher"].kept, seed,
                       program.mll_seed(seed), device)
    return (check.numbers(ctx["readings"], ref, cell.traffic),
            check.worst(ctx["readings"], ref, cell.traffic))


def free(ctx: dict) -> None:
    for k in ("harness", "state", "plan"):
        ctx.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
