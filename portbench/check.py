"""How `correct` is decided for a training cell.

Set-up drives the program's own harness through its first slots (the
window's own call and feed) and reads, after each of the first
``compare_steps`` ticks, per parameter leaf and worker row:

* ``norm``: the norm of the row's change since the start, ||x - x_0||;
* ``proj``: the change projected on a fixed random direction of the leaf,
  <x - x_0, r>, r ~ N(0, I) drawn from the seed (E <d, r>^2 = ||d||^2),

and each tick's per-worker loss.  After the window the plain reference
(`reference.mll` with the family's model) follows the same ticks from the
same weights and rows, and `numbers` compares:

* ``loss1`` / ``loss``: the largest relative gap of tick 1's loss (the
  forward pass from the same weights), and of any compared tick's;
* ``grad1``: the gap of the change's norm after tick 1 (the gradient as
  the optimizer took it: x_1 - x_0 = -eta theta g), the worst leaf;
* ``mix_subnet``: after the first sub-network event (tick tau), the gap
  of the projection's difference between two workers of one sub-network,
  which the event makes equal (both sides read exactly zero when it
  does), the worst leaf;
* ``mix_hub``: the same after the first hub event (tick tau * q, which
  the compared ticks have to reach), between any two workers of the
  fleet: the hub stage mixes every sub-network;
* ``change``: the gap of the change's norm after the last compared tick,
  of the median leaf (each leaf's worst row): after several ticks the
  worst leaf is the noise of a few leaves whose updates lie under the
  bfloat16 resolution of their values (PERF.md);

each gap of a leaf measured against the reference's change of that leaf
or of the median leaf, whichever is larger.  A cell compares the numbers
its limits file lists.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out (they move by rounding alone).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import mll as ref_mll
from portbench.reference import numerics

NUMBERS = ("loss1", "loss", "grad1", "mix_subnet", "mix_hub", "change")
_PROJ_SEED = 0x5EED


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [x for v in tree for x in _leaves(v)]


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted paths of `_leaves`, in its order."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [n for k, v in items
            for n in leaf_names(v, f"{prefix}.{k}" if prefix else str(k))]


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return [build(v) for v in node]
    return build(like)


def _direction(i: int, shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1000003 + i * 7919 + _PROJ_SEED) % (2 ** 62))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


@torch.no_grad()
def stats(rows: list[list[torch.Tensor]], x0: list[torch.Tensor],
          seed: int) -> dict:
    """{"norm", "proj"}: (leaves, rows) float64 arrays; ``rows[w][i]`` is
    worker row w's leaf i (any dtype), ``x0[i]`` the leaf's start."""
    n_leaf, n_row = len(x0), len(rows)
    norm = np.zeros((n_leaf, n_row))
    proj = np.zeros((n_leaf, n_row))
    for i, start in enumerate(x0):
        r = _direction(i, start.shape, seed, start.device)
        s32 = start.float()
        for w in range(n_row):
            d = rows[w][i].float() - s32
            norm[i, w] = float(torch.linalg.vector_norm(d))
            proj[i, w] = float((d * r).sum())
            del d
        del r, s32
    return {"norm": norm, "proj": proj}


def program_stats(params, x0: list[torch.Tensor], seed: int) -> dict:
    """`stats` of a stacked (W, ...) fleet."""
    leaves = _leaves(params)
    rows = [[x[w] for x in leaves] for w in range(leaves[0].shape[0])]
    return stats(rows, x0, seed)


def follow(family, conf: dict, traffic: dict, batches: list[dict],
           seed: int, gate_seed: int, device, *, precision: str = "float32",
           fault: str | None = None) -> dict:
    """The reference's first ``len(batches)`` ticks of the whole fleet
    from ``family.make_params(conf, seed)``: {"loss": (ticks, W), "gnorm":
    (leaves, W) tick 1's gradient norms, "stats": [per tick `stats`]}.

    ``precision`` "fp8" is the control; ``fault`` plants one of the
    faults a training cell can have in the reference put in the
    program's place: "unchanged" (the ticks return their state),
    "half_batch" (each loss over the first half of the rows),
    "no_exchange" (the mixing events left out), "no_hub" (the hub events
    alone left out), "altered" (worker 0's tick-1 gradient produced with
    the wrong sign)."""
    mm = numerics.matmul(precision)
    net, proto, plan = traffic["network"], traffic["protocol"], \
        traffic["plan"]
    ops = ref_mll.operators(net)
    x0_tree = family.make_params(conf, seed, device)
    x0 = _leaves(x0_tree)
    w = net["subnets"] * net["workers_per_subnet"]
    rows = [[x.clone() for x in x0] for _ in range(w)]
    losses = np.zeros((len(batches), w))
    gnorm = np.zeros((len(x0), w))
    skip = {"unchanged": ("subnet", "hub"), "no_exchange": ("subnet", "hub"),
            "no_hub": ("hub",)}.get(fault, ())
    out = []
    for k, batch in enumerate(batches, start=1):
        theta = ref_mll.gate(gate_seed, k, net["rates"])
        tokens, labels = (batch[n].to(device) for n in ("tokens", "labels"))
        if fault == "half_batch":
            half = tokens.shape[1] // 2
            tokens, labels = tokens[:, :half], labels[:, :half]
        for i in range(w):
            p32 = [x.float().requires_grad_() for x in rows[i]]
            loss = family.loss(_unflatten(x0_tree, p32), tokens[i],
                               labels[i], conf, mm)
            grads = torch.autograd.grad(loss, p32)
            del p32
            losses[k - 1, i] = float(loss.detach())
            if k == 1:
                gnorm[:, i] = [float(torch.linalg.vector_norm(g))
                               for g in grads]
            if fault == "altered" and k == 1 and i == 0:
                grads = [-g for g in grads]
            if fault != "unchanged":
                rows[i] = [ref_mll.sgd_update(x, g, proto["eta"],
                                              float(theta[i]))
                           for x, g in zip(rows[i], grads)]
            del grads, loss
        ph = ref_mll.phase(k, plan["tau"], plan["q"])
        if ph != "local" and ph not in skip:
            t = ops["V"] if ph == "subnet" else ops["Z"]
            for j in range(len(x0)):
                mixed = ref_mll.mix([r[j] for r in rows], t)
                for r, m in zip(rows, mixed):
                    r[j] = m
        out.append(stats(rows, x0, seed))
    return {"loss": losses, "gnorm": gnorm, "stats": out,
            "names": leaf_names(x0_tree)}


def hub_tick(traffic: dict) -> int:
    """The first hub event's tick, which the compared ticks reach."""
    plan = traffic["plan"]
    tick = plan["tau"] * plan["q"]
    if traffic["compare_steps"] < tick:
        raise ValueError(f"compare_steps {traffic['compare_steps']} ends "
                         f"before the first hub event, tick {tick}")
    return tick


def _scale(ref_norm: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Per (leaf, row): the larger of the reference's change of the leaf
    and the median kept leaf's change of that row (of all moving rows
    where the row did not move)."""
    kept = ref_norm[keep]
    med_row = np.median(kept, axis=0)
    moving = kept[:, med_row > 0]
    floor = np.median(moving) if moving.size else 1.0
    med_row = np.where(med_row > 0, med_row, floor)
    return np.maximum(ref_norm, med_row[None, :])


def _gaps(prog: dict, ref: dict, keep: np.ndarray, tick: int) -> np.ndarray:
    p, r = prog["stats"][tick - 1], ref["stats"][tick - 1]
    return np.abs(p["norm"] - r["norm"]) / _scale(r["norm"], keep)


def _mix_gaps(prog: dict, ref: dict, keep: np.ndarray, tick: int,
              group: int) -> np.ndarray:
    """(leaves, rows): each row's largest gap to the other rows of its
    group (``group`` consecutive rows: a sub-network, or the fleet)."""
    p, r = prog["stats"][tick - 1], ref["stats"][tick - 1]
    scale = _scale(r["norm"], keep)
    out = np.zeros_like(scale)
    for a in range(scale.shape[1]):
        lo = a // group * group
        for b in range(lo, lo + group):
            gap = np.abs((p["proj"][:, a] - p["proj"][:, b])
                         - (r["proj"][:, a] - r["proj"][:, b]))
            out[:, a] = np.maximum(out[:, a], gap / scale[:, a])
    return out


def _keep(ref: dict) -> np.ndarray:
    g = ref["gnorm"].max(axis=1)
    return g >= 1e-3 * np.median(g)


def gap_tables(prog: dict, ref: dict, traffic: dict) -> dict:
    """{number: (leaves, rows) gaps}, and ``loss``: (ticks, rows)."""
    keep = _keep(ref)
    net = traffic["network"]
    ticks = _ticks(ref, traffic)
    out = {"loss": np.abs(prog["loss"] - ref["loss"]) / np.abs(ref["loss"]),
           "grad1": _gaps(prog, ref, keep, 1),
           "change": _gaps(prog, ref, keep, ticks["change"]),
           "mix_subnet": _mix_gaps(prog, ref, keep, ticks["mix_subnet"],
                                   net["workers_per_subnet"]),
           "mix_hub": _mix_gaps(prog, ref, keep, ticks["mix_hub"],
                                net["subnets"] * net["workers_per_subnet"])}
    return out


def _ticks(ref: dict, traffic: dict) -> dict:
    """The tick each leaf-wise number is read after."""
    return {"grad1": 1, "mix_subnet": traffic["plan"]["tau"],
            "mix_hub": hub_tick(traffic), "change": len(ref["stats"])}


def numbers(prog: dict, ref: dict, traffic: dict) -> dict:
    """The compared numbers (`NUMBERS`) from the program's and the
    reference's readings: the worst kept leaf and row of each."""
    keep = _keep(ref)
    tables = gap_tables(prog, ref, traffic)
    out = {k: float(v.max() if k == "loss" else v[keep].max())
           for k, v in tables.items()}
    out["loss1"] = float(tables["loss"][0].max())
    out["change"] = float(np.median(tables["change"][keep].max(axis=1)))
    return out


def worst(prog: dict, ref: dict, traffic: dict, n: int = 3) -> dict:
    """Where each number's worst gaps lie: [leaf, row, gap, program's
    reading, reference's reading] of the ``n`` worst (ticks for loss)."""
    keep = _keep(ref)
    out = {}
    for k, v in gap_tables(prog, ref, traffic).items():
        if k == "loss":
            idx = np.argsort(v, axis=None)[::-1][:n]
            out[k] = [[f"tick {t + 1}", int(w), float(v[t, w]),
                       float(prog["loss"][t, w]), float(ref["loss"][t, w])]
                      for t, w in zip(*np.unravel_index(idx, v.shape))]
            continue
        v = np.where(keep[:, None], v, -1.0)
        tick = _ticks(ref, traffic)[k]
        kind = "proj" if k.startswith("mix") else "norm"
        idx = np.argsort(v, axis=None)[::-1][:n]
        out[k] = [[ref["names"][i], int(w), float(v[i, w]),
                   float(prog["stats"][tick - 1][kind][i, w]),
                   float(ref["stats"][tick - 1][kind][i, w])]
                  for i, w in zip(*np.unravel_index(idx, v.shape))]
    return out


def verdict(got: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the cell's limits list within its limit, {name:
    {"value", "limit"}}); a number not worked out reads NaN and fails."""
    table = {k: {"value": got.get(k, float("nan")), "limit": limits[k]}
             for k in NUMBERS if k in limits}
    ok = bool(table) and all(np.isfinite(v["value"])
                             and v["value"] <= v["limit"]
                             for v in table.values())
    return ok, table
