#!/usr/bin/env python3
"""Why the bf16 xlstm-125m gradient differs between the sLSTM scan's two
paths at full depth, on the card.

    python3 tools/xlstm_grad_conditioning.py   # from the repository root, on a GPU

One worker of xlstm-125m at full width and depth (6 super-blocks of
(mLSTM, sLSTM), seeded random weights) on one batch of 4 x 512 tokens, as
`chip_smoke.py`'s xlstm-parity phase takes it.  Each sLSTM layer's scan
runs three ways: K7 / K8 (``impl="flash"``), the plain cell loop
(``impl="plain"``) and the scan's plain version in float64 with each
output rounded once to its dtype (the exact recurrence as far as the
outputs can hold it).  It prints one JSON line per reading:

* ``pairs`` -- for the compute dtype bfloat16 and then float32, each pair
  of the three gradients: the relative norm error per leaf (median, max)
  and its median per (super-block, position), from the top of the stack
  down;
* ``bf16_vs_f32`` -- the cell loop's bf16 gradient against its float32
  one: how far bf16 training is from the float32 gradient at all;
* ``sensitivity`` -- float32, the exact scan with its output h multiplied
  by (1 + eps * N(0, 1)) for a few eps, against the unperturbed exact
  scan: the gradient's error over eps is the stack's gain for a relative
  perturbation of the sLSTM output;
* ``mlstm_normaliser`` -- per mLSTM layer (float32 forward), the share of
  (row, step, head) on the ``exp(-m)`` branch of the normaliser
  max(|sum_s w|, exp(-m)), the share within 1% of the tie between the two
  branches, and quantiles of the cancellation factor
  sum_s |w| / max(|sum_s w|, exp(-m)), by which the normaliser magnifies a
  relative error of its terms.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.train.train_step import loss_fn  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

EPS = (1e-7, 1e-5, 2.0 ** -9)


class ExactScan:
    """Routes the sLSTM scan's autograd Function (`ops.slstm_scan`) to the
    scan's plain versions in float64, each output rounded once to its
    dtype; with ``eps`` the forward's h is multiplied by
    (1 + eps * N(0, 1)) from a seeded draw."""

    def __init__(self, eps: float = 0.0, seed: int = 0):
        self.eps, self.seed = eps, seed

    def _noisy(self, h: torch.Tensor) -> torch.Tensor:
        if self.eps == 0.0:
            return h
        g = torch.Generator(h.device).manual_seed(self.seed)
        self.seed += 1
        return h * (1 + self.eps * torch.randn(h.shape, generator=g,
                                               device=h.device,
                                               dtype=h.dtype))

    def __enter__(self):
        self._saved = (ops.slstm_scan_fwd_res, ops.slstm_scan_bwd)

        def fwd_res(zx, r, b, **kw):
            h, bounds = ref.slstm_scan_fwd_res_ref(zx.double(), r.double(),
                                                   b.double(), **kw)
            return self._noisy(h).to(zx.dtype), bounds

        def bwd(zx, r, b, bounds, dh, **kw):
            dzx, dr, db = ref.slstm_scan_bwd_ref(
                zx.double(), r.double(), b.double(), bounds, dh.double(), **kw)
            return dzx.to(zx.dtype), dr.to(r.dtype), db.to(b.dtype)
        ops.slstm_scan_fwd_res, ops.slstm_scan_bwd = fwd_res, bwd
        return self

    def __exit__(self, *exc):
        ops.slstm_scan_fwd_res, ops.slstm_scan_bwd = self._saved


def grads(cfg, worker, batch, scan: str, eps: float = 0.0):
    """-> (leaf names, gradient leaves, loss) with the scan run as
    ``scan``: "kernel", "loop" or "exact"."""
    if scan == "exact":
        with ExactScan(eps):
            return cs._worker_grads(cfg, worker, batch, "flash")
    return cs._worker_grads(cfg, worker, batch,
                            "flash" if scan == "kernel" else "plain")


def by_layer(names: list, rel: list) -> dict:
    """Median relative error per (super-block, position), top first."""
    groups: dict[str, list] = {}
    for n, r in zip(names, rel):
        if n.startswith("blocks::"):
            key = f"{n.split('[')[-1][:-1]}/{n.split('::')[1]}"
        else:
            key = n.split("::")[0]
        groups.setdefault(key, []).append(r)
    order = sorted(groups, key=lambda k: (-int(k.split("/")[0]), k)
                   if "/" in k else (1, k))
    return {k: float(np.median(groups[k])) for k in order}


def summary(names, a, b) -> dict:
    rel = cs._rel_errors(a, b)
    return {"median": float(np.median(rel)), "max": max(rel),
            "by_layer": by_layer(names, rel)}


def normaliser_stats(params: dict, x: torch.Tensor, cfg) -> dict:
    """The mLSTM normaliser at one layer's input x, as `mlstm_train`
    computes it."""
    _, dp, h = xlstm_mod._dims(cfg)
    q, k, _, ig, fg, _ = xlstm_mod._mlstm_qkv(params, x, cfg)
    b, l = ig.shape[:2]
    cum = torch.cumsum(F.logsigmoid(fg), dim=1)
    dmat = cum[:, :, None, :] - cum[:, None, :, :] + ig[:, None, :, :]
    tri = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    dmat = dmat.masked_fill(~tri[None, :, :, None], -math.inf)
    m = dmat.amax(dim=2, keepdim=True)
    w = torch.einsum("bthk,bshk->btsh", q.float(), k.float()) \
        / math.sqrt(dp // h) * torch.exp(dmat - m)
    s, floor = w.sum(dim=2).abs(), torch.exp(-m[:, :, 0])
    norm = torch.maximum(s, floor)
    factor = (w.abs().sum(dim=2) / norm).flatten()
    qs = torch.quantile(factor, torch.tensor([0.5, 0.9, 0.99, 0.999],
                                             device=x.device))
    return {"floor_branch": (floor > s).float().mean().item(),
            "near_tie": ((s - floor).abs() <= 0.01 * norm).float().mean()
            .item(),
            "factor_q50_q90_q99_q999": qs.tolist(),
            "factor_max": factor.max().item()}


def main() -> int:
    if not torch.cuda.is_available():
        print("xlstm_grad_conditioning: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    run(get_config("xlstm-125m"), torch.device("cuda", 0), cs.nvidia_smi())
    return 0


def run(base, dev: torch.device, card: str) -> None:
    """Every reading, for the config ``base`` on ``dev``."""
    f32 = dataclasses.replace(base, param_dtype="float32",
                              compute_dtype="float32")
    worker = init_model(torch.Generator(dev).manual_seed(0), base, dev)
    batch = cs._parity_batch(base, 512, dev)

    def emit(kind, **kw):
        print(json.dumps({"reading": kind, "card": card, **kw}), flush=True)

    loops = {}
    for cfg in (base, f32):
        w = tree_map(lambda x: x.to(getattr(torch, cfg.param_dtype))
                     if x.dtype == torch.bfloat16 else x, worker)
        res = {s: grads(cfg, w, batch, s) for s in ("kernel", "loop", "exact")}
        names = res["kernel"][0]
        loops[cfg.compute_dtype] = res["loop"][1]
        for a, b in (("kernel", "loop"), ("kernel", "exact"),
                     ("loop", "exact")):
            emit("pairs", dtype=cfg.compute_dtype, pair=f"{a} vs {b}",
                 loss=[res[a][2], res[b][2]],
                 **summary(names, res[a][1], res[b][1]))
    emit("bf16_vs_f32", pair="loop bfloat16 vs loop float32",
         **summary(names, loops["bfloat16"], loops["float32"]))

    w32 = tree_map(lambda x: x.float(), worker)
    _, exact, _ = grads(f32, w32, batch, "exact")
    for eps in EPS:
        _, got, _ = grads(f32, w32, batch, "exact", eps)
        s = summary(names, got, exact)
        emit("sensitivity", eps=eps, gain_median=s["median"] / eps, **s)

    inputs = []
    train = xlstm_mod.mlstm_train

    def record(params, x, cfg):
        inputs.append((params, x))
        return train(params, x, cfg)
    xlstm_mod.mlstm_train = record
    try:
        with torch.no_grad():
            loss_fn(w32, {k: v[0] for k, v in batch.items()}, f32)
    finally:
        xlstm_mod.mlstm_train = train
    with torch.no_grad():
        for i, (params, x) in enumerate(inputs):
            emit("mlstm_normaliser", layer=i, **normaliser_stats(params, x,
                                                                 f32))


if __name__ == "__main__":
    sys.exit(main())
