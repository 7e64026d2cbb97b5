#!/usr/bin/env python3
"""Where the sLSTM scan kernels (K7 forward, K8 backward; ``csrc/slstm_scan.cu``)
spend their time, on one NVIDIA GPU, and how they compare with an older
checkout's on the same card.

    python3 tools/slstm_probe.py                # from the repository root, ~1 min
    git archive <commit> | tar -x -C build/base  # any git-ignored directory
    python3 tools/slstm_probe.py build/base     # the sweep, then the A/B

The sweep times K7 (with the chunk residuals) and K8 (with its dR / db
reduction), float32, chunk 128, by cluster size (each of 1, 2, 4, 8 and 16
blocks that `choose_cluster` would take on this card if it were the only
one offered) at xlstm-125m's width (H 4, hd 384) with 4 rows (B 4, the
training shape) and 8 rows (B 8), at the smoke width (hd 128) and at
hd 512 (R partly resident).  One JSON line per shape: ms per cluster size,
what each size uses (`launch_plan`), and the size the wrapper chooses.
Then K7 and K8 at the training shape at T 256 and 512: the difference over
256 steps is the cost of one step.

The A/B runs K7 and K8 at the training shape in each checkout, each in a
process of its own, in the order base, this, this, base, with the same
timing code (below) and the same inputs (from one seed on the card): one
JSON line per process.  Times are device times with a cold L2 and the
stream held by a device spin while the host enqueues the call, as
``chip_smoke.Timer`` measures them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, T, H, hd): the training shape, then 8 rows, the smoke width, hd 512
SWEEP = [(4, 512, 4, 384), (8, 512, 4, 384), (4, 512, 4, 128),
         (4, 512, 4, 512)]
TRAIN = (4, 512, 4, 384)
CHUNK = 128
REPS = 10


def _timer():
    import numpy as np
    import torch

    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")

    def ms(fn, reps: int = REPS) -> dict:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(10_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        t = [s.elapsed_time(e) for s, e in pairs]
        return {"mean": sum(t) / reps, "median": float(np.median(t)),
                "min": min(t), "max": max(t)}
    return ms


def _inputs(b, t, h, hd, seed=0):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    zx = torch.randn(b, t, h, 4 * hd, generator=g, device="cuda")
    r = torch.randn(h, hd, 4 * hd, generator=g, device="cuda") / hd ** 0.5
    bias = 0.1 * torch.randn(h, 4 * hd, generator=g, device="cuda")
    dh = torch.randn(b, t, h, hd, generator=g, device="cuda")
    return zx, r, bias, dh


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def measure(label: str) -> None:
    """K7 and K8 at the training shape, in whichever checkout is on the
    path (the ``ops`` wrappers of every checkout since K7 / K8 were
    ported take these arguments)."""
    import torch

    from repro_torch.kernels import build, ops
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = _timer()
    zx, r, bias, dh = _inputs(*TRAIN)
    kw = dict(block_b=8, chunk=CHUNK)
    h, bounds = ops.slstm_scan_fwd_res(zx, r, bias, **kw)
    dzx, dr, db = ops.slstm_scan_bwd(zx, r, bias, bounds, dh, **kw)
    print(json.dumps({
        "ab": label, "shape": dict(zip("BTH", TRAIN[:3]), hd=TRAIN[3],
                                   dtype="float32", block_b=8, chunk=CHUNK),
        "K7_ms": ms(lambda: ops.slstm_scan_fwd_res(zx, r, bias, **kw)),
        "K8_ms": ms(lambda: ops.slstm_scan_bwd(zx, r, bias, bounds, dh,
                                               **kw)),
        "checksums": [x.double().abs().sum().item() for x in (h, dzx, dr,
                                                            db)],
        "card": _smi()}), flush=True)


def sweep() -> None:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import slstm_scan as ss
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = _timer()
    floor = torch.zeros(16, device="cuda")
    print(json.dumps({"timer_floor_ms": ms(lambda: floor.add_(1))["mean"]}))
    for b, t, h, hd in SWEEP:
        zx, r, bias, dh = _inputs(b, t, h, hd)
        rows = ss._rows_compiled(b)
        out = {}

        def plans(cs):  # asked of the card only for a size that fits
            return [ss.cluster_plan(zx.device, hd, min(8, b), zx.dtype, bwd,
                                    cs) for bwd in (False, True)]
        for cs in ss.CLUSTER_SIZES:
            try:  # a size the wrapper's chooser could pick on this card
                ss.choose_cluster(hd, rows, lambda c: c == cs and min(
                    p["clusters_at_once"] for p in plans(c)) > 0)
            except ValueError:
                out[cs] = "not a size the wrapper takes here"
                continue
            _, bounds = ss._fwd(zx, r, bias, 8, CHUNK, True, cs)
            out[cs] = {
                "K7_ms": ms(lambda: ss._fwd(zx, r, bias, 8, CHUNK, True,
                                            cs))["mean"],
                "K8_ms": ms(lambda: ss._bwd(zx, r, bias, bounds, dh, 8,
                                            CHUNK, cs))["mean"],
                "K7_plan": plans(cs)[0], "K8_plan": plans(cs)[1]}
        print(json.dumps({
            "shape": {"B": b, "T": t, "H": h, "hd": hd, "rows": rows},
            "by_cluster": out,
            "chosen": [ss.launch_plan(zx, block_b=8, backward=bwd)["cluster"]
                       for bwd in (False, True)]}), flush=True)
        del zx, r, bias, dh
    per_t = {}
    for t in (256, 512):
        zx, r, bias, dh = _inputs(TRAIN[0], t, *TRAIN[2:])
        kw = dict(block_b=8, chunk=CHUNK)
        _, bounds = ss.slstm_scan_fwd_res(zx, r, bias, **kw)
        per_t[t] = (ms(lambda: ss.slstm_scan_fwd_res(zx, r, bias, **kw)),
                    ms(lambda: ss.slstm_scan_bwd(zx, r, bias, bounds, dh,
                                                 **kw)))
    print(json.dumps({
        "training shape by T": {t: {"K7_ms": a["mean"], "K8_ms": b["mean"]}
                                for t, (a, b) in per_t.items()},
        "us_per_step": {k: 1e3 * (per_t[512][i]["mean"]
                                  - per_t[256][i]["mean"]) / 256
                        for i, k in enumerate(("K7", "K8"))}}))
    print(_smi())


def main(base: Path | None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("slstm_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sweep()
    if base is None:
        return 0
    if not (base / "src" / "repro_torch").exists():
        raise SystemExit(f"{base} holds no checkout of the port")
    for label, root in (("base", base), ("this", ROOT), ("this", ROOT),
                        ("base", base)):
        root = root.resolve()
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--measure", label], cwd=root, check=True,
                       timeout=600,
                       env={**os.environ, "PYTHONPATH": str(root / "src")})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) > 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1]) if len(sys.argv) == 2 else None))
