#!/usr/bin/env python3
"""K3 / K4 and the qwen3-1.7b training slot in two checkouts of the port,
side by side on one card.

    git archive <commit> | tar -x -C build/base   # any git-ignored directory
    python3 tools/flash_ab.py build/base          # from the repository root, on a GPU

Each checkout runs in a process of its own, in the order base, this, this,
base, and builds its kernels into its own ``build/``.  A process prints one
JSON line per call it times, then runs the training phase of its own
``chip_smoke.py`` (qwen3-1.7b at full width, W = 4, 8 slots, and one
profiled slot), which prints its own lines: seconds per slot, device busy.

The calls: K3 (bf16) at the serve report shape, the training shape and the
sim shape, K4 (bf16) at the training shape, and SDPA forward and backward
at those shapes under each backend that runs.  Each is timed over 20
launches, each after a 128 MiB write that leaves L2 cold, two ways:
``spin`` holds the stream with a device spin while the host enqueues the
call, so the time is the device's alone (as ``chip_smoke.Timer`` times);
``nospin`` does without the spin, so a call whose host side outlasts the
flush adds host time.  ``host_ms`` is the host's time per call, 50 calls
back to back.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (name, B, T, H, Hkv, hd): the serve report shape, training, sim
FWD_SHAPES = [("serve", 3, 464, 16, 8, 128), ("train", 4, 128, 16, 8, 128),
              ("sim", 4, 128, 14, 2, 64)]
BWD_SHAPE = ("train", 4, 128, 16, 8, 128)
REPS = 20


def measure(label: str) -> None:
    """Runs inside one checkout, with its ``chip_smoke.py`` importable."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build.build_all()
    smi = cs.nvidia_smi()
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)

    def device_ms(fn, spin: bool) -> dict:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(REPS):
            flush.zero_()
            if spin:
                torch.cuda._sleep(10_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in pairs]
        return {"mean": sum(ms) / REPS, "median": float(np.median(ms)),
                "min": min(ms), "max": max(ms)}

    def host_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / 50

    def report(what: str, fn) -> None:
        print(json.dumps({"ab": label, "what": what,
                          "spin": device_ms(fn, True),
                          "nospin": device_ms(fn, False),
                          "host_ms": host_ms(fn), "card": smi}), flush=True)

    def sdpa(what: str, make) -> None:
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                     "CUDNN_ATTENTION", "MATH"):
            with sdpa_kernel(getattr(SDPBackend, name)):
                try:
                    fn = make()
                    fn()
                    torch.cuda.synchronize()
                except (RuntimeError, ValueError):   # refuses these inputs
                    continue
                report(f"{what} sdpa-{name.lower()}", fn)

    gen = torch.Generator(dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    for name, b, t, h, hkv, hd in FWD_SHAPES:
        q, k, v = rnd(b, t, h, hd), rnd(b, t, hkv, hd), rnd(b, t, hkv, hd)
        report(f"K3 {name}", lambda: cs.ops.flash_attention_fwd_res(q, k, v))
        # GQA expanded outside the call, as chip_smoke's yardstick does
        qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                      .transpose(1, 2) for x in (q, k, v))
        sdpa(f"K3 {name}", lambda: lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    name, b, t, h, hkv, hd = BWD_SHAPE
    q, k, v, do = rnd(b, t, h, hd), rnd(b, t, hkv, hd), rnd(b, t, hkv, hd), \
        rnd(b, t, h, hd)
    o, lse = cs.ops.flash_attention_fwd_res(q, k, v)
    report(f"K4 {name}",
           lambda: cs.ops.flash_attention_bwd(q, k, v, o, lse, do))
    report(f"K4 {name} delta", lambda: (do.float() * o.float()).sum(-1)
           .transpose(1, 2).contiguous())

    def sdpa_bwd():
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        return lambda: torch.autograd.grad(out, (qt, kt, vt),
                                           do.transpose(1, 2),
                                           retain_graph=True)
    sdpa(f"K4 {name}", sdpa_bwd)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    cfg = cs.get_config("qwen3-1.7b")
    out, mll, *_ = cs.phase_train(cfg, dev, smi, phase=f"train-{label}")
    cs.phase_train_profile(cfg, out, mll, dev, smi, phase=f"train-{label}")


def main(base: Path) -> int:
    if not (base / "chip_smoke.py").exists():
        raise SystemExit(f"{base} holds no checkout (no chip_smoke.py)")
    for label, root in (("base", base), ("this", ROOT), ("this", ROOT),
                        ("base", base)):
        root = root.resolve()
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--measure", label], cwd=root, check=True,
                       timeout=900, env={**os.environ, "PYTHONPATH":
                                         f"{root}:{root / 'src'}"})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
