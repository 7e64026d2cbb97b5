#!/usr/bin/env python3
"""Mamba's selective scan (`models.mamba._selective_scan_chunked`) against
the step-by-step loop it replaced, on one NVIDIA GPU, in one process.

    python3 tools/mamba_scan_probe.py       # from the repository root, ~1 min

Both run the forward and the backward of one mamba layer's scan at
jamba-v0.1-52b's width (B 1, L 2,048 in 8 chunks of 256, d_inner 8,192,
N 16; dt, A, B, C float32, u bf16 as the model feeds them) on the same
inputs (one seed on the card).  The loop is a copy of the port's scan
before the associative one: a Python loop over time steps inside each
chunk, differentiated by autograd, whose backward writes a whole zero
(B, chunk, d_inner, N) tensor per step.  Each is timed with
``chip_smoke.Timer`` (device time, cold L2, the stream held while the
host enqueues) in the order loop, scan, scan, loop; the loop's reps are
few, as it is slow.  One JSON line: ms of each run, peak memory above
the inputs, the scan's gradients against the loop's (relative norm
error per input, float32) and the card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

SHAPE = dict(B=1, L=2048, d_inner=8192, N=16)
REPS = {"loop": 2, "scan": 5}


def loop_scan(dt, a, b_mat, c_mat, u) -> torch.Tensor:
    """The scan as the port ran it before: chunks of `_chunk_size`, and in
    each a Python loop over its time steps."""
    bsz, l, di = u.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=u.device)
    csize = mamba._chunk_size(l)
    ys = []
    for lo in range(0, l, csize):
        sl = slice(lo, lo + csize)
        decay = torch.exp(dt[:, sl, :, None] * a)
        drive = ((dt[:, sl] * u[:, sl].float())[..., None]
                 * b_mat[:, sl, None, :])
        hs = []
        for i in range(decay.shape[1]):
            h = decay[:, i] * h + drive[:, i]
            hs.append(h)
        ys.append(torch.einsum("bcdn,bcn->bcd", torch.stack(hs, dim=1),
                               c_mat[:, sl]))
    return torch.cat(ys, dim=1)


def _inputs(device: torch.device, seed: int = 0) -> list[torch.Tensor]:
    g = torch.Generator(device).manual_seed(seed)
    b, l, di, n = SHAPE.values()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device)
    dt = torch.nn.functional.softplus(rnd(b, l, di) - 4.0)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=device
                      ).expand(di, n).contiguous()
    u = rnd(b, l, di).to(torch.bfloat16)
    return [x.requires_grad_() for x in (dt, a, rnd(b, l, n), rnd(b, l, n),
                                         u)]


def run(timer: cs.Timer, device: torch.device) -> dict:
    """-> the probe's JSON row (module docstring)."""
    ins = _inputs(device)
    dy = torch.randn(SHAPE["B"], SHAPE["L"], SHAPE["d_inner"],
                     generator=torch.Generator(device).manual_seed(1),
                     device=device)
    fns = {"loop": loop_scan, "scan": mamba._selective_scan_chunked}

    def step(name):
        return torch.autograd.grad(fns[name](*ins), ins, dy)
    grads = {name: [g.float() for g in step(name)] for name in fns}
    rel = {name: ((gs - gl).norm() / gl.norm()).item() for name, gs, gl in
           zip(("dt", "A", "B", "C", "u"), grads["scan"], grads["loop"])}
    del grads
    out = {"shape": SHAPE, "grad_rel_err_scan_vs_loop": rel, "runs": []}
    for name in ("loop", "scan", "scan", "loop"):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        st = timer.stats(lambda: step(name), REPS[name])
        out["runs"].append(dict(
            name=name, ms=st, peak_gib_above_inputs=(
                torch.cuda.max_memory_allocated(device) - held) / 2**30))
    for name in fns:
        out[f"{name}_ms"] = min(r["ms"]["mean"] for r in out["runs"]
                                if r["name"] == name)
    out["speedup"] = out["loop_ms"] / out["scan_ms"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("mamba_scan_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(json.dumps({**run(cs.Timer(device), device), "card": smi}),
          flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
