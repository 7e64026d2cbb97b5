#!/usr/bin/env python3
"""Where the paged flash-decode kernel (K6, ``csrc/flash_decode.cu``) spends
its time, on one NVIDIA GPU.

    python3 tools/decode_probe.py       # from the repository root, ~30 s

Times K6 (device time, cold L2, `chip_smoke.Timer`) at the qwen3-1.7b
geometry (16 / 8 heads of 128, bf16, pages of 16 tokens) over split
counts 1, 2, 4, 8 and 16:

* 4 lanes of 0, 64, 300 and 544 tokens each (544 is the serve path's
  longest lane): at 0 tokens only a block's fixed cost is left;
* one lane of 1,024 and of 4,096 tokens: with one split a block walks
  16 and 64 chunks of 64 tokens, so the difference over 48 chunks is the
  cost of a chunk.

Prints one JSON line per case (ms per split count, the split count the
wrapper chooses, ``host_ms``), then the derived fixed and per-chunk
costs, and the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SPLITS = (1, 2, 4, 8, 16)


def lanes(gen, lengths, nmax, h=16, hkv=8, hd=128, bs=16):
    b = len(lengths)
    nb = b * nmax + 1
    dev = gen.device
    q = torch.randn(b, h, hd, generator=gen, device=dev).bfloat16()
    kp = torch.randn(nb, bs, hkv, hd, generator=gen, device=dev).bfloat16()
    vp = torch.randn(nb, bs, hkv, hd, generator=gen, device=dev).bfloat16()
    tables = (torch.randperm(nb, generator=gen, device=dev)[:b * nmax]
              .int().reshape(b, nmax).contiguous())
    return q, kp, vp, tables, torch.tensor(lengths, dtype=torch.int32,
                                           device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    build.build_all()
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    gen = torch.Generator(dev).manual_seed(0)
    floor = torch.zeros(16, device=dev)
    print(json.dumps({"timer_floor_ms": timer.ms(lambda: floor.add_(1))}))
    cases = {f"4 lanes x {n}": ([n] * 4, 34) for n in (0, 64, 300, 544)}
    cases.update({f"1 lane x {n}": ([n], 256) for n in (1024, 4096)})
    ms = {}
    for name, (lengths, nmax) in cases.items():
        q, kp, vp, tables, lens = lanes(gen, lengths, nmax)
        ms[name] = {s: timer.ms(lambda: ops.flash_decode(
            q, kp, vp, tables, lens, num_splits=s)) for s in SPLITS}
        print(json.dumps({"case": name, "ms_by_splits": ms[name],
                          "chosen_splits": fa.decode_splits(q, kp, tables),
                          "host_ms": cs.host_ms(lambda: ops.flash_decode(
                              q, kp, vp, tables, lens))}))
    print(json.dumps({
        "fixed_ms (4 lanes x 0, 1 split)": ms["4 lanes x 0"][1],
        "chunk_ms (1 lane, 1 split, 4096 - 1024 tokens over 48 chunks)":
            (ms["1 lane x 4096"][1] - ms["1 lane x 1024"][1]) / 48}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
