#!/usr/bin/env python3
"""The mesh path across four cards: `chip_smoke.py`'s "train-mesh" phase
with NCCL, one rank per card.

    python3 tools/mesh_nccl.py        # from the repository root, 4 cards

It builds the kernels, then runs `chip_smoke.phase_train_mesh` with
``backend="nccl"``: qwen2-0.5b at full width, W = 4 (2 x 2, ring), tau 2,
q 2, 4 slots through K3 + K4 under two_stage, ppermute, bf16 and dense,
once in one process on card 0 and once as four NCCL ranks on cards 0-3
(one worker each), whose fleet rows and u_k must be the one-process bits.
It logs the phase's lines (seconds per local and event slot, each event's
collectives, peak memory per rank, launches) and, last, every card's
name and power limit.  Without four cards it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if torch.cuda.device_count() < cs.MESH_RANKS:
        print(f"mesh_nccl: needs {cs.MESH_RANKS} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True).stdout.strip()
    cs.log("device", f"{cards.splitlines()}; torch {torch.__version__}, "
           f"CUDA {torch.version.cuda}")
    cs.log("build", f"nvcc seconds per source {cs.build.build_all()}")
    row = cs.phase_train_mesh(torch.device("cuda", 0), cs.nvidia_smi(),
                              backend="nccl")
    cs.log("train-mesh-nccl", f"launches {json.dumps(row['launches'])}, "
           f"world {row['world_seconds']:.1f} s, total "
           f"{time.perf_counter() - t0:.1f} s")
    print(cards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
