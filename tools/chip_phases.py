#!/usr/bin/env python3
"""A few of `chip_smoke.py`'s phases alone, on one card.

    python3 tools/chip_phases.py remat    # phases train, remat, dryrun
    python3 tools/chip_phases.py mesh     # phase train-mesh
    python3 tools/chip_phases.py jamba    # the scan probe, train-jamba,
                                          # train-musicgen

It builds the kernels, then runs the named group of
`chip_smoke` phase functions: ``remat`` trains qwen3-1.7b at full width
(phase "train", for its local slot's seconds), then phases "remat" and
"dryrun" (the mfu of that local slot); ``mesh`` runs phase "train-mesh";
``jamba`` runs `tools/mamba_scan_probe.py`'s old-against-new scan, then
phases "train-jamba" and "train-musicgen".
Each phase logs its own lines and raises on a failed check.  Without a
card it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mamba_scan_probe  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main(argv: list[str]) -> int:
    if len(argv) != 1 or argv[0] not in ("remat", "mesh", "jamba"):
        print("usage: tools/chip_phases.py remat|mesh|jamba", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)            # the phases need a context
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log("build", f"nvcc seconds per source {build.build_all()}")
    if argv[0] == "mesh":
        cs.phase_train_mesh(device, smi)
    elif argv[0] == "jamba":
        timer = cs.Timer(device)
        cs.log("scan-probe", json.dumps(mamba_scan_probe.run(timer, device)))
        cs.phase_train_jamba(timer, device, smi)
        cs.phase_train_musicgen(device, smi)
    else:
        cfg = cs.get_config("qwen3-1.7b")
        trained, *_ = cs.phase_train(cfg, device, smi)
        local = float(np.median([
            t for s, t in enumerate(trained["slot_seconds"])
            if s > 0 and trained["plan"].op_ids[s] == 0]))
        del trained, _
        torch.cuda.empty_cache()
        remat = cs.phase_remat(cfg, device, smi)
        torch.cuda.empty_cache()
        cs.phase_dryrun(cfg, device, smi, remat, local)
    cs.log("report", f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
