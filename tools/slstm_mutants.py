#!/usr/bin/env python3
"""Mutation check of the sLSTM scan kernels (``csrc/slstm_scan.cu``) on the
card: each mutant is a copy of the port with one deliberate fault in the
CUDA source, built and held against the plain versions as
`chip_smoke.py`'s xlstm-kernels phase holds the real kernels.

    python3 tools/slstm_mutants.py          # from the repository root, on a GPU

Mutants:

* ``gate``  -- K8 writes a zero gradient for the z gate;
* ``route`` -- K8 sends the stabiliser's adjoint dm always to the forget
  branch (the max routing dropped);
* ``order`` -- K8 walks the chunks first to last;
* ``slice`` -- every block of a cluster loads cluster rank 0's slice of R
  (K7 and K8);
* ``rank``  -- K8 sums the dh partials of one rank fewer than the cluster
  holds.

For each mutant and case it prints one JSON line: every output's error
over the check's tolerance (1e-4 of the output's scale), elementwise and
as a relative norm, and the worst of them.  A check that catches a mutant
shows it far above 1.  The copies go to ``build/mutants/`` (git-ignored),
each with its own build directory and only ``csrc/slstm_scan.cu`` of the
CUDA sources (the others are not needed here).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mutants"
MUTANTS = {
    "gate": ("dz[2] = dct * i_t * (1.f - tz * tz);", "dz[2] = 0.f;"),
    "route": ("const bool sel = a >= zi;", "const bool sel = true;"),
    "order": ("for (int tc = nt - 1; tc >= 0; --tc) {",
              "for (int tc = 0; tc < nt; ++tc) {"),
    "slice": ("const int j = rank * u + jj;", "const int j = jj;"),
    "rank": ("for (int q = 1; q < cs; ++q) sum += in[q * NR * u];",
             "for (int q = 1; q < cs - 1; ++q) sum += in[q * NR * u];"),
}
CASES = [(4, 512, 4, 384, 8, 128), (3, 200, 2, 32, 2, 64)]
TOL = 1e-4


def check(name: str) -> None:
    """Runs in the mutant's copy: K7 / K8 against the plain versions."""
    import torch

    from repro_torch.kernels import build, ops, ref
    build.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(dev).manual_seed(4)
    for b, t, h, hd, bb, chunk in CASES:
        zx = torch.randn(b, t, h, 4 * hd, generator=g, device=dev)
        r = torch.randn(h, hd, 4 * hd, generator=g, device=dev) / hd ** 0.5
        bias = 0.1 * torch.randn(h, 4 * hd, generator=g, device=dev)
        dh = torch.randn(b, t, h, hd, generator=g, device=dev)
        kw = dict(block_b=bb, chunk=chunk)
        hk, bk = ops.slstm_scan_fwd_res(zx, r, bias, **kw)
        hw, bw = ref.slstm_scan_fwd_res_ref(zx, r, bias, **kw)
        gk = ops.slstm_scan_bwd(zx, r, bias, bk, dh, **kw)
        gw = ref.slstm_scan_bwd_ref(zx, r, bias, bk, dh, **kw)
        out = {}
        for key, a, w in zip(["h", "hb", "cb", "nb", "mb", "dzx", "dR", "db"],
                             (hk, *bk, *gk), (hw, *bw, *gw)):
            scale = max(w.abs().max().item(), 1e-30)
            out[key] = dict(
                elem=(a - w).abs().max().item() / scale / TOL,
                norm=((a - w).norm() / w.norm().clamp(min=1e-30)).item() / TOL)
        print(json.dumps({"mutant": name, "case": [b, t, h, hd, bb, chunk],
                          "card": torch.cuda.get_device_name(0),
                          "worst_over_tolerance": max(
                              max(v.values()) for v in out.values()),
                          "over_tolerance": out}), flush=True)


def main() -> int:
    failed = 0
    for name, (old, new) in MUTANTS.items():
        copy = OUT / name
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch", copy / "src" /
                        "repro_torch", ignore=shutil.ignore_patterns(
                            "__pycache__"))
        for other in (copy / "src" / "repro_torch" / "csrc").glob("*.cu"):
            if other.name != "slstm_scan.cu":
                other.unlink()
        src = copy / "src" / "repro_torch" / "csrc" / "slstm_scan.cu"
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"mutant {name}: the line to change is not "
                             "found once in csrc/slstm_scan.cu")
        src.write_text(text.replace(old, new))
        env = dict(os.environ, PYTHONPATH=str(copy / "src"))
        res = subprocess.run([sys.executable, __file__, "--check", name],
                             cwd=copy, env=env, timeout=900)
        failed += res.returncode != 0
    return int(failed > 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check"]:
        check(sys.argv[2])
    else:
        sys.exit(main())
