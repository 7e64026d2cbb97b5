"""Tolerances of the hand-written kernels against their plain versions in
`ref`, on the same inputs.

``chip_smoke.py`` holds every kernel to these on the card, and the CPU
model of the tensor-core rounding (``tests/test_torch_flash_tc.py``) shows
that the bf16 kernels' design uses at most half of them.

* `TOL`: K3 (o) and K6, elementwise ``atol + rtol * |want|``.  float32
  differs by summation order only; bf16 outputs may round to neighbouring
  bf16 values (2^-8 relative).
* `LSE_TOL`: K3's lse, float32 on both sides.
* `BWD_TOL`: K4's dq, dk and dv (and K7's / K8's outputs), each held to
  its own scale: every element within ``atol_of_max * max|want| + rtol *
  |want|`` and the relative norm error ``||got - want|| / ||want||`` within
  ``rel_norm`` (a loss-gradient ``do`` makes them ~1e-5, unit inputs ~10).
  float32 differs by summation order; bf16 by one rounding of each output
  (2^-9 relative).
"""
from __future__ import annotations

import torch

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)
BWD_TOL = {torch.float32: dict(atol_of_max=1e-4, rtol=1e-4, rel_norm=1e-4),
           torch.bfloat16: dict(atol_of_max=1e-2, rtol=1e-2, rel_norm=1e-2)}
