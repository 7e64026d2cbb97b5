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
* `LADDER_TOL`: one compressed hub round (`core.protocol`'s int8,
  int8_ef, int4_ef, bf16, topk_ef and powersgd) on the card against the
  same round on the CPU (`ladder_error`).  The v-weighted mean may round
  differently on the two (another summation order), so an integer rung
  may put a value one quantization level apart (2 max|x| / levels) and
  top-k may swap a kept and a dropped entry of nearly equal magnitude at
  its threshold; those "flips" are allowed on a share of the elements,
  every other element agrees to float32 rounding.  PowerSGD's QR may
  differ by float32 rounding over n rows and flip a factor column's sign
  (`align_columns`; the reconstruction P P^T M does not depend on it).
"""
from __future__ import annotations

import torch

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)
BWD_TOL = {torch.float32: dict(atol_of_max=1e-4, rtol=1e-4, rel_norm=1e-4),
           torch.bfloat16: dict(atol_of_max=1e-2, rtol=1e-2, rel_norm=1e-2)}

# per rung: elementwise atol_of_max * scale + rtol * |want| everywhere but
# on at most flip_share of the elements, which stay within
# flip_of_max * scale (scale: max |want| of the params leaf)
LADDER_TOL = {
    "int8": dict(atol_of_max=1e-5, rtol=1e-5, flip_share=0.01,
                 flip_of_max=2 / 127),
    "int8_ef": dict(atol_of_max=1e-5, rtol=1e-5, flip_share=0.01,
                    flip_of_max=2 / 127),
    "int4_ef": dict(atol_of_max=1e-5, rtol=1e-5, flip_share=0.01,
                    flip_of_max=2 / 7),
    "bf16": dict(atol_of_max=1e-5, rtol=1e-5, flip_share=0.0,
                 flip_of_max=0.0),
    "topk_ef": dict(atol_of_max=1e-5, rtol=1e-5, flip_share=0.01,
                    flip_of_max=1.0),
    "powersgd": dict(atol_of_max=1e-4, rtol=1e-4, flip_share=0.0,
                     flip_of_max=0.0),
}


def ladder_error(name: str, got: torch.Tensor, want: torch.Tensor,
                 scale: float | None = None) -> float:
    """Max abs error of one leaf of a compressed hub round (params, or a
    state leaf with ``scale`` = its params leaf's max |value|) against the
    CPU's; raises beyond `LADDER_TOL`."""
    tol = LADDER_TOL[name]
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if not want.numel():
        return 0.0
    scale = float(want.abs().max()) if scale is None else scale
    err = (got - want).abs()
    off = err > tol["atol_of_max"] * scale + tol["rtol"] * want.abs()
    share = float(off.double().mean())
    worst = float(err.max())
    if not torch.isfinite(got).all() or share > tol["flip_share"] or (
            off.any() and worst > tol["flip_of_max"] * scale):
        raise AssertionError(
            f"{name}: max abs err {worst:.3e} (scale {scale:.3e}), "
            f"{share:.2%} of elements beyond {tol}")
    return worst


def align_columns(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``got`` (..., c, r) with each of its r columns' sign flipped to
    agree with ``want``'s (PowerSGD's factors, up to column sign)."""
    got = got.detach().to(want.device, want.dtype)
    sign = torch.sign((got * want).sum(dim=-2, keepdim=True))
    return got * torch.where(sign == 0, torch.ones_like(sign), sign)
