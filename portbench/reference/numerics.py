"""The matrix product of the plain references, in the precision asked for.

``"float32"`` is the reference proper: float32 operands and accumulation,
TF32 switched off by the caller.  ``"fp8"`` is the control: every operand
rounded to float8 with one scale per tensor (e4m3 for the forward's
operands, e5m2 for the gradients of the backward, as fp8 training
recipes do), the products then taken in float32.
"""
from __future__ import annotations

import torch

_E4M3 = getattr(torch, "float8_e4m3fn", None)
_E5M2 = getattr(torch, "float8_e5m2", None)


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(a, b):
        return _fp8(a, _E4M3) @ _fp8(b, _E4M3)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        a8, b8, g8 = _fp8(a, _E4M3), _fp8(b, _E4M3), _fp8(g, _E5M2)
        return ((g8 @ b8.transpose(-1, -2)).sum_to_size(a.shape),
                (a8.transpose(-1, -2) @ g8).sum_to_size(b.shape))


def matmul(precision: str):
    """``mm(a, b)``: ``a @ b`` in ``precision`` ("float32" or "fp8")."""
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        if _E4M3 is None:
            raise RuntimeError("this torch has no float8 dtypes")
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")
