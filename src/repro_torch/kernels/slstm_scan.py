"""Launches of the hand-written CUDA sLSTM scan kernels.

Counterpart of `repro/kernels/slstm_scan.py`:

* `slstm_scan` / `slstm_scan_fwd_res` launch the forward of
  ``csrc/slstm_scan.cu`` (replaces `_fwd_kernel` behind `_fwd_call`, the
  TPU recurrence that keeps (h, c, n, m) on chip across the T chunks);
* `slstm_scan_bwd` launches its backward and the dR / db reduction
  (replaces `_bwd_kernel`, the TPU reverse-time scan; the TPU wrapper's sum
  of per-batch-block partials is the reduction kernel's fixed-order sum).

The public contract is the JAX package's: ``zx`` (B, T, H, 4hd) gate
pre-activations laid out [i|f|z|o] per head, float32 or bfloat16;
``r_gates`` (H, hd, 4hd) and ``b_gates`` (H, 4hd) float32; ``block_b``
rows per block and ``chunk`` steps per chunk, clamped to B and T; the four
chunk-boundary residuals (h, c, n, m) each (Bp, T/chunk, H, hd) float32 in
padded-batch layout (Bp = B rounded up to ``block_b``).  Nothing is padded
or copied: the kernels mask the ragged batch and time edges themselves
(padded rows run the recurrence on zero input in the forward, as the TPU
kernel's zero-padded rows do, and carry zero adjoints in the backward).

All take CUDA tensors only and raise on anything the kernels do not take:
another device or dtype, head_dim above 512, block_b above 8, a shape that
does not fit, a tensor that is not contiguous.  Outputs and scratch are
allocated here with ``torch.empty``; the kernels launch on PyTorch's
current stream and do not synchronise.  The wrappers in `ops` choose
between these and the plain versions in `ref` by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPE_CODES, _check,
                                                 _check_tensors,
                                                 _raise_on_error, _stream)
from repro_torch.kernels.ref import slstm_geometry

MAX_HEAD_DIM = 512
MAX_BLOCK_B = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 8 + [_I] * 7 + [_P]
_BWD_ARGS = [_P] * 15 + [_I] * 7 + [_P]


def _rows_compiled(block_b: int) -> int:
    """The kernels' compiled row count: block_b rounded up to 1, 2, 4, 8."""
    return next(n for n in (1, 2, 4, 8) if block_b <= n)


def _check_inputs(what: str, zx: torch.Tensor, r_gates: torch.Tensor,
                  b_gates: torch.Tensor, block_b: int, chunk: int
                  ) -> tuple[int, int, int, int, int, int, int, int]:
    """-> (B, T, H, hd, block_b, chunk, Bp, T/chunk) after the checks."""
    _check(what, zx.is_cuda, "zx must be a CUDA tensor")
    _check_tensors(what, zx.device, zx=zx, r_gates=r_gates, b_gates=b_gates)
    _check(what, zx.dtype in DTYPE_CODES,
           f"zx dtype {zx.dtype} not supported (float32 or bfloat16)")
    _check(what, r_gates.dtype == torch.float32
           and b_gates.dtype == torch.float32,
           "r_gates and b_gates must be float32")
    _check(what, zx.dim() == 4 and zx.shape[-1] % 4 == 0
           and zx.shape[0] > 0 and zx.shape[1] > 0,
           f"zx must be (B > 0, T > 0, H, 4hd), got {tuple(zx.shape)}")
    bsz, t, h, hd4 = zx.shape
    hd = hd4 // 4
    _check(what, 0 < hd <= MAX_HEAD_DIM,
           f"head_dim {hd} not supported on CUDA (1 to {MAX_HEAD_DIM}: one "
           "thread per hidden unit)")
    _check(what, tuple(r_gates.shape) == (h, hd, hd4)
           and tuple(b_gates.shape) == (h, hd4),
           f"r_gates {tuple(r_gates.shape)} / b_gates "
           f"{tuple(b_gates.shape)} must be (H, hd, 4hd) / (H, 4hd) for zx "
           f"{tuple(zx.shape)}")
    _check(what, block_b > 0 and chunk > 0,
           f"block_b {block_b} and chunk {chunk} must be positive")
    block_b, chunk, bp, nt = slstm_geometry(bsz, t, block_b, chunk)
    _check(what, block_b <= MAX_BLOCK_B,
           f"block_b {block_b} not supported on CUDA (at most {MAX_BLOCK_B} "
           "rows per block)")
    return bsz, t, h, hd, block_b, chunk, bp, nt


def _fwd(zx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
         block_b: int, chunk: int, save_bounds: bool):
    what = "slstm_scan (csrc/slstm_scan.cu)"
    bsz, t, h, hd, block_b, chunk, bp, nt = _check_inputs(
        what, zx, r_gates, b_gates, block_b, chunk)
    out = torch.empty((bsz, t, h, hd), dtype=zx.dtype, device=zx.device)
    bounds = tuple(torch.empty((bp, nt, h, hd), dtype=torch.float32,
                               device=zx.device)
                   for _ in range(4)) if save_bounds else None
    ptrs = [b.data_ptr() for b in bounds] if save_bounds else [None] * 4
    fn = build.load("slstm_scan", "slstm_fwd", _FWD_ARGS)
    err = fn(zx.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(),
             out.data_ptr(), *ptrs, bsz, t, h, hd, block_b, chunk,
             DTYPE_CODES[zx.dtype], _stream(zx.device))
    _raise_on_error(what, err)
    return out, bounds


def slstm_scan(zx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               *, block_b: int = 8, chunk: int = 128) -> torch.Tensor:
    """The recurrence without residuals -> h (B, T, H, hd) in zx's dtype."""
    return _fwd(zx, r_gates, b_gates, block_b, chunk, False)[0]


def slstm_scan_fwd_res(zx: torch.Tensor, r_gates: torch.Tensor,
                       b_gates: torch.Tensor, *, block_b: int = 8,
                       chunk: int = 128):
    """-> (h, (h, c, n, m) entering each chunk), each bound (Bp, T/chunk,
    H, hd) float32."""
    return _fwd(zx, r_gates, b_gates, block_b, chunk, True)


def slstm_scan_bwd(zx: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor, bounds, dh: torch.Tensor, *,
                   block_b: int = 8, chunk: int = 128):
    """Reverse-time scan: (zx, R, b, chunk-boundary states, dh) -> (dzx in
    zx's dtype, dR (H, hd, 4hd), db (H, 4hd) float32)."""
    what = "slstm_scan_bwd (csrc/slstm_scan.cu)"
    bsz, t, h, hd, block_b, chunk, bp, nt = _check_inputs(
        what, zx, r_gates, b_gates, block_b, chunk)
    _check(what, len(bounds) == 4, "bounds must be the four (h, c, n, m)")
    hb, cb, nb, mb = bounds
    _check_tensors(what, zx.device, hb=hb, cb=cb, nb=nb, mb=mb, dh=dh)
    _check(what, all(x.dtype == torch.float32
                     and tuple(x.shape) == (bp, nt, h, hd) for x in bounds),
           f"chunk-boundary residuals {[tuple(x.shape) for x in bounds]} do "
           f"not match the padded layout {(bp, nt, h, hd)} float32: forward "
           "and backward must use the same block_b/chunk")
    _check(what, dh.dtype == zx.dtype and tuple(dh.shape) == (bsz, t, h, hd),
           f"dh must be {(bsz, t, h, hd)} in zx's dtype {zx.dtype}, got "
           f"{tuple(dh.shape)} {dh.dtype}")
    dev = zx.device
    rt = r_gates.transpose(1, 2).contiguous()          # (H, 4hd, hd)
    dzx = torch.empty_like(zx)
    dz32 = (torch.empty(zx.shape, dtype=torch.float32, device=dev)
            if zx.dtype != torch.float32 else None)
    hprev = torch.empty((bsz, t, h, hd), dtype=torch.float32, device=dev)
    stash = torch.empty((bp // block_b, h, chunk, _rows_compiled(block_b), 7,
                         hd), dtype=torch.float32, device=dev)
    dr = torch.empty_like(r_gates)
    db = torch.empty_like(b_gates)
    fn = build.load("slstm_scan", "slstm_bwd", _BWD_ARGS)
    err = fn(zx.data_ptr(), r_gates.data_ptr(), rt.data_ptr(),
             b_gates.data_ptr(), hb.data_ptr(), cb.data_ptr(), nb.data_ptr(),
             mb.data_ptr(), dh.data_ptr(), dzx.data_ptr(),
             None if dz32 is None else dz32.data_ptr(), hprev.data_ptr(),
             stash.data_ptr(), dr.data_ptr(), db.data_ptr(), bsz, t, h, hd,
             block_b, chunk, DTYPE_CODES[zx.dtype], _stream(dev))
    _raise_on_error(what, err)
    return dzx, dr, db
