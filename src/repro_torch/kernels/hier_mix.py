"""Launch of the fused gated-SGD + averaging kernel, and the structured
operator it takes.

Counterpart of `repro/kernels/hier_mix.py`.  `hier_mix_chunks` launches
``csrc/hier_mix.cu`` once over a (W, C) operand set and replaces the TPU
kernels

* K1 `_kernel` (``hier_mix_chunks`` over one leaf, and the dense
  ``_packed_call`` over the packed buffer): ``out = T^T (x - eta*theta*g)``;
* K2 `_grouped_kernel` / `_hub_grouped_kernel` (the grouped
  ``_packed_call``): the same update, then ``broadcast @ (H^T)? @
  (scatter @ u)`` for a `GroupedOperator`.

The tree-level launch loops of the JAX module (``hier_mix_tree``,
``hier_mix_packed``, ``hier_mix_packed_chunked``) are the counting wrappers
in `repro_torch.kernels.ops`; a chunk of the packed buffer (K5) is a column
range handed to `hier_mix_chunks` as a view, with no copy.

CUDA tensors only; everything the kernel does not take raises.  The output
is allocated here with ``torch.empty`` unless the caller passes a view to
write into; the launch runs on PyTorch's current stream and does not
synchronise.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILES = (256, 128, 64, 32)     # columns a block stages, largest that fits
SMEM_LIMIT = 232_448           # shared memory a Hopper block can opt into

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _L, _L, _L, _I, _I, _P]


@dataclasses.dataclass(frozen=True)
class GroupedOperator:
    """Structured mixing operator for the fused kernel.

    ``scatter`` (D, W) holds the v-weighted subnet assignment
    (scatter[d, i] = v_i iff subnet_of[i] == d), ``broadcast`` (W, D) the
    membership indicator, and ``hub`` the optional (D, D) hub-mixing matrix
    H (None for a pure subnet/V round).  The kernel computes

        out = broadcast @ (H^T?) @ (scatter @ u)

    -- the two_stage / circulant structure of `protocol` as two skinny
    products and a small (D, D) one instead of a dense (W, W) product.
    All float32, on one device.
    """
    scatter: torch.Tensor
    broadcast: torch.Tensor
    hub: torch.Tensor | None = None


def make_grouped_operator(subnet_of, v_weights, h=None, *,
                          device: torch.device | str = "cpu"
                          ) -> GroupedOperator:
    """Build the structured operator from raw network arrays.

    subnet_of: (W,) int subnet index per worker; v_weights: (W,) within-
    subnet weights (summing to 1 per subnet); h: optional (D, D) hub matrix
    (its circulant-ness, when ``mixing="ppermute"`` needs it, is the
    caller's contract -- see `protocol._circulant_coeffs`)."""
    sub = np.asarray(subnet_of)
    v = np.asarray(v_weights, np.float32)
    d = int(sub.max()) + 1
    w = sub.shape[0]
    scatter = np.zeros((d, w), np.float32)
    scatter[sub, np.arange(w)] = v
    broadcast = np.zeros((w, d), np.float32)
    broadcast[np.arange(w), sub] = 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GroupedOperator(t(scatter), t(broadcast),
                           None if h is None else t(h))


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"hier_mix (csrc/hier_mix.cu): {msg}")


def smem_bytes(w: int, d: int, grouped: bool, hub: bool, tile: int) -> int:
    """Shared memory of one block: a_i (W), the operator (T, or S, B and
    H) and the float32 u / z tiles (layout of ``csrc/hier_mix.cu``)."""
    op = d * w * 2 if grouped else w * w
    rows = w + (d if grouped else 0) + (d if hub else 0)
    return 4 * (w + op + (d * d if hub else 0) + rows * tile)


def pick_tile(w: int, d: int, grouped: bool, hub: bool) -> int:
    """The largest column tile whose shared memory fits a Hopper block;
    raises `ValueError` past the largest W the kernel holds (W = 225 for
    the dense operator, tile 32)."""
    for tile in TILES:
        if smem_bytes(w, d, grouped, hub, tile) <= SMEM_LIMIT:
            return tile
    raise ValueError(
        f"hier_mix (csrc/hier_mix.cu): W={w}, D={d} needs "
        f"{smem_bytes(w, d, grouped, hub, TILES[-1])} bytes of shared "
        f"memory at the smallest tile; a Hopper block holds {SMEM_LIMIT}")


def _matrix(what: str, t: torch.Tensor, shape: tuple, device) -> None:
    _check(t.device == device and t.dtype == torch.float32
           and tuple(t.shape) == shape and t.is_contiguous(),
           f"{what} must be a contiguous float32 {shape} tensor on {device}, "
           f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _rows(what: str, t: torch.Tensor, w: int, c: int) -> None:
    _check(t.dim() == 2 and tuple(t.shape) == (w, c)
           and (t.stride(1) == 1 or c == 1),
           f"{what} must be a (W, C) = ({w}, {c}) view with unit column "
           f"stride, got shape {tuple(t.shape)} strides {t.stride()}")


def hier_mix_chunks(x: torch.Tensor, g: torch.Tensor,
                    op: torch.Tensor | GroupedOperator, theta: torch.Tensor,
                    eta: float, *, out: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """One launch: ``out[j] = sum_i T[i, j] (x[i] - eta*theta_i*g[i])``
    for a dense (W, W) ``op``, or the grouped chain for a
    `GroupedOperator`.  x, g: (W, C) of one dtype (float32 or bfloat16)
    with unit column stride and any row stride (a column chunk of a larger
    buffer is a view); theta (W,) float32.  -> ``out`` (W, C) of x's dtype
    (a new tensor, or the given view written in place)."""
    _check(x.is_cuda, "x must be a CUDA tensor")
    dev = x.device
    _check(x.dtype in DTYPE_CODES, f"dtype {x.dtype} not supported "
           "(float32 or bfloat16)")
    _check(g.dtype == x.dtype and g.device == dev,
           "x and g must share one dtype and device")
    w, c = x.shape if x.dim() == 2 else (0, 0)
    _rows("x", x, w, c)
    _rows("g", g, w, c)
    _check(g.stride(0) == x.stride(0), "x and g must share one row stride")
    if out is None:
        out = torch.empty((w, c), dtype=x.dtype, device=dev)
    _check(out.dtype == x.dtype and out.device == dev, "out must match x")
    _rows("out", out, w, c)
    _matrix("theta", theta, (w,), dev)
    if isinstance(op, GroupedOperator):
        d = op.scatter.shape[0]
        _matrix("scatter", op.scatter, (d, w), dev)
        _matrix("broadcast", op.broadcast, (w, d), dev)
        if op.hub is not None:
            _matrix("hub", op.hub, (d, d), dev)
        ptrs = (op.scatter.data_ptr(), op.broadcast.data_ptr(),
                None if op.hub is None else op.hub.data_ptr())
        tile = pick_tile(w, d, True, op.hub is not None)
    else:
        d = 0
        _matrix("T", op, (w, w), dev)
        ptrs = (op.data_ptr(), None, None)
        tile = pick_tile(w, 0, False, False)
    fn = build.load("hier_mix", "hier_mix", _ARGS)
    err = fn(x.data_ptr(), g.data_ptr(), out.data_ptr(), *ptrs,
             theta.data_ptr(), float(eta), w, d, c, x.stride(0),
             out.stride(0), tile, DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hier_mix (csrc/hier_mix.cu): CUDA error {err} "
                           f"({torch.cuda.get_device_name(dev)})")
    return out
