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

Each kernel runs one (row block, head) on a thread-block cluster of ``cs``
blocks that holds the head's R in shared memory (`choose_cluster` picks
``cs``; `launch_plan` says what a launch uses).

All take CUDA tensors only and raise on anything the kernels do not take:
another device or dtype, head_dim above 512, block_b above 8, a shape that
does not fit, a tensor that is not contiguous, a cluster size the card
does not schedule.  Outputs and scratch are allocated here with
``torch.empty``; the kernels launch on PyTorch's current stream and do not
synchronise.  The wrappers in `ops` choose between these and the plain
versions in `ref` by the tensors' device.
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
# blocks a cluster, largest first (above 8 only where the card allows it)
CLUSTER_SIZES = (16, 8, 4, 2, 1)
# a block's threads, one per (row, unit) pair at most: NT of the kernels,
# which `cluster_plan` checks against the build
THREADS = 512
MIN_UNITS = 8        # below this many units a block, a smaller cluster

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 8 + [_I] * 8 + [_P]
_BWD_ARGS = [_P] * 14 + [_I] * 8 + [_P]
_PLAN_ARGS = [_I] * 5 + [_P]


def _rows_compiled(block_b: int) -> int:
    """The kernels' compiled row count: block_b rounded up to 1, 2, 4, 8."""
    return next(n for n in (1, 2, 4, 8) if block_b <= n)


def choose_cluster(hd: int, rows: int, schedules=lambda cs: True) -> int:
    """Blocks of the cluster that runs one (row block, head): the largest
    of `CLUSTER_SIZES` for which each block owns ``u = ceil(hd / cs)`` units, at least `MIN_UNITS` of them (or
    ``cs`` is 1), no block owns none, every (row, unit) pair of a block has
    a thread (``rows * u <= THREADS``), and ``schedules(cs)`` (the card
    can hold such a cluster).  ``rows`` is block_b rounded up to 1, 2, 4
    or 8.  Results for two cluster sizes differ only by rounding (the
    recurrent sums in another order)."""
    for cs in CLUSTER_SIZES:
        u = -(-hd // cs)
        if ((u >= MIN_UNITS or cs == 1) and (cs - 1) * u < hd
                and rows * u <= THREADS and schedules(cs)):
            return cs
    raise ValueError(f"no cluster of {CLUSTER_SIZES} runs head_dim {hd} "
                     f"with {rows} rows a block on this card")


_PLANS: dict[tuple, dict] = {}


def cluster_plan(device: torch.device, hd: int, block_b: int,
                 dtype: torch.dtype, backward: bool, cluster: int) -> dict:
    """What K7 (``backward`` False) or K8 would use on ``device`` with
    ``cluster`` blocks a cluster, asked of the card once: ``cluster``,
    ``clusters_at_once`` (0: the card does not schedule it),
    ``resident_rows`` (rows k of the R slice in shared memory; hd: all),
    ``smem_bytes`` a block, ``slices`` (k-slices of the forward product)
    and ``units`` a block."""
    what = "slstm_plan (csrc/slstm_scan.cu)"
    key = (device.index, hd, _rows_compiled(block_b), dtype, backward,
           cluster)
    if key not in _PLANS:
        fn = build.load("slstm_scan", "slstm_plan", _PLAN_ARGS)
        info = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            err = fn(hd, block_b, cluster, DTYPE_CODES[dtype], int(backward),
                     info)
        _raise_on_error(what, err)
        _check(what, info[5] == THREADS,
               f"the kernels run {info[5]} threads a block, THREADS is "
               f"{THREADS}")
        _PLANS[key] = dict(zip(("cluster", "clusters_at_once",
                                "resident_rows", "smem_bytes", "slices",
                                "units"), (cluster, *info[:5])))
    return _PLANS[key]


def launch_plan(zx: torch.Tensor, *, block_b: int = 8,
                backward: bool = False) -> dict:
    """`cluster_plan` of the cluster size a launch on ``zx`` (B, T, H, 4hd)
    uses (`choose_cluster` with the card's limits)."""
    hd = zx.shape[-1] // 4
    block_b = min(block_b, zx.shape[0])

    def plan(cs):
        return cluster_plan(zx.device, hd, block_b, zx.dtype, backward, cs)
    cs = choose_cluster(hd, _rows_compiled(block_b),
                        lambda c: plan(c)["clusters_at_once"] > 0)
    return plan(cs)


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
           f"head_dim {hd} not supported on CUDA (1 to {MAX_HEAD_DIM})")
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
         block_b: int, chunk: int, save_bounds: bool, cluster: int = 0):
    """K7.  ``cluster`` > 0 forces the cluster size instead of
    `choose_cluster`'s (timing by size and the card tests do; the public
    entries never do)."""
    what = "slstm_scan (csrc/slstm_scan.cu)"
    bsz, t, h, hd, block_b, chunk, bp, nt = _check_inputs(
        what, zx, r_gates, b_gates, block_b, chunk)
    out = torch.empty((bsz, t, h, hd), dtype=zx.dtype, device=zx.device)
    bounds = tuple(torch.empty((bp, nt, h, hd), dtype=torch.float32,
                               device=zx.device)
                   for _ in range(4)) if save_bounds else None
    ptrs = [b.data_ptr() for b in bounds] if save_bounds else [None] * 4
    cs = cluster or launch_plan(zx, block_b=block_b)["cluster"]
    fn = build.load("slstm_scan", "slstm_fwd", _FWD_ARGS)
    err = fn(zx.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(),
             out.data_ptr(), *ptrs, bsz, t, h, hd, block_b, chunk, cs,
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
    return _bwd(zx, r_gates, b_gates, bounds, dh, block_b, chunk)


def _bwd(zx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
         bounds, dh: torch.Tensor, block_b: int, chunk: int,
         cluster: int = 0):
    """K8 and the dR / db reduction; ``cluster`` as `_fwd`."""
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
    dzx = torch.empty_like(zx)
    dz32 = (torch.empty(zx.shape, dtype=torch.float32, device=dev)
            if zx.dtype != torch.float32 else None)
    hprev = torch.empty((bsz, t, h, hd), dtype=torch.float32, device=dev)
    stash = torch.empty((bp // block_b, h, chunk, _rows_compiled(block_b), 7,
                         hd), dtype=torch.float32, device=dev)
    dr = torch.empty_like(r_gates)
    db = torch.empty_like(b_gates)
    cs = cluster or launch_plan(zx, block_b=block_b, backward=True)["cluster"]
    fn = build.load("slstm_scan", "slstm_bwd", _BWD_ARGS)
    err = fn(zx.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(),
             hb.data_ptr(), cb.data_ptr(), nb.data_ptr(), mb.data_ptr(),
             dh.data_ptr(), dzx.data_ptr(),
             None if dz32 is None else dz32.data_ptr(), hprev.data_ptr(),
             stash.data_ptr(), dr.data_ptr(), db.data_ptr(), bsz, t, h, hd,
             block_b, chunk, cs, DTYPE_CODES[zx.dtype], _stream(dev))
    _raise_on_error(what, err)
    return dzx, dr, db
