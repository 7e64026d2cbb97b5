"""Public wrappers of the hand-written kernels (counterpart of
`repro/kernels/ops.py`).

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
it never gives way to the plain version.  On a CPU tensor it runs the plain
PyTorch version in `ref`, and only then.

* `flash_attention` is differentiable end to end through the kernels, as
  the JAX package's `jax.custom_vjp` is: a `torch.autograd.Function` whose
  forward launches the flash-attention forward (``csrc/flash_fwd.cu``) and
  saves (q, k, v, o, lse), and whose backward launches the recomputation
  backward (``csrc/flash_bwd.cu``) from that lse -- the forward is never
  recomputed.
* `flash_attention_fwd_res` (o and lse) and `flash_attention_bwd` are the
  two halves, for callers that need them apart.
* `flash_decode` runs the paged flash-decode (``csrc/flash_decode.cu``),
  one launch per call at any GQA group; decode never differentiates.
* The attention kernels take head_dim 64, 80 and 128 (K3 and K4 run 80
  zero-padded to 128, as the TPU wrappers do).
* `slstm_scan` is differentiable through the kernels, as the JAX
  package's `jax.custom_vjp` is: a `torch.autograd.Function` whose forward
  launches the sLSTM scan forward (``csrc/slstm_scan.cu``) with the
  chunk-boundary residuals and saves (zx, r_gates, b_gates, bounds), and
  whose backward launches the reverse-time scan and its dR / db reduction
  (same file).  With no gradient to record it launches the forward
  without residuals.  `slstm_scan_fwd_res` and `slstm_scan_bwd` are the
  two halves.
* `hier_mix` (one (W, C) leaf), `hier_mix_pytree` (one launch per leaf of
  a stacked tree), `hier_mix_packed` (one launch over the packed
  (W, sum C) buffer) and `hier_mix_packed_chunked` (one launch per
  `packing.chunk_views` chunk of it) run the fused gated-SGD + averaging
  kernel (``csrc/hier_mix.cu``) with a dense (W, W) operator or a
  `GroupedOperator`.

On a ``meta`` tensor (the dry run, `launch.dryrun`) the attention and
sLSTM wrappers launch nothing and run nothing: they return ``meta``
stand-ins of the kernel's output shapes and dtypes.  A ``meta`` tensor has
nothing to launch on, so this is no fallback; only a CPU tensor takes the
plain version.  While a work counter is installed
(`launch.cost_analysis.CostCounter`, through `set_work_sink`), each of
those calls, on ``meta`` or on the card, adds its kernel's FLOPs and bytes
by the formulas of the kernel's bound (`attention_fwd_work` and the
three below it), and the counter skips the torch ops inside the wrapper,
so a count does not depend on the device.

Each kernel's launches are counted in a plain integer attribute --
``flash_attention.launches`` (forward), ``flash_attention_bwd.launches``,
``flash_decode.launches``, ``slstm_scan.launches`` (both forward
variants), ``slstm_scan_bwd.launches``, and ``launches`` on each of the four hier_mix
wrappers (with ``grouped_launches`` counting the `GroupedOperator` ones
among them; ``tc_launches`` on the two flash-attention wrappers counts
the bf16 ones, which run on the tensor cores) -- raised by one right
after each successful launch and nowhere else, so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hier_mix as hm
from repro_torch.kernels import ref
from repro_torch.kernels import slstm_scan as ss
from repro_torch.kernels.hier_mix import GroupedOperator, \
    make_grouped_operator  # noqa: F401  (re-exported, as in the JAX ops)
from repro_torch.tree import tree_map


# ----------------------------------------------------------- work accounting
_SINK = None


def set_work_sink(sink):
    """Install ``sink`` (an object with ``kernel(name, flops, nbytes)``, a
    context manager) to receive each kernel call's work; ``None`` removes
    it.  -> the previous sink."""
    global _SINK
    prev, _SINK = _SINK, sink
    return prev


def _work(name: str, work, *args, **kwargs):
    """The installed sink's context for one call of kernel ``name``, whose
    (FLOPs, bytes) ``work(*args, **kwargs)`` gives (worked out only while
    a sink is installed)."""
    if _SINK is None:
        return contextlib.nullcontext()
    return _SINK.kernel(name, *work(*args, **kwargs))


def live_pairs(t: int, s: int, window: int, causal: bool) -> int:
    """(query, key) pairs that causal + window masking leaves live."""
    if not causal:
        return t * s
    i = np.arange(t, dtype=np.int64)
    hi = np.minimum(i, s - 1) + 1
    lo = np.maximum(0, i - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo).sum())


def attention_fwd_work(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                       window: int) -> tuple[float, float]:
    """K3's (FLOPs, bytes): q, k, v read and o written once, lse written;
    two products of hd per live pair."""
    b, t, h, hd = q.shape
    es = q.element_size()
    nbytes = es * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * t
    flops = 4 * hd * h * b * live_pairs(t, k.shape[1], window, causal)
    return float(flops), float(nbytes)


def attention_bwd_work(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                       window: int) -> tuple[float, float]:
    """K4's (FLOPs, bytes): q, o, do, k, v and lse read once, dq, dk, dv
    written once; five products of hd per live pair (s, dp, dq, dk, dv)."""
    b, t, h, hd = q.shape
    es = q.element_size()
    nbytes = es * (4 * q.numel() + 4 * k.numel()) + 4 * b * h * t
    flops = 10 * hd * h * b * live_pairs(t, k.shape[1], window, causal)
    return float(flops), float(nbytes)


def _slstm_bounds_shape(zx: torch.Tensor, block_b: int, chunk: int) -> tuple:
    bsz, t, h, hd4 = zx.shape
    _, _, bp, nt = ref.slstm_geometry(bsz, t, block_b, chunk)
    return (bp, nt, h, hd4 // 4)


def slstm_fwd_work(zx: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor, *, block_b: int, chunk: int,
                   residuals: bool) -> tuple[float, float]:
    """K7's (FLOPs, bytes): zx, R and b read, h (and with ``residuals``
    the four float32 chunk-entering states) written; the recurrent
    products, 2 B T H hd 4hd."""
    bsz, t, h, hd4 = zx.shape
    es = zx.element_size()
    rb = 4 * (r_gates.numel() + b_gates.numel())
    bounds = (4 * 4 * int(np.prod(_slstm_bounds_shape(zx, block_b, chunk)))
              if residuals else 0)
    nbytes = es * (zx.numel() + bsz * t * h * (hd4 // 4)) + rb + bounds
    return float(2 * bsz * t * h * (hd4 // 4) * hd4), float(nbytes)


def slstm_bwd_work(zx: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor, *, block_b: int, chunk: int
                   ) -> tuple[float, float]:
    """K8's (FLOPs, bytes): zx, dh, R, b and the bounds read; dzx, dR, db
    written; the forward recomputed, dh = dz R^T and dR = h^T dz."""
    bsz, t, h, hd4 = zx.shape
    es = zx.element_size()
    rb = 4 * (r_gates.numel() + b_gates.numel())
    bounds = 4 * 4 * int(np.prod(_slstm_bounds_shape(zx, block_b, chunk)))
    nbytes = es * (2 * zx.numel() + bsz * t * h * (hd4 // 4)) + 2 * rb \
        + bounds
    return float(3 * 2 * bsz * t * h * (hd4 // 4) * hd4), float(nbytes)


def _meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def _cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def flash_attention_fwd_res(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, T, H, hd), k/v: (B, S, Hkv, hd) -> (o (B, T, H, hd),
    lse (B, H, T) float32).  Not differentiable itself (gradients go
    through `flash_attention`)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_attention_fwd_res records no gradient; call "
            "flash_attention to differentiate through the kernels")
    if _cpu(q):
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
    with _work("flash_attention", attention_fwd_work, q, k, causal=causal,
               window=window):
        if _meta(q):
            b, t, h, _ = q.shape
            return torch.empty_like(q), q.new_empty((b, h, t),
                                                    dtype=torch.float32)
        out = fa.flash_attention_fwd_res(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
    flash_attention.launches += 1
    flash_attention.tc_launches += q.dtype == torch.bfloat16
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recomputation backward from the forward's (o, lse): -> (dq, dk, dv)
    in the primal shapes and dtypes."""
    if _cpu(q):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                           window=window, softcap=softcap)
    with _work("flash_attention_bwd", attention_bwd_work, q, k,
               causal=causal, window=window):
        if _meta(q):
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v))
        out = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window, softcap=softcap)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tc_launches += q.dtype == torch.bfloat16
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward K3, backward K4 from the saved lse (`jax.custom_vjp` in the
    JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_fwd_res(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Blocked online-softmax attention: causal, sliding window, logit
    softcap, GQA.  -> (B, T, H, hd); differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return flash_attention_fwd_res(q, k, v, causal=causal, window=window,
                                   softcap=softcap)[0]


def flash_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor, lengths: torch.Tensor, *,
                 window: int = 0, softcap: float = 0.0,
                 num_splits: int = 0) -> torch.Tensor:
    """Single-query attention over a paged KV cache: q (B, H, hd) against a
    (num_blocks, block_size, Hkv, hd) pool through a (B, max_blocks) block
    table; split-KV with an exact logsumexp combine.  -> (B, H, hd).
    ``num_splits`` picks the kernel's split count (0: chosen for the card;
    see `flash_attention.choose_num_splits`); the plain version has no
    splits, and split counts differ only by rounding."""
    if not q.is_cuda:
        return ref.flash_decode_ref(q, k_pool, v_pool, block_tables, lengths,
                                    window=window, softcap=softcap)
    out = fa.flash_decode_paged(q, k_pool, v_pool, block_tables, lengths,
                                window=window, softcap=softcap,
                                num_splits=num_splits)
    flash_decode.launches += 1
    return out


# ---------------------------------------------------------------- slstm scan
def slstm_scan_fwd_res(zx: torch.Tensor, r_gates: torch.Tensor,
                       b_gates: torch.Tensor, *, block_b: int = 8,
                       chunk: int = 128):
    """zx (B, T, H, 4hd), r_gates (H, hd, 4hd), b_gates (H, 4hd) ->
    (h (B, T, H, hd) in zx's dtype, (h, c, n, m) entering each chunk, each
    (Bp, T/chunk, H, hd) float32).  Not differentiable itself (gradients go
    through `slstm_scan`)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (zx, r_gates, b_gates)):
        raise ValueError(
            "slstm_scan_fwd_res records no gradient; call slstm_scan to "
            "differentiate through the kernels")
    if _cpu(zx):
        return ref.slstm_scan_fwd_res_ref(zx, r_gates, b_gates,
                                          block_b=block_b, chunk=chunk)
    with _work("slstm_scan", slstm_fwd_work, zx, r_gates, b_gates,
               block_b=block_b, chunk=chunk, residuals=True):
        if _meta(zx):
            shape = _slstm_bounds_shape(zx, block_b, chunk)
            acc = torch.float64 if zx.dtype == torch.float64 \
                else torch.float32
            return zx.new_empty(zx.shape[:3] + shape[3:]), tuple(
                zx.new_empty(shape, dtype=acc) for _ in range(4))
        out = ss.slstm_scan_fwd_res(zx, r_gates, b_gates, block_b=block_b,
                                    chunk=chunk)
    slstm_scan.launches += 1
    return out


def slstm_scan_bwd(zx: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor, bounds, dh: torch.Tensor, *,
                   block_b: int = 8, chunk: int = 128):
    """Reverse-time exact VJP from the forward's chunk-boundary states:
    -> (dzx, dR, db) in the primal shapes and dtypes."""
    if _cpu(zx):
        return ref.slstm_scan_bwd_ref(zx, r_gates, b_gates, bounds, dh,
                                      block_b=block_b, chunk=chunk)
    with _work("slstm_scan_bwd", slstm_bwd_work, zx, r_gates, b_gates,
               block_b=block_b, chunk=chunk):
        if _meta(zx):
            return (torch.empty_like(zx), torch.empty_like(r_gates),
                    torch.empty_like(b_gates))
        out = ss.slstm_scan_bwd(zx, r_gates, b_gates, bounds, dh,
                                block_b=block_b, chunk=chunk)
    slstm_scan_bwd.launches += 1
    return out


class _SLSTMScan(torch.autograd.Function):
    """Forward K7 with residuals, backward K8 from them (`jax.custom_vjp`
    in the JAX package)."""

    @staticmethod
    def forward(ctx, zx, r_gates, b_gates, block_b, chunk):
        h, bounds = slstm_scan_fwd_res(zx, r_gates, b_gates, block_b=block_b,
                                       chunk=chunk)
        ctx.save_for_backward(zx, r_gates, b_gates, *bounds)
        ctx.opts = dict(block_b=block_b, chunk=chunk)
        return h

    @staticmethod
    def backward(ctx, dh):
        zx, r_gates, b_gates, *bounds = ctx.saved_tensors
        dzx, dr, db = slstm_scan_bwd(zx, r_gates, b_gates, tuple(bounds),
                                     dh.contiguous(), **ctx.opts)
        return dzx, dr, db, None, None


def slstm_scan(zx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               *, block_b: int = 8, chunk: int = 128) -> torch.Tensor:
    """Stabilised sLSTM recurrence: zx (B, T, H, 4hd) gate pre-activations
    laid out [i|f|z|o] per head, r_gates (H, hd, 4hd), b_gates (H, 4hd) ->
    h (B, T, H, hd) in zx's dtype; differentiable in all three."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (zx, r_gates, b_gates)):
        return _SLSTMScan.apply(zx, r_gates, b_gates, block_b, chunk)
    if _cpu(zx):
        return ref.slstm_scan_ref(zx, r_gates, b_gates)
    with _work("slstm_scan", slstm_fwd_work, zx, r_gates, b_gates,
               block_b=block_b, chunk=chunk, residuals=False):
        if _meta(zx):
            return zx.new_empty(zx.shape[:3] + (zx.shape[3] // 4,))
        out = ss.slstm_scan(zx, r_gates, b_gates, block_b=block_b,
                            chunk=chunk)
    slstm_scan.launches += 1
    return out


# ------------------------------------------------------------------ hier mix
def _mix(wrapper, x: torch.Tensor, g: torch.Tensor,
         op: torch.Tensor | GroupedOperator, theta: torch.Tensor, eta: float,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused update + mix over (W, C) views: the kernel on a CUDA
    tensor (counted on ``wrapper``), the plain version on a CPU one."""
    grouped = isinstance(op, GroupedOperator)
    if not x.is_cuda:
        y = (ref.hier_mix_grouped_ref(x, g, op.scatter, op.broadcast, op.hub,
                                      theta, eta) if grouped
             else ref.hier_mix_ref(x, g, op, theta, eta))
        return y if out is None else out.copy_(y)
    theta = theta.to(x.device, torch.float32).contiguous()
    y = hm.hier_mix_chunks(x, g, op, theta, eta, out=out)
    wrapper.launches += 1
    wrapper.grouped_launches += grouped
    return y


def hier_mix(x: torch.Tensor, g: torch.Tensor, t_op, theta: torch.Tensor,
             eta: float) -> torch.Tensor:
    """Fused gated-SGD + averaging for one (W, C) leaf (float32 or
    bfloat16; float32 arithmetic, one rounding to the leaf's dtype)."""
    return _mix(hier_mix, x, g, t_op, theta, eta)


def hier_mix_pytree(stacked_params, stacked_grads, t_op,
                    theta: torch.Tensor, eta: float):
    """Fused gated-SGD + averaging over a whole stacked tree, one launch
    PER LEAF (the JAX package's ``hier_mix_tree``; `hier_mix_packed` is
    the single launch).  A new tree in the leaves' dtypes."""
    def leaf(x, g):
        w = x.shape[0]
        y = _mix(hier_mix_pytree, x.reshape(w, -1), g.reshape(w, -1), t_op,
                 theta, eta)
        return y.reshape(x.shape)
    return tree_map(leaf, stacked_params, stacked_grads)


def hier_mix_packed(stacked_params, stacked_grads, op, theta: torch.Tensor,
                    eta: float):
    """Fused gated-SGD + averaging over a whole stacked tree in ONE launch
    over the packed (W, sum C_i) float32 buffer (`core.packing`).  ``op``
    is a dense (W, W) operator or a `GroupedOperator` (fused two_stage /
    circulant mixing).  Bit for bit `hier_mix_pytree` for a dense ``op``.
    The new tree's float32 leaves are views of the output buffer."""
    spec = packing.pack_spec(stacked_params)
    x = packing.pack(stacked_params, spec)
    g = packing.pack(stacked_grads, spec)
    out = _mix(hier_mix_packed, x, g, op, theta, eta)
    return packing.unpack(out, spec)


def hier_mix_packed_chunked(stacked_params, stacked_grads, op,
                            theta: torch.Tensor, eta: float, *,
                            num_chunks: int = 4):
    """`hier_mix_packed` as one launch per `packing.chunk_views` column
    chunk of the packed buffer (each writes its columns of one output
    buffer; the launches run in order on the current stream).  Every
    column's arithmetic is independent of the chunking, so the result is
    the single launch's bit for bit."""
    spec = packing.pack_spec(stacked_params)
    x = packing.pack(stacked_params, spec)
    g = packing.pack(stacked_grads, spec)
    out = torch.empty_like(x)
    for ch in packing.chunk_views(spec, num_chunks):
        cols = slice(ch.lo, ch.hi)
        _mix(hier_mix_packed_chunked, x[:, cols], g[:, cols], op, theta, eta,
             out=out[:, cols])
    return packing.unpack(out, spec)


_COUNTED = (flash_attention, flash_attention_bwd, flash_decode, slstm_scan,
            slstm_scan_bwd, hier_mix, hier_mix_pytree, hier_mix_packed,
            hier_mix_packed_chunked)
_GROUPED = (hier_mix, hier_mix_pytree, hier_mix_packed,
            hier_mix_packed_chunked)


def launch_counts() -> dict[str, int]:
    """{wrapper name: launches since the last `reset_launches`}."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def reset_launches() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    for fn in _GROUPED:
        fn.grouped_launches = 0
    for fn in (flash_attention, flash_attention_bwd):
        fn.tc_launches = 0


reset_launches()
