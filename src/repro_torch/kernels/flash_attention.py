"""Launches of the hand-written CUDA attention kernels.

Counterpart of `repro/kernels/flash_attention.py`:

* `flash_attention_fwd_res` launches ``csrc/flash_fwd.cu`` (replaces
  `_fwd_kernel` / `flash_attention_fwd_res`, the TPU flash-attention
  forward);
* `flash_attention_bwd` launches ``csrc/flash_bwd.cu`` (replaces
  `_bwd_dq_kernel` / `_bwd_dkv_kernel` behind `flash_attention_bwd`, the
  TPU recomputation backward; the preprocess ``delta = rowsum(do * o)``,
  which the TPU wrapper computes outside Pallas, is the same file's
  `flash_bwd_delta_kernel`, launched by the same C call);

  for both, the dtype picks the kernel inside the C entry point: bf16 runs
  on the tensor cores (wgmma, operands loaded by TMA, which needs each
  tensor's address 16-byte aligned), float32 on the CUDA cores.  Both are
  built for head_dim 64 and 128; head_dim 80 is zero-padded to 128 here
  (`pad_head_dim`), as the TPU wrappers pad it, with the softmax scale of
  the unpadded head_dim, and the outputs are sliced back;
* `flash_decode_paged` launches ``csrc/flash_decode.cu`` (replaces
  `_decode_kernel` / `flash_decode_paged` and its split combine): one
  launch, any GQA group, head_dim 64, 80 or 128 as it is.

All take CUDA tensors only and raise on anything the kernels do not take:
another device, dtype or head_dim, a shape that does not fit, a tensor that
is not contiguous.  Outputs and scratch are allocated here with
``torch.empty``; the kernels launch on PyTorch's current stream and do not
synchronise.  The wrappers in `ops` choose between these and the plain
versions in `ref` by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128)
# K6 fills about one wave of the card: one of its blocks on every SM.  Two
# fit an SM at head_dim 128 in bf16 (111 KB of shared memory a block), but
# a block's fixed cost (launch, first loads, cluster barriers) is worth
# about two 64-token chunks, so more splits than SMs lose on short lanes
# (tools/decode_probe.py)
DECODE_BLOCKS_PER_SM = 1
DECODE_MAX_ROWS = 32      # query rows of a K6 block (MAX_ROWS in csrc/flash_decode.cu)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_DELTA_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
_DECODE_ARGS = [_P, _P, _P, _P, _P, _P,
                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]


def _check(what: str, ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"{what}: {msg}")


def _check_tensors(what: str, device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        _check(what, t.device == device,
               f"{name} is on {t.device}, expected {device}")
        _check(what, t.is_contiguous(), f"{name} must be contiguous")


def _check_float(what: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    _check(what, q.dtype in DTYPE_CODES,
           f"dtype {q.dtype} not supported (float32 or bfloat16)")
    _check(what, all(t.dtype == q.dtype for t in others),
           "q, k and v must share one dtype")
    _check(what, q.shape[-1] in HEAD_DIMS,
           f"head_dim {q.shape[-1]} not supported on CUDA {HEAD_DIMS}")


def _check_aligned(what: str, **tensors) -> None:
    """The kernels load 16 bytes at a time (TMA for bf16 K3 / K4, vector
    loads and `cp.async` elsewhere): each base address must be 16-byte
    aligned (a fresh allocation always is)."""
    for name, t in tensors.items():
        _check(what, t.data_ptr() % 16 == 0,
               f"{name} must start on a 16-byte boundary (offset "
               f"{t.storage_offset()})")


def _check_tma(what: str, **tensors) -> None:
    """The bf16 K3 / K4 load through TMA tensor maps, whose base address
    must be 16-byte aligned; float32 goes to the CUDA-core kernels."""
    _check_aligned(what, **{name: t for name, t in tensors.items()
                            if t.dtype == torch.bfloat16})


def kernel_head_dim(hd: int) -> int:
    """The head_dim K3 and K4 run at: ``hd`` rounded up to a multiple of 64
    (80 -> 128), as the TPU wrappers' `_pad_head_dim` rounds it."""
    return -(-hd // 64) * 64


def pad_head_dim(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors zero-padded along their last axis to `kernel_head_dim`
    (returned as they are where nothing is to pad).  The zero columns of
    q, k, v, o and do add exact zeros to every product of the forward and
    the backward (q k, p v, do v, ds k, ds q, p do, do o), so the sliced
    outputs are the unpadded ones, given the unpadded softmax scale."""
    pad = kernel_head_dim(tensors[0].shape[-1]) - tensors[0].shape[-1]
    return [F.pad(t, (0, pad)) if pad else t for t in tensors]


def _raise_on_error(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd_res(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, T, H, hd), k/v: (B, S, Hkv, hd) on one CUDA device ->
    (o (B, T, H, hd) in q's dtype, lse (B, H, T) float32)."""
    what = "flash_attention (csrc/flash_fwd.cu)"
    _check(what, q.is_cuda, "q must be a CUDA tensor")
    _check_tensors(what, q.device, q=q, k=k, v=v)
    _check_float(what, q, k, v)
    _check(what, q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, t, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    _check(what, k.shape[0] == b and k.shape[3] == hd and hkv > 0
           and h % hkv == 0, "k/v must be (B, S, Hkv, hd) with H % Hkv == 0")
    qp, kp, vp = pad_head_dim(q, k, v)
    _check_tma(what, q=qp, k=kp, v=vp)
    o = torch.empty_like(qp)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = build.load("flash_fwd", "flash_fwd", _FWD_ARGS)
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, t, s, h, hkv, qp.shape[-1],
             DTYPE_CODES[q.dtype], int(causal), int(window), float(softcap),
             1.0 / math.sqrt(hd), _stream(q.device))
    _raise_on_error(what, err)
    return (o if o.shape[-1] == hd else o[..., :hd].contiguous()), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/o/do: (B, T, H, hd), k/v: (B, S, Hkv, hd), lse: (B, H, T) float32,
    all on one CUDA device -> (dq, dk, dv) in the primal shapes and dtypes
    (dk/dv summed over the GQA group)."""
    what = "flash_attention_bwd (csrc/flash_bwd.cu)"
    _check(what, q.is_cuda, "q must be a CUDA tensor")
    _check_tensors(what, q.device, q=q, k=k, v=v, o=o, lse=lse, do=do)
    _check_float(what, q, k, v, o, do)
    _check(what, q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
           and o.shape == q.shape and do.shape == q.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
           f"{tuple(v.shape)}, o {tuple(o.shape)}, do {tuple(do.shape)}")
    b, t, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    _check(what, k.shape[0] == b and k.shape[3] == hd and hkv > 0
           and h % hkv == 0, "k/v must be (B, S, Hkv, hd) with H % Hkv == 0")
    _check(what, lse.dtype == torch.float32 and lse.shape == (b, h, t),
           f"lse must be float32 (B, H, T), got {lse.dtype} {tuple(lse.shape)}")
    qp, kp, vp, op, dop = pad_head_dim(q, k, v, o, do)
    _check_aligned(what, o=op, do=dop)     # the delta kernel's loads
    _check_tma(what, q=qp, k=kp, v=vp, do=dop)
    hd_k = qp.shape[-1]
    # the preprocess delta = rowsum(do * o), written by the delta kernel
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (qp, kp, vp))
    # bf16 with a GQA group: one block per q head writes float32 partials
    # of dk / dv, summed over the group in head order by a second kernel
    parts = (None, None)
    if q.dtype == torch.bfloat16 and h > hkv:
        part = torch.empty((2, b, s, h, hd_k), dtype=torch.float32,
                           device=q.device)
        parts = (part.data_ptr(), part.data_ptr() + 4 * b * s * h * hd_k)
    fn = build.load("flash_bwd", "flash_bwd", _BWD_ARGS)
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(),
             dop.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), *parts, b, t, s, h, hkv, hd_k,
             DTYPE_CODES[q.dtype], int(causal), int(window), float(softcap),
             1.0 / math.sqrt(hd), _stream(q.device))
    _raise_on_error(what, err)
    if hd_k != hd:
        dq, dk, dv = (x[..., :hd].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


def flash_attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """K4's preprocess alone (the kernel `flash_attention_bwd` launches
    first): o, do (B, T, H, hd) on one CUDA device -> delta = rowsum(do * o)
    (B, H, T) float32."""
    what = "flash_attention_delta (csrc/flash_bwd.cu)"
    _check(what, o.is_cuda, "o must be a CUDA tensor")
    _check_tensors(what, o.device, o=o, do=do)
    _check_float(what, o, do)
    _check(what, o.dim() == 4 and do.shape == o.shape,
           f"shapes o {tuple(o.shape)}, do {tuple(do.shape)}")
    op, dop = pad_head_dim(o, do)
    _check_aligned(what, o=op, do=dop)
    b, t, h, hd_k = op.shape
    delta = torch.empty((b, h, t), dtype=torch.float32, device=o.device)
    fn = build.load("flash_bwd", "flash_bwd_delta", _DELTA_ARGS)
    err = fn(op.data_ptr(), dop.data_ptr(), delta.data_ptr(), b, t, h, hd_k,
             DTYPE_CODES[o.dtype], _stream(o.device))
    _raise_on_error(what, err)
    return delta


def choose_num_splits(batch: int, n_kv_heads: int, group: int,
                      max_blocks: int, num_splits: int = 0, *,
                      num_sms: int = 132, cluster_max: int = 16) -> int:
    """K6's split count: the splits of one (lane, kv head, 32 query rows)
    are the blocks of one thread-block cluster.

    ``num_splits <= 0`` picks enough that ``batch * n_kv_heads *
    ceil(group / 32) * splits`` fills about one wave of the card
    (`DECODE_BLOCKS_PER_SM` block on each of ``num_sms`` SMs).  Either
    way the count is clamped to ``[1, min(max_blocks, cluster_max)]``:
    every split has at least one page of the table, and a cluster holds at
    most ``cluster_max`` blocks (16 where the card schedules such clusters,
    else the portable 8).  Results for two split counts differ only by
    rounding (the exact logsumexp combine, in another order)."""
    if num_splits <= 0:
        lanes = batch * n_kv_heads * -(-group // DECODE_MAX_ROWS)
        num_splits = DECODE_BLOCKS_PER_SM * num_sms // max(1, lanes)
    return max(1, min(num_splits, max_blocks, cluster_max))


_DECODE_LIMITS: dict[tuple, tuple[int, int]] = {}


def _decode_limits(device: torch.device, hd: int,
                   dtype: torch.dtype) -> tuple[int, int]:
    """(SMs, largest schedulable cluster of K6) of ``device``, asked once."""
    key = (device.index, hd, dtype)
    if key not in _DECODE_LIMITS:
        fn = build.load("flash_decode", "flash_decode_max_cluster", [_I, _I])
        with torch.cuda.device(device):
            cluster = fn(hd, DTYPE_CODES[dtype])
        if cluster < 1:
            raise RuntimeError(
                f"flash_decode (csrc/flash_decode.cu): "
                f"{torch.cuda.get_device_name(device)} schedules no cluster "
                f"of 8 blocks of the head_dim {hd} {dtype} kernel")
        _DECODE_LIMITS[key] = (
            torch.cuda.get_device_properties(device).multi_processor_count,
            cluster)
    return _DECODE_LIMITS[key]


def decode_splits(q: torch.Tensor, k_pool: torch.Tensor,
                  block_tables: torch.Tensor, num_splits: int = 0) -> int:
    """The split count `flash_decode_paged` launches with for these inputs
    (`choose_num_splits` with the card's SMs and cluster limit)."""
    sms, cluster = _decode_limits(q.device, q.shape[-1], q.dtype)
    hkv = k_pool.shape[2]
    return choose_num_splits(q.shape[0], hkv, q.shape[1] // hkv,
                             block_tables.shape[1], num_splits,
                             num_sms=sms, cluster_max=cluster)


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, window: int = 0,
                       softcap: float = 0.0, num_splits: int = 0
                       ) -> torch.Tensor:
    """q: (B, H, hd); k_pool/v_pool: (num_blocks, block_size, Hkv, hd);
    block_tables: (B, max_blocks) int32 of valid block ids; lengths: (B,)
    int32, all on one CUDA device -> (B, H, hd) in q's dtype.  Any GQA
    group H / Hkv.  ``num_splits`` as `choose_num_splits` takes it."""
    what = "flash_decode (csrc/flash_decode.cu)"
    _check(what, q.is_cuda, "q must be a CUDA tensor")
    _check_tensors(what, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
                   block_tables=block_tables, lengths=lengths)
    _check_float(what, q, k_pool, v_pool)
    _check(what, block_tables.dtype == torch.int32
           and lengths.dtype == torch.int32,
           "block_tables and lengths must be int32")
    _check(what, q.dim() == 3 and k_pool.dim() == 4
           and k_pool.shape == v_pool.shape,
           f"shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}")
    b, h, hd = q.shape
    nb, bs, hkv, _ = k_pool.shape
    _check(what, k_pool.shape[3] == hd and hkv > 0 and h % hkv == 0
           and nb > 0 and bs > 0,
           f"need non-empty pools (NB, bs, Hkv, {hd}) with H % Hkv == 0")
    _check(what, block_tables.dim() == 2 and block_tables.shape[0] == b
           and block_tables.shape[1] > 0 and lengths.shape == (b,),
           "block_tables must be (B, max_blocks > 0) and lengths (B,)")
    _check_aligned(what, q=q, k_pool=k_pool, v_pool=v_pool)
    nmax = block_tables.shape[1]
    splits = decode_splits(q, k_pool, block_tables, num_splits)
    out = torch.empty_like(q)
    fn = build.load("flash_decode", "flash_decode", _DECODE_ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, h, hkv, hd, nb, bs, nmax, splits, DTYPE_CODES[q.dtype],
             int(window), float(softcap), 1.0 / math.sqrt(hd),
             _stream(q.device))
    _raise_on_error(what, err)
    return out
