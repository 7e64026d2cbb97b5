"""Launches of the hand-written CUDA attention kernels.

Counterpart of `repro/kernels/flash_attention.py`:

* `flash_attention_fwd_res` launches ``csrc/flash_fwd.cu`` (replaces
  `_fwd_kernel` / `flash_attention_fwd_res`, the TPU flash-attention
  forward);
* `flash_attention_bwd` launches ``csrc/flash_bwd.cu`` (replaces
  `_bwd_dq_kernel` / `_bwd_dkv_kernel` behind `flash_attention_bwd`, the
  TPU recomputation backward; ``delta = rowsum(do * o)`` is one torch
  expression here, as the TPU wrapper computes it outside Pallas);
* `flash_decode_paged` launches ``csrc/flash_decode.cu`` (replaces
  `_decode_kernel` / `flash_decode_paged` and its split combine).

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

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_DECODE_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
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
           f"head_dim {q.shape[-1]} not supported on CUDA (64 or 128)")


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
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = build.load("flash_fwd", "flash_fwd", _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, t, s, h, hkv, hd, DTYPE_CODES[q.dtype],
             int(causal), int(window), float(softcap), 1.0 / math.sqrt(hd),
             _stream(q.device))
    _raise_on_error(what, err)
    return o, lse


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
    # the TPU wrapper's preprocess: delta_i = sum_d do_id * o_id in float32
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = build.load("flash_bwd", "flash_bwd", _BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), b, t, s, h, hkv, hd, DTYPE_CODES[q.dtype],
             int(causal), int(window), float(softcap), 1.0 / math.sqrt(hd),
             _stream(q.device))
    _raise_on_error(what, err)
    return dq, dk, dv


def default_num_splits(num_splits: int, max_blocks: int) -> int:
    """``num_splits <= 0`` -> ``min(8, max_blocks)``; always clamped to
    ``[1, max_blocks]`` (TPU `flash_decode_paged`)."""
    if num_splits <= 0:
        num_splits = min(8, max_blocks)
    return max(1, min(num_splits, max_blocks))


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, window: int = 0,
                       softcap: float = 0.0, num_splits: int = 0
                       ) -> torch.Tensor:
    """q: (B, H, hd); k_pool/v_pool: (num_blocks, block_size, Hkv, hd);
    block_tables: (B, max_blocks) int32 of valid block ids; lengths: (B,)
    int32, all on one CUDA device -> (B, H, hd) in q's dtype."""
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
           and h // hkv <= MAX_GROUP,
           f"need pools (NB, bs, Hkv, {hd}), H % Hkv == 0 and a GQA group "
           f"of at most {MAX_GROUP}")
    _check(what, block_tables.dim() == 2 and block_tables.shape[0] == b
           and block_tables.shape[1] > 0 and lengths.shape == (b,),
           "block_tables must be (B, max_blocks > 0) and lengths (B,)")
    nmax = block_tables.shape[1]
    splits = default_num_splits(num_splits, nmax)
    group = h // hkv
    o_parts = torch.empty((b, hkv, splits, group, hd), dtype=torch.float32,
                          device=q.device)
    m_parts = torch.empty((b, hkv, splits, group), dtype=torch.float32,
                          device=q.device)
    l_parts = torch.empty_like(m_parts)
    out = torch.empty_like(q)
    fn = build.load("flash_decode", "flash_decode", _DECODE_ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), o_parts.data_ptr(),
             m_parts.data_ptr(), l_parts.data_ptr(), out.data_ptr(),
             b, h, hkv, hd, nb, bs, nmax, splits, DTYPE_CODES[q.dtype],
             int(window), float(softcap), 1.0 / math.sqrt(hd),
             _stream(q.device))
    _raise_on_error(what, err)
    return out
