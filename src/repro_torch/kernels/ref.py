"""Plain PyTorch versions of the hand-written kernels.

Counterpart of `repro/kernels/ref.py`.  These are what the kernel wrappers
in `ops` run on CPU tensors, and what the CUDA kernels are held against on
the card.  Both follow the kernels' numerics contract: inputs are upcast to
float32, q is multiplied by ``1/sqrt(head_dim)`` before the dot, masked
logits are ``NEG_INF = -1e30`` (not -inf), and a row with no live key gives
``o = 0`` and ``lse = -1e30``; a decode lane with ``lengths == 0`` gives
exact zeros.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _masked_softmax_out(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                        eq: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-contract softmax over the last axis of masked f32 logits ``s``
    then ``einsum(eq, p, v)``.  -> (unnormalised out / denom, lse)."""
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    denom = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum(eq, p / denom, v)
    return out, (m + torch.log(denom))[..., 0]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, T, H, hd); k/v: (B, S, Hkv, hd) with H % Hkv == 0.
    -> (o (B, T, H, hd) in q's dtype, lse (B, H, T) float32).  Query i and
    key j sit at positions i and j (no offset), as in the kernel."""
    b, t, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.float().reshape(b, t, hkv, group, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bthgk,bshk->bhgts", qg, k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones(t, s_len, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    out, lse = _masked_softmax_out(s, mask, v.float(), "bhgts,bshk->bthgk")
    return (out.reshape(b, t, h, hd).to(q.dtype),
            lse.reshape(b, h, t))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """(B, T, H, hd) output of `flash_attention_fwd_ref`."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)[0]


def flash_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Paged single-query attention: gather the table into a dense view,
    then a masked float32 softmax.

    q: (B, H, hd); k_pool/v_pool: (num_blocks, block_size, Hkv, hd);
    block_tables: (B, max_blocks) int; lengths: (B,) int -- tokens in cache
    including the one being decoded (query position = lengths - 1).
    Rows with lengths == 0 return zeros.  -> (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    group = h // hkv
    s_len = block_tables.shape[1] * bs
    tables = block_tables.long()
    k = k_pool[tables].reshape(b, s_len, hkv, hd).float()
    v = v_pool[tables].reshape(b, s_len, hkv, hd).float()
    qg = q.float().reshape(b, hkv, group, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bhgk,bshk->bhgs", qg, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    lengths = lengths.long()
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if window > 0:
        mask &= ((lengths - 1)[:, None] - kpos) < window
    out, _ = _masked_softmax_out(s, mask[:, None, None, :], v,
                                 "bhgs,bshk->bhgk")
    return out.reshape(b, h, hd).to(q.dtype)
