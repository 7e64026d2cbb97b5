"""Grouped-query attention with RoPE variants, qk-norm, QKV-bias, logit
soft-cap and sliding windows; the train/prefill forward, the paged decode
step and the rotating-buffer dense decode cache (counterpart of
`repro/models/attention.py`).

``impl`` selects the train/prefill attention core:

* ``"flash"`` (default) -- the hand-written kernels through
  `repro_torch.kernels.ops`: flash-attention forward for train/prefill,
  paged flash-decode for decode.  On CUDA tensors they launch the kernels;
  on CPU tensors the wrappers run their plain versions.
* ``"plain"`` -- the masked `_sdpa` (and, for decode, a gather of the block
  table into a dense view): the counterpart of the JAX ``"xla"`` oracle.
* ``"chunked"`` -- `_sdpa_chunked`, the masked `_sdpa` over query chunks of
  512 (scores (B, Hkv, G, 512, S) at a time); ``"auto"`` takes it from
  2,048 tokens on and the plain path below.  Paged decode takes
  ``"flash"`` or ``"plain"``.

The dense decode cache (`init_cache`, `attention_decode`,
`fill_cache_from_prefill`) keeps absolute positions per slot, so one code
path serves full and sliding-window attention; `attention_decode` always
runs `_sdpa` over the whole buffer, as the JAX version does.  The JAX
version's sharding ``constraint`` calls (``decode_coshard`` included) are
layout hints with no meaning on one device and are dropped.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import dtype_of, init_norm, norm_apply, trunc_normal
from repro_torch.serve import kv_cache as kvc

NEG_INF = -1e30
IMPLS = ("flash", "plain", "chunked", "auto")
# the impls that the paged decode step, the serving engine and the
# launcher accept (they have no chunked path)
KERNEL_IMPLS = ("flash", "plain")
CHUNK_FROM = 2048                 # "auto" runs `_sdpa_chunked` from here


def check_impl(impl: str, impls: tuple[str, ...] = IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"unknown impl {impl!r} ({' | '.join(impls)})")


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = dtype_of(cfg.param_dtype)
    scale = 1.0 / math.sqrt(d)
    p = {
        "wq": trunc_normal(gen, (d, cfg.n_heads, hd), scale, dt),
        "wk": trunc_normal(gen, (d, cfg.n_kv_heads, hd), scale, dt),
        "wv": trunc_normal(gen, (d, cfg.n_kv_heads, hd), scale, dt),
        "wo": trunc_normal(gen, (cfg.n_heads, hd, d),
                           1.0 / math.sqrt(cfg.n_heads * hd), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dt, device=gen.device)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dt, device=gen.device)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dt, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(cfg, gen.device, hd)
        p["k_norm"] = init_norm(cfg, gen.device, hd)
    return p


def _project_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor):
    """x: (B, S, d) -> q (B, S, H, hd), k/v (B, S, Hkv, hd), contiguous;
    qk-norm before RoPE."""
    cdt = dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    if cfg.qk_norm:
        q = norm_apply(params["q_norm"], q, cfg)
        k = norm_apply(params["k_norm"], k, cfg)
    if cfg.rope != "none":
        cos, sin = rope_mod.rope_angles(cfg, positions, cfg.resolved_head_dim)
        q = rope_mod.apply_rope(q, cos, sin)
        k = rope_mod.apply_rope(k, cos, sin)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _sdpa(q, k, v, cfg: ArchConfig, mask: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention core.  q: (B,T,H,hd), k/v: (B,S,Hkv,hd),
    mask: (B,T,S) or broadcastable boolean (True = attend).  Logits in the
    compute dtype, then float32 (divided by sqrt(hd) after the dot)."""
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, hd)
    logits = torch.einsum("bthgk,bshk->bhgts", qg, k).float()
    logits = logits / math.sqrt(hd)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshk->bthgk", probs.to(v.dtype), v)
    return out.reshape(b, t, h, hd)


def causal_mask(t: int, s: int, window: int,
                device: torch.device | None = None,
                offset: int = 0) -> torch.Tensor:
    """(t, s) boolean mask.  Query i (absolute position offset + i) may
    attend to key j iff j <= offset + i and, when window > 0,
    offset + i - j < window."""
    qpos = torch.arange(t, device=device)[:, None] + offset
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= (qpos - kpos) < window
    return m


def _sdpa_chunked(q, k, v, cfg: ArchConfig, *,
                  block_q: int = 512) -> torch.Tensor:
    """Causal attention over query chunks of ``block_q`` (the last one
    zero-padded), so the float32 scores are (B, Hkv, G, block_q, S) at a
    time instead of (B, Hkv, G, T, S); each chunk is `_sdpa` under its own
    causal and window mask, as the JAX version's `lax.scan` body."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    block_q = min(block_q, t)
    pad = -t % block_q
    if pad:
        q = torch.cat([q, q.new_zeros((b, pad, h, hd))], dim=1)
    outs = []
    for i in range(0, t + pad, block_q):
        mask = causal_mask(block_q, s, cfg.sliding_window, device=q.device,
                           offset=i)
        outs.append(_sdpa(q[:, i:i + block_q], k, v, cfg, mask[None]))
    return torch.cat(outs, dim=1)[:, :t]


def attention_train(params: dict, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, impl: str = "flash"
                    ) -> torch.Tensor:
    """Full-sequence causal attention (training forward)."""
    return attention_prefill(params, x, cfg, positions, impl)[0]


def attention_prefill(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, impl: str = "flash"
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal attention that also hands back the projected
    (post-RoPE) k/v for the serving prefill.
    -> (y (B, S, d), k, v (B, S, Hkv, hd))."""
    check_impl(impl)
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, positions)
    if impl == "flash":
        out = kops.flash_attention(q, k, v, causal=True,
                                   window=cfg.sliding_window,
                                   softcap=cfg.logit_softcap)
    elif impl == "chunked" or (impl == "auto" and s >= CHUNK_FROM):
        out = _sdpa_chunked(q, k, v, cfg)
    else:
        mask = causal_mask(s, s, cfg.sliding_window, device=x.device)[None]
        out = _sdpa(q, k, v, cfg, mask)
    cdt = dtype_of(cfg.compute_dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cdt))
    return y, k, v


# ------------------------------------------------------------------ KV cache
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    """Rotating-buffer cache, zero-filled, every slot's position -1.  With
    a sliding window only ``min(max_len, window)`` slots are kept."""
    buf = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    dt = dtype_of(cfg.compute_dtype)
    return {
        "k": torch.zeros((batch, buf, hkv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, buf, hkv, hd), dtype=dt, device=device),
        "pos": torch.full((batch, buf), -1, dtype=torch.int32, device=device),
    }


def attention_decode(params: dict, x: torch.Tensor, cfg: ArchConfig,
                     cur: int, cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, d); ``cur``: the new token's absolute
    position.  Its k/v and position go into slot ``cur % buf`` of the cache
    (in place), then the query attends to every slot whose position is
    valid: written, not after ``cur`` and, with a window, within it.
    -> (y (B, 1, d), cache)."""
    cur = int(cur)
    b = x.shape[0]
    positions = rope_mod.default_positions(cfg, b, 1, offset=cur,
                                           device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = cur % ck.shape[1]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    cpos[:, slot] = cur
    valid = (cpos >= 0) & (cpos <= cur)
    if cfg.sliding_window:
        valid &= (cur - cpos) < cfg.sliding_window
    out = _sdpa(q, ck, cv, cfg, valid[:, None, :])
    cdt = dtype_of(cfg.compute_dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cdt))
    return y, cache


def fill_cache_from_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                            cfg: ArchConfig) -> dict:
    """Fill a rotating-buffer cache (in place) from a batched prefill's
    k/v (B, S, Hkv, hd) for absolute positions 0..S-1: each lands where S
    `attention_decode` steps would have put it (slot = pos % buf; only
    the last ``buf`` positions survive a sliding-window rotation)."""
    s = k.shape[1]
    buf = cache["k"].shape[1]
    m = min(s, buf)
    pos = torch.arange(s - m, s, dtype=torch.int32, device=k.device)
    slots = (pos % buf).long()
    cache["k"][:, slots] = k[:, s - m:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, s - m:].to(cache["v"].dtype)
    cache["pos"][:, slots] = pos[None].expand(cache["pos"].shape[0], m)
    return cache


def attention_paged_decode(params: dict, x: torch.Tensor, cfg: ArchConfig,
                           pools: dict, block_tables: torch.Tensor,
                           lengths: torch.Tensor, impl: str = "flash"
                           ) -> tuple[torch.Tensor, dict]:
    """One-token decode against the paged block pool.

    x: (B, 1, d); pools: {"k_pool", "v_pool"} (num_blocks, bs, Hkv, hd);
    block_tables: (B, max_blocks) int32; lengths: (B,) int32 -- context
    length INCLUDING the token being decoded (it sits at position
    ``lengths - 1``; 0 marks an inactive lane, whose write is skipped and
    whose output the engine ignores).  The new token's k/v go into the
    pools (in place) before attention reads them.
    -> (y (B, 1, d), pools)."""
    check_impl(impl, KERNEL_IMPLS)
    b = x.shape[0]
    positions = rope_mod.default_positions(
        cfg, b, 1, offset=(lengths.long() - 1).clamp(min=0)[:, None])
    q, k, v = _project_qkv(params, x, cfg, positions)
    kp, vp = kvc.write_token_kv(pools["k_pool"], pools["v_pool"],
                                k[:, 0], v[:, 0], block_tables, lengths - 1)
    if impl == "flash":
        out = kops.flash_decode(q[:, 0].contiguous(), kp, vp, block_tables,
                                lengths, window=cfg.sliding_window,
                                softcap=cfg.logit_softcap)[:, None]
    else:
        ck = kvc.gather_kv(kp, block_tables)
        cv = kvc.gather_kv(vp, block_tables)
        kpos = torch.arange(ck.shape[1], device=x.device)[None, :]
        lens = lengths.long()[:, None]
        mask = kpos < lens
        if cfg.sliding_window:
            mask &= (lens - 1 - kpos) < cfg.sliding_window
        out = _sdpa(q, ck, cv, cfg, mask[:, None, :])
    cdt = dtype_of(cfg.compute_dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cdt))
    return y, {"k_pool": kp, "v_pool": vp}
