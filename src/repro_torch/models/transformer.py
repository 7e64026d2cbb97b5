"""Block assembly: pattern-driven super-blocks run over depth (counterpart
of `repro/models/transformer.py`: attention, mamba, mLSTM and sLSTM
mixers, dense MLPs and MoE).

A *super-block* is one repetition of ``cfg.pattern``.  Where the JAX version
stacks all ``cfg.num_super_blocks`` repetitions on a leading axis and runs
one `jax.lax.scan`, the port keeps a list of per-super-block parameter
dicts (``blocks[i]["pos{j}"]``) and a Python loop over them; decode states
are lists the same way (``states[i]["pos{j}"]``).

Every block kind trains and decodes (`stack_train`, `stack_decode`).  The
batched prefill and the paged decode take attention-only patterns, as in
the JAX package.

**Rematerialisation** (`stack_train`'s ``remat``, the JAX package's
``jax.checkpoint`` of the scan body): ``"full"`` runs each super-block
under `torch.utils.checkpoint.checkpoint` (``use_reentrant=False``), which
keeps the block's input and recomputes everything else in the backward;
``"dots"`` is the counterpart of
``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``, a selective
checkpoint (`torch.utils.checkpoint.create_selective_checkpoint_contexts`)
that saves the outputs of the matrix products without batch dimensions
and recomputes everything else.  The aten ops the products reach:

* ``x @ w`` with a 2-d weight (the MLPs, the LM head, mamba's and the
  xLSTM blocks' projections) -> ``aten.mm`` after folding the leading
  dims: no batch dimension, saved;
* ``torch.einsum("bsd,dhk->bshk", ...)`` and ``"bshk,hkd->bsd"`` (the
  attention projections q, k, v and o) -> ``aten.bmm`` over a batch of
  ONE (einsum folds every non-contracted dim of each operand into the
  product's rows and columns): no batch dimension in JAX's sense, saved;
* the attention scores and the probabilities' product
  (``"bthgk,bshk->bhgts"``, ``"bhgts,bshk->bthgk"``), the mLSTM scores,
  the MoE experts' ``"gecd,edf->gecf"`` -> ``aten.bmm`` over a batch of
  B·H·G, B·H or the experts: batch dimensions, recomputed (so are the
  kernels K3 / K7, whose products never reach aten).

So the policy saves ``mm``, ``addmm`` and a ``bmm`` whose batch is 1.  One
corner differs from JAX: a batched product whose batch is 1 (a single
sequence, head and group) is saved here and recomputed there.  The
flash path's autograd Functions (K3 / K4, K7 / K8) run their forward again
inside the recomputation, so K3 (K7) launches twice per layer and step.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import dtype_of, init_mlp, init_norm, mlp_apply, norm_apply
from repro_torch.serve import kv_cache as kvc

_MIXER_INIT = {
    "attn": attn_mod.init_attention,
    "mamba": mamba_mod.init_mamba,
    "mlstm": xlstm_mod.init_mlstm,
    "slstm": xlstm_mod.init_slstm,
}


def _position_uses_moe(cfg: ArchConfig, pos: int) -> bool:
    return cfg.n_experts > 0 and pos in cfg.moe_positions


def _has_ffn(cfg: ArchConfig, kind: str, pos: int) -> bool:
    if kind in ("mlstm", "slstm"):
        return False                      # xLSTM blocks subsume the FFN
    return cfg.d_ff > 0 or _position_uses_moe(cfg, pos)


def _require_attn_only(cfg: ArchConfig, what: str) -> None:
    if any(kind != "attn" for kind in cfg.pattern):
        raise NotImplementedError(
            f"{what} supports attention-only patterns; {cfg.name} has "
            f"pattern {cfg.pattern} (recurrent blocks would need their "
            "final state threaded out of the batched forward)")


# ----------------------------------------------------------------- init
def init_super_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Params for one repetition of the pattern (dict keyed by position)."""
    blocks = {}
    for pos, kind in enumerate(cfg.pattern):
        b = {"norm1": init_norm(cfg, gen.device),
             "mixer": _MIXER_INIT[kind](gen, cfg)}
        if _has_ffn(cfg, kind, pos):
            b["norm2"] = init_norm(cfg, gen.device)
            b["ffn"] = (moe_mod.init_moe(gen, cfg)
                        if _position_uses_moe(cfg, pos) else init_mlp(gen, cfg))
        blocks[f"pos{pos}"] = b
    return blocks


def init_stacked_blocks(gen: torch.Generator, cfg: ArchConfig) -> list[dict]:
    """One parameter dict per super-block, in depth order."""
    return [init_super_block(gen, cfg) for _ in range(cfg.num_super_blocks)]


def _ffn_aux(b: dict, x: torch.Tensor, cfg: ArchConfig, kind: str,
             pos: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The position's FFN (dense MLP or MoE) with its residual -> (x, the
    MoE aux loss or None)."""
    if not _has_ffn(cfg, kind, pos):
        return x, None
    h = norm_apply(b["norm2"], x, cfg)
    if _position_uses_moe(cfg, pos):
        y, aux = moe_mod.moe_apply(b["ffn"], h, cfg)
        return x + y, aux
    return x + mlp_apply(b["ffn"], h, cfg), None


def _ffn(b: dict, x: torch.Tensor, cfg: ArchConfig, kind: str,
         pos: int) -> torch.Tensor:
    return _ffn_aux(b, x, cfg, kind, pos)[0]


# ----------------------------------------------------------------- train fwd
def _mixer_train(params: dict, h: torch.Tensor, cfg: ArchConfig, kind: str,
                 positions: torch.Tensor, impl: str) -> torch.Tensor:
    if kind == "attn":
        return attn_mod.attention_train(params, h, cfg, positions, impl)
    if kind == "mamba":
        return mamba_mod.mamba_train(params, h, cfg)
    if kind == "mlstm":
        return xlstm_mod.mlstm_train(params, h, cfg)
    return xlstm_mod.slstm_train(params, h, cfg, impl=impl)


REMAT = ("none", "full", "dots")


def _no_batch_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims`` over aten ops (module
    docstring): save the products without batch dimensions."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def super_block_train(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, impl: str = "flash"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One repetition of the pattern: x (B, S, d) -> (y, the MoE aux
    losses of its positions summed)."""
    blk_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pos, kind in enumerate(cfg.pattern):
        b = params[f"pos{pos}"]
        h = norm_apply(b["norm1"], x, cfg)
        x = x + _mixer_train(b["mixer"], h, cfg, kind, positions, impl)
        x, a = _ffn_aux(b, x, cfg, kind, pos)
        if a is not None:
            blk_aux = blk_aux + a
    return x, blk_aux


def stack_train(blocks: list[dict], x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, *, impl: str = "flash",
                remat: str = "none") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss_sum).  The MoE aux losses add up per
    super-block, then over super-blocks, as the JAX scan carries them.
    ``remat`` ("none", "full" or "dots") rematerialises each super-block
    in the backward (module docstring); the values and gradients are the
    same bits under every choice."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; expected one of {REMAT}")
    body = functools.partial(super_block_train, cfg=cfg, positions=positions,
                             impl=impl)
    if remat == "full":
        body = functools.partial(ckpt.checkpoint, body, use_reentrant=False)
    elif remat == "dots":
        body = functools.partial(
            ckpt.checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _no_batch_dots))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for params in blocks:
        x, blk_aux = body(params, x)
        aux = aux + blk_aux
    return x, aux


# ------------------------------------------------------------------ prefill
def stack_prefill(blocks: list[dict], x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, *, impl: str = "flash"
                  ) -> tuple[torch.Tensor, list[dict]]:
    """One batched forward over the prompt, returning the final hidden
    states and every layer's projected k/v: one {"pos{i}": (k, v)} per
    super-block, k/v (B, S, Hkv, hd).  The caller owns the cache layout."""
    _require_attn_only(cfg, "stack_prefill")
    kvs = []
    for params in blocks:
        layer = {}
        for pos, kind in enumerate(cfg.pattern):
            b = params[f"pos{pos}"]
            h = norm_apply(b["norm1"], x, cfg)
            mixed, k, v = attn_mod.attention_prefill(b["mixer"], h, cfg,
                                                     positions, impl)
            layer[f"pos{pos}"] = (k, v)
            x = _ffn(b, x + mixed, cfg, kind, pos)
        kvs.append(layer)
    return x, kvs


# -------------------------------------------------------------- paged decode
def init_stacked_paged_state(cfg: ArchConfig, num_blocks: int,
                             block_size: int, device: torch.device
                             ) -> list[dict]:
    """Per-layer paged block pools: one {"pos{i}": {"k_pool", "v_pool"}} per
    super-block, pools (num_blocks, block_size, Hkv, hd) zero-filled."""
    _require_attn_only(cfg, "init_stacked_paged_state")
    pc = kvc.PagedCacheConfig(block_size=block_size, num_blocks=num_blocks,
                              max_len=block_size)  # geometry only
    return [{f"pos{pos}": kvc.init_layer_pools(
        pc, cfg.n_kv_heads, cfg.resolved_head_dim,
        dtype_of(cfg.compute_dtype), device)
        for pos in range(len(cfg.pattern))}
        for _ in range(cfg.num_super_blocks)]


def stack_paged_decode(blocks: list[dict], states: list[dict],
                       x: torch.Tensor, cfg: ArchConfig,
                       block_tables: torch.Tensor, lengths: torch.Tensor, *,
                       impl: str = "flash") -> tuple[torch.Tensor, list[dict]]:
    """One-token decode through every layer; the pools are written in
    place and returned."""
    _require_attn_only(cfg, "stack_paged_decode")
    new_states = []
    for params, state in zip(blocks, states):
        layer = {}
        for pos, kind in enumerate(cfg.pattern):
            b = params[f"pos{pos}"]
            h = norm_apply(b["norm1"], x, cfg)
            mixed, layer[f"pos{pos}"] = attn_mod.attention_paged_decode(
                b["mixer"], h, cfg, state[f"pos{pos}"], block_tables,
                lengths, impl)
            x = _ffn(b, x + mixed, cfg, kind, pos)
        new_states.append(layer)
    return x, new_states


# ------------------------------------------------------------------- decode
def init_super_block_state(cfg: ArchConfig, batch: int, max_len: int,
                           device: torch.device) -> dict:
    """One super-block's decode state, keyed by position: a rotating KV
    cache per attention position, the recurrent state of the others."""
    st = {}
    for pos, kind in enumerate(cfg.pattern):
        if kind == "attn":
            st[f"pos{pos}"] = attn_mod.init_cache(cfg, batch, max_len, device)
        elif kind == "mamba":
            st[f"pos{pos}"] = mamba_mod.init_mamba_state(cfg, batch, device)
        elif kind == "mlstm":
            st[f"pos{pos}"] = xlstm_mod.init_mlstm_state(cfg, batch, device)
        else:
            st[f"pos{pos}"] = xlstm_mod.init_slstm_state(cfg, batch, device)
    return st


def init_stacked_state(cfg: ArchConfig, batch: int, max_len: int,
                       device: torch.device) -> list[dict]:
    """One `init_super_block_state` per super-block, in depth order."""
    return [init_super_block_state(cfg, batch, max_len, device)
            for _ in range(cfg.num_super_blocks)]


def _mixer_decode(params: dict, h: torch.Tensor, cfg: ArchConfig, kind: str,
                  cur: int, state: dict) -> tuple[torch.Tensor, dict]:
    if kind == "attn":
        return attn_mod.attention_decode(params, h, cfg, cur, state)
    if kind == "mamba":
        return mamba_mod.mamba_decode(params, h, cfg, state)
    if kind == "mlstm":
        return xlstm_mod.mlstm_decode(params, h, cfg, state)
    return xlstm_mod.slstm_decode(params, h, cfg, state)


def stack_decode(blocks: list[dict], states: list[dict], x: torch.Tensor,
                 cfg: ArchConfig, cur: int) -> tuple[torch.Tensor, list[dict]]:
    """One token (x (B, 1, d)) at absolute position ``cur`` through every
    layer -> (y, new states).  Attention caches are written in place; the
    recurrent states are new tensors."""
    new_states = []
    for params, state in zip(blocks, states):
        layer = {}
        for pos, kind in enumerate(cfg.pattern):
            b = params[f"pos{pos}"]
            h = norm_apply(b["norm1"], x, cfg)
            mixed, layer[f"pos{pos}"] = _mixer_decode(
                b["mixer"], h, cfg, kind, cur, state[f"pos{pos}"])
            x = _ffn(b, x + mixed, cfg, kind, pos)
        new_states.append(layer)
    return x, new_states
