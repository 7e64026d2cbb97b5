"""Top-level model: embeddings + super-blocks + LM head (counterpart of
`repro/models/model.py`).

Input modes (per ArchConfig.input_mode):
  tokens          : {"tokens": (B, S) int}
  embeds          : {"frame_embeds": (B, S, d)}            (audio stub)
  tokens+patches  : {"tokens": (B, S_text) int,
                     "patch_embeds": (B, P, d)}            (vision stub;
                     patches first, total sequence P + S_text)

The modality frontends (EnCodec, ViT) are stubs, as in the JAX package:
the decoder takes precomputed embeddings of the right shape.

Parameters are a nested dict of tensors in the JAX layouts:
``{"embed": {"table", "lm_head"?}, "blocks": [per-super-block dict, ...],
"final_norm": {"scale"}}`` -- the JAX tree with its stacked ``blocks``
unstacked into a list (`repro_torch.interop` converts).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import rope as rope_mod
from repro_torch.models.pjit_utils import constraint
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (dtype_of, embed_tokens, init_embedding,
                                       init_norm, lm_logits, norm_apply)


def init_model(gen: torch.Generator, cfg: ArchConfig,
               device: str | torch.device | None = None) -> dict:
    """Random params drawn from ``gen``, which must live on ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator is on {gen.device}, params go to {device}")
    return {
        "embed": init_embedding(gen, cfg),
        "blocks": tf.init_stacked_blocks(gen, cfg),
        "final_norm": init_norm(cfg, gen.device),
    }


class _MetaGenerator(torch.Generator):
    """A generator whose tensors the initialisers place on the meta device
    (they allocate on ``gen.device``): shapes and dtypes, no memory, no
    draws."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_skeleton(cfg: ArchConfig) -> dict:
    """`init_model`'s tree as meta tensors: the structure, shapes and dtypes
    a checkpoint restores into, without allocating or drawing."""
    return init_model(_MetaGenerator(), cfg, device="meta")


def _input_embeds(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.input_mode == "embeds":
        return batch["frame_embeds"].to(dtype_of(cfg.compute_dtype))
    if cfg.input_mode == "tokens+patches":
        text = embed_tokens(params["embed"], batch["tokens"], cfg)
        patches = batch["patch_embeds"].to(text.dtype)
        return torch.cat([patches, text], dim=1)
    raise ValueError(cfg.input_mode)


def _positions(batch: dict, cfg: ArchConfig, b: int, s: int,
               device: torch.device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = rope_mod.default_positions(cfg, b, s, device=device)
    return positions


def forward_train(params: dict, batch: dict, cfg: ArchConfig, *,
                  impl: str = "flash", remat: str = "none"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """batch in the config's input mode -> (logits (B, S_total, vocab), MoE
    aux loss).  Differentiable with every impl; ``impl="flash"`` trains
    attention through the flash-attention forward and backward kernels
    and the sLSTM recurrence through the sLSTM scan forward and backward
    kernels.  ``remat`` ("none" | "full" | "dots") rematerialises each
    super-block in the backward (`transformer.stack_train`)."""
    x = _input_embeds(params, batch, cfg)
    b, s, _ = x.shape
    x = constraint(x, "act_batch", "act_seq", None)
    x, aux = tf.stack_train(params["blocks"], x, cfg,
                            _positions(batch, cfg, b, s, x.device), impl=impl,
                            remat=remat)
    x = norm_apply(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), aux


def prefill_forward(params: dict, batch: dict, cfg: ArchConfig, *,
                    impl: str = "flash") -> tuple[torch.Tensor, list[dict]]:
    """Batched serving prefill: one forward over the prompt that also
    returns every layer's projected k/v for cache filling.
    -> (logits (B, S, vocab), [{"pos{i}": (k, v)} per super-block]).
    Attention-only patterns; tokens input mode."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"prefill_forward requires input_mode='tokens', got "
            f"{cfg.input_mode}")
    x = _input_embeds(params, batch, cfg)
    b, s, _ = x.shape
    x, kvs = tf.stack_prefill(params["blocks"], x, cfg,
                              _positions(batch, cfg, b, s, x.device),
                              impl=impl)
    x = norm_apply(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), kvs


def init_paged_state(cfg: ArchConfig, num_blocks: int, block_size: int,
                     device: str | torch.device | None = None) -> list[dict]:
    """Per-layer paged block pools (serving decode state) on ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    return tf.init_stacked_paged_state(cfg, num_blocks, block_size,
                                       resolve_device(device))


def paged_decode_step(params: dict, state: list[dict], batch: dict,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      cfg: ArchConfig, *, impl: str = "flash"
                      ) -> tuple[torch.Tensor, list[dict]]:
    """One-token decode against the paged cache.  batch: {"tokens": (B, 1)};
    lengths: (B,) context length including this token (0 = inactive lane).
    The pools in ``state`` are written in place.
    -> (logits (B, 1, V), state)."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    x, state = tf.stack_paged_decode(params["blocks"], state, x, cfg,
                                     block_tables, lengths, impl=impl)
    x = norm_apply(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), state


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: str | torch.device | None = None) -> list[dict]:
    """The dense decode state (a rotating KV cache per attention layer, the
    recurrent state of the others), one dict per super-block, on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``)."""
    return tf.init_stacked_state(cfg, batch, max_len, resolve_device(device))


def decode_step(params: dict, state: list[dict], batch: dict, cur: int,
                cfg: ArchConfig) -> tuple[torch.Tensor, list[dict]]:
    """One-token decode.  batch: {"tokens": (B, 1)} or {"frame_embeds":
    (B, 1, d)}; ``cur``: the token's absolute position.  Attention caches
    in ``state`` are written in place.  -> (logits (B, 1, V), new state)."""
    if "tokens" in batch:
        x = embed_tokens(params["embed"], batch["tokens"], cfg)
    else:
        x = batch["frame_embeds"].to(dtype_of(cfg.compute_dtype))
    x, state = tf.stack_decode(params["blocks"], state, x, cfg, int(cur))
    x = norm_apply(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), state


def count_params(params: dict) -> int:
    def leaves(t):
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            for v in t:
                yield from leaves(v)
    return sum(x.numel() for x in leaves(params))
