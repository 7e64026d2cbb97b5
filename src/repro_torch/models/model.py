"""Top-level model: embeddings + super-blocks + LM head (counterpart of
`repro/models/model.py`, token input mode).

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
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (embed_tokens, init_embedding, init_norm,
                                       lm_logits, norm_apply)


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


def _require_tokens(cfg: ArchConfig, what: str) -> None:
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{what} requires input_mode='tokens', got {cfg.input_mode} (the "
            "audio / vision frontends are not ported yet)")


def _positions(batch: dict, cfg: ArchConfig, b: int, s: int,
               device: torch.device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = rope_mod.default_positions(cfg, b, s, device=device)
    return positions


def forward_train(params: dict, batch: dict, cfg: ArchConfig, *,
                  impl: str = "flash") -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S) int} -> (logits (B, S, vocab), aux loss).
    Differentiable with either impl; ``impl="flash"`` trains attention
    through the flash-attention forward and backward kernels and the sLSTM
    recurrence through the sLSTM scan forward and backward kernels."""
    _require_tokens(cfg, "forward_train")
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    b, s, _ = x.shape
    x, aux = tf.stack_train(params["blocks"], x, cfg,
                            _positions(batch, cfg, b, s, x.device), impl=impl)
    x = norm_apply(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), aux


def prefill_forward(params: dict, batch: dict, cfg: ArchConfig, *,
                    impl: str = "flash") -> tuple[torch.Tensor, list[dict]]:
    """Batched serving prefill: one forward over the prompt that also
    returns every layer's projected k/v for cache filling.
    -> (logits (B, S, vocab), [{"pos{i}": (k, v)} per super-block])."""
    _require_tokens(cfg, "prefill_forward")
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
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
