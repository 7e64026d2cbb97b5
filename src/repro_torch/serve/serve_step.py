"""Offline generation over the dense decode state (counterpart of
`repro/serve/serve_step.py`).

``serve_step`` is one decode step for every sequence of the batch: the
model's `decode_step`, then the next token greedy or sampled.
``generate`` is the offline path: a prefill (one batched forward for
attention-only token models, a per-token decode loop otherwise), then
``max_new`` decode steps over the rotating dense cache.  The
continuous-batching `engine.ServeEngine` over the paged cache is the
online path.

Sampling reproduces the JAX package's draws: the key is
``prng_key(seed)``, split once per position before its step, and a
sampled token is ``jax.random.categorical(sub, logits / temperature)``
(`core.prng.categorical`).  The JAX version jit-compiles its step, where
XLA rewrites the division by the constant temperature as a product with
its float32 reciprocal; the port multiplies by that reciprocal too.  There
is no jit here: a step runs eagerly where ``params`` live.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.tree import tree_leaves


def serve_step(params: dict, state: list[dict], tokens_or_embeds: dict,
               cur: int, cfg: ArchConfig, *, temperature: float = 0.0,
               rng: tuple[int, int] | None = None
               ) -> tuple[torch.Tensor, list[dict]]:
    """-> (next token (B,) int64, new state).  Greedy when temperature is
    0; else sampled with the `core.prng` key ``rng``."""
    if temperature > 0.0 and rng is None:
        raise ValueError(
            "serve_step: temperature > 0 requests sampling but rng is None -- "
            "pass a PRNG key via rng, or set temperature=0.0 for greedy")
    logits, state = model_mod.decode_step(params, state, tokens_or_embeds,
                                          cur, cfg)
    logits = logits[:, 0].float()
    if temperature > 0.0:
        inv = float(np.float32(1.0) / np.float32(temperature))
        nxt = prng.categorical(rng, logits * inv)
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt, state


def _batched_prefill(params: dict, prompt: torch.Tensor, cfg: ArchConfig,
                     max_len: int, key: tuple[int, int]
                     ) -> tuple[list[dict], tuple[int, int]]:
    """One forward pass over prompt[:, :-1] (the plain attention path, the
    JAX version's default), the caches filled from its k/v.  Burns the
    same key splits as the per-token loop, so sampled generation equals
    the loop's.  -> (decode state ready for position plen-1, advanced
    key)."""
    b, plen = prompt.shape
    state = model_mod.init_decode_state(cfg, b, max_len, prompt.device)
    for _ in range(plen - 1):                    # key parity with the loop
        key, _ = prng.split(key)
    if plen > 1:
        _, kvs = model_mod.prefill_forward(
            params, {"tokens": prompt[:, :-1]}, cfg, impl="plain")
        for layer_state, layer_kv in zip(state, kvs):
            for name, (k, v) in layer_kv.items():
                attn_mod.fill_cache_from_prefill(layer_state[name], k, v, cfg)
    return state, key


@torch.inference_mode()
def generate(params: dict, prompt, cfg: ArchConfig, *, max_new: int = 32,
             max_len: int | None = None, temperature: float = 0.0,
             seed: int = 0, prefill: str = "auto") -> torch.Tensor:
    """Greedy or sampled generation: prefill, then ``max_new`` decode steps.
    ``prompt``: (B, P) token ids (a tensor or array), moved to the params'
    device.  -> (B, P + max_new) int64 tokens on that device.

    prefill="batched": one forward pass over the prompt (attention-only
    patterns, tokens input mode).  "loop": per-token decode over the
    prompt (any architecture; the parity oracle).  "auto" picks batched
    when the model supports it.
    """
    device = tree_leaves(params)[0].device
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(device=device, dtype=torch.int64)
    b, plen = prompt.shape
    if max_len is None:
        max_len = plen + max_new
    elif max_len < plen + max_new:
        raise ValueError(
            f"max_len={max_len} cannot hold the prompt ({plen} tokens) plus "
            f"max_new={max_new} generated tokens; the decode cache would be "
            f"overrun -- pass max_len >= {plen + max_new}")
    if prefill not in ("auto", "batched", "loop"):
        raise ValueError(f"unknown prefill mode {prefill!r}")
    batchable = (cfg.input_mode == "tokens"
                 and all(kind == "attn" for kind in cfg.pattern))
    if prefill == "auto":
        prefill = "batched" if batchable else "loop"

    key = prng.prng_key(seed)

    def step(state, tok, t, sub):
        return serve_step(params, state, {"tokens": tok}, t, cfg,
                          temperature=temperature,
                          rng=sub if temperature > 0.0 else None)

    if prefill == "batched":
        state, key = _batched_prefill(params, prompt, cfg, max_len, key)
    else:
        state = model_mod.init_decode_state(cfg, b, max_len, device)
        for t in range(plen - 1):
            key, sub = prng.split(key)
            _, state = step(state, prompt[:, t:t + 1], t, sub)
    out = [prompt]
    cur_tok = prompt[:, -1:]
    for t in range(plen - 1, plen - 1 + max_new):
        key, sub = prng.split(key)
        nxt, state = step(state, cur_tok, t, sub)
        cur_tok = nxt[:, None]
        out.append(cur_tok)
    return torch.cat(out, dim=1)
