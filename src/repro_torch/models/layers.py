"""Shared neural-net layers: plain functions over dicts of tensors.

Counterpart of `repro/models/layers.py`.  Parameters keep the JAX layouts
(``w_gate (d, f)``, ``w_down (f, d)``, ``table (V, d)``, ``lm_head (d, V)``)
so that `repro_torch.interop` converts by copying.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = dict


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in float32 on
    the generator's device (the JAX init's distribution, not its bits)."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


# ------------------------------------------------------------------ norms
def init_norm(cfg: ArchConfig, device: torch.device,
              d: int | None = None) -> Params:
    d = d or cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {"scale": torch.ones(d, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dt, device=device)
    return p


def norm_apply(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """RMS or layer norm computed in float32, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             d_ff: int | None = None) -> Params:
    d, dt = cfg.d_model, dtype_of(cfg.param_dtype)
    f = d_ff or cfg.d_ff
    scale = 1.0 / math.sqrt(d)
    p = {"w_down": trunc_normal(gen, (f, d), 1.0 / math.sqrt(f), dt)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = trunc_normal(gen, (d, f), scale, dt)
        p["w_up"] = trunc_normal(gen, (d, f), scale, dt)
    else:
        p["w_up"] = trunc_normal(gen, (d, f), scale, dt)
    return p


def mlp_apply(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    if cfg.activation in ("swiglu", "geglu"):
        gate = x @ params["w_gate"].to(cdt)
        up = x @ params["w_up"].to(cdt)
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(gate) if cfg.activation == "swiglu" else F.gelu(
            gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(x @ params["w_up"].to(cdt), approximate="tanh")
    return h @ params["w_down"].to(cdt)


# ------------------------------------------------------------- embeddings
def init_embedding(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dt = dtype_of(cfg.param_dtype)
    p = {"table": trunc_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = trunc_normal(gen, (cfg.d_model, cfg.vocab_size),
                                    1.0 / math.sqrt(cfg.d_model), dt)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    return params["table"].to(dtype_of(cfg.compute_dtype))[tokens]


def lm_logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    head = params["table"].T if cfg.tie_embeddings else params["lm_head"]
    return x.to(cdt) @ head.to(cdt)
