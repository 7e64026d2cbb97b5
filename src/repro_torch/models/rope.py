"""Rotary position embedding variants (counterpart of `repro/models/rope.py`).

standard : one position stream over all head_dim/2 frequency pairs
glm2d    : ChatGLM 2D RoPE -- two sections driven by (position,
           block_position) streams
mrope    : Qwen2-VL multimodal RoPE -- three sections (temporal, height,
           width)

All variants share one code path: the head_dim/2 frequency pairs are cut
into sections, and section s takes its angles from position stream s.
Rotation is rotate-half (the two halves of head_dim), not interleaved.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def num_streams(cfg: ArchConfig) -> int:
    return {"standard": 1, "glm2d": 2, "mrope": 3, "none": 0}[cfg.rope]


def _sections(cfg: ArchConfig, half: int) -> list[int]:
    if cfg.rope == "standard":
        return [half]
    if cfg.rope == "glm2d":
        return [half - half // 2, half // 2]
    if cfg.rope == "mrope":
        a = half // 4
        b = (half - a) // 2
        return [a, b, half - a - b]
    raise ValueError(cfg.rope)


def rope_angles(cfg: ArchConfig, positions: torch.Tensor, head_dim: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (streams, B, S) int -> cos, sin of shape (B, S, head_dim/2),
    float32."""
    half = head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, half) * 2.0 / head_dim))
    inv_freq = torch.tensor(inv_freq, dtype=torch.float32,
                            device=positions.device)
    secs = _sections(cfg, half)
    stream_of_freq = torch.tensor(np.repeat(np.arange(len(secs)), secs),
                                  device=positions.device)
    pos_per_freq = positions.float()[stream_of_freq]        # (half, B, S)
    ang = pos_per_freq.movedim(0, -1) * inv_freq            # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, head_dim); cos/sin: (B, S, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def default_positions(cfg: ArchConfig, batch: int, seq: int,
                      offset: torch.Tensor | int = 0,
                      device: torch.device | None = None) -> torch.Tensor:
    """(streams, B, S) int32 causal-LM positions starting at ``offset``
    (an int or a (B, 1) tensor); extra streams repeat stream 0."""
    ns = max(num_streams(cfg), 1)
    if isinstance(offset, torch.Tensor):
        device = offset.device
    base = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    base = base.to(torch.int32).expand(batch, seq)
    return base[None].expand(ns, batch, seq)
