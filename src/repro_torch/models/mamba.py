"""Mamba (S6 selective state space) block, Jamba's SSM layers (counterpart
of `repro/models/mamba.py`).

Training/prefill runs the selective scan chunk by chunk (CHUNK = 256
steps when the length divides into such chunks, else one chunk), carrying
the hidden state across chunks; inside a chunk the recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t`` runs step by step in float32,
where the JAX version runs `jax.lax.associative_scan`: the same recurrence
with another rounding order.  Decode runs one step on an explicit
(B, d_inner, N) float32 state and a (B, K-1, d_inner) conv tail in the
compute dtype.  The JAX version's sharding ``constraint`` calls have no
counterpart on one device and are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dtype_of, trunc_normal

CHUNK = 256


def _dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    dt_rank = max(1, math.ceil(d / 16))
    return d, di, n, dt_rank


def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, di, n, dt_rank = _dims(cfg)
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    scale = 1.0 / math.sqrt(d)
    # S4D-real initialisation of A; dt_bias = softplus^-1(dt) with dt
    # log-uniform in [1e-3, 1e-1]
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).expand(di, n).clone()
    u = torch.empty(di, dtype=torch.float32, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    return {
        "in_proj": trunc_normal(gen, (d, 2 * di), scale, dt),
        "conv_w": trunc_normal(gen, (cfg.ssm_conv_dim, di),
                               1.0 / math.sqrt(cfg.ssm_conv_dim), dt),
        "conv_b": torch.zeros(di, dtype=dt, device=dev),
        "x_proj": trunc_normal(gen, (di, dt_rank + 2 * n),
                               1.0 / math.sqrt(di), dt),
        "dt_proj": trunc_normal(gen, (dt_rank, di),
                                1.0 / math.sqrt(dt_rank), dt),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "a_log": a_log,
        "d_skip": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": trunc_normal(gen, (di, d), 1.0 / math.sqrt(di), dt),
    }


def _ssm_inputs(params: dict, u: torch.Tensor, cfg: ArchConfig):
    """u: (B, L, di) post-conv activations -> dt (B, L, di), A (di, N),
    B, C (B, L, N), all float32."""
    _, di, n, dt_rank = _dims(cfg)
    cdt = u.dtype
    proj = u @ params["x_proj"].to(cdt)
    dt_x, b_mat, c_mat = proj.split([dt_rank, n, n], dim=-1)
    dt = F.softplus((dt_x @ params["dt_proj"].to(cdt)).float()
                    + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    return dt, a, b_mat.float(), c_mat.float()


def _causal_conv_train(params: dict, x: torch.Tensor,
                       cfg: ArchConfig) -> torch.Tensor:
    """Depthwise causal conv over the sequence.  x: (B, L, di)."""
    k = cfg.ssm_conv_dim
    w = params["conv_w"].to(x.dtype)                         # (K, di)
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(out + params["conv_b"].to(x.dtype))


def _chunk_size(length: int) -> int:
    """The JAX version's chunking: CHUNK-sized chunks when they divide the
    length evenly, else the whole length."""
    nchunks = max(1, length // CHUNK)
    return length // nchunks if length % nchunks == 0 else length


def _selective_scan_chunked(dt, a, b_mat, c_mat, u) -> torch.Tensor:
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t ;  y_t = C_t . h_t.
    dt: (B, L, di) f32, a: (di, N), b/c: (B, L, N), u: (B, L, di).
    -> y (B, L, di) float32; (B, chunk, di, N) tensors at a time."""
    bsz, l, di = u.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=u.device)
    csize = _chunk_size(l)
    ys = []
    for lo in range(0, l, csize):
        sl = slice(lo, lo + csize)
        decay = torch.exp(dt[:, sl, :, None] * a)               # (B,c,di,N)
        drive = ((dt[:, sl] * u[:, sl].float())[..., None]
                 * b_mat[:, sl, None, :])
        hs = []
        for i in range(decay.shape[1]):
            h = decay[:, i] * h + drive[:, i]
            hs.append(h)
        ys.append(torch.einsum("bcdn,bcn->bcd", torch.stack(hs, dim=1),
                               c_mat[:, sl]))
    return torch.cat(ys, dim=1)


def mamba_train(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, L, d) -> (B, L, d) in the compute dtype."""
    cdt = dtype_of(cfg.compute_dtype)
    xz = x.to(cdt) @ params["in_proj"].to(cdt)
    u, z = xz.chunk(2, dim=-1)
    u = _causal_conv_train(params, u, cfg)
    dt, a, b_mat, c_mat = _ssm_inputs(params, u, cfg)
    y = _selective_scan_chunked(dt, a, b_mat, c_mat, u)
    y = y + params["d_skip"] * u.float()
    y = y.to(cdt) * F.silu(z)
    return y @ params["out_proj"].to(cdt)


# ------------------------------------------------------------------- decode
def init_mamba_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> dict:
    _, di, n, _ = _dims(cfg)
    return {
        "h": torch.zeros((batch, di, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, di),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
    }


def mamba_decode(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 state: dict) -> tuple[torch.Tensor, dict]:
    """One token (x (B, 1, d)) through the recurrence -> (y (B, 1, d), new
    state)."""
    cdt = dtype_of(cfg.compute_dtype)
    xz = x.to(cdt) @ params["in_proj"].to(cdt)
    u, z = xz.chunk(2, dim=-1)                               # (B, 1, di)
    hist = torch.cat([state["conv"], u], dim=1)              # (B, K, di)
    w = params["conv_w"].to(cdt)
    u1 = F.silu(torch.einsum("bkd,kd->bd", hist, w)
                + params["conv_b"].to(cdt))[:, None]
    dt, a, b_mat, c_mat = _ssm_inputs(params, u1, cfg)
    decay = torch.exp(dt[:, 0, :, None] * a)                 # (B, di, N)
    drive = (dt[:, 0] * u1[:, 0].float())[..., None] * b_mat[:, 0, None, :]
    h = decay * state["h"] + drive
    y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0])
    y = y + params["d_skip"] * u1[:, 0].float()
    y = (y.to(cdt) * F.silu(z[:, 0]))[:, None]
    return y @ params["out_proj"].to(cdt), {"h": h, "conv": hist[:, 1:]}
