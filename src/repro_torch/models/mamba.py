"""Mamba (S6 selective state space) block, Jamba's SSM layers (counterpart
of `repro/models/mamba.py`).

Training/prefill runs the selective scan as the JAX version does: chunks of
CHUNK = 256 steps when the length divides into such chunks (else one
chunk), the hidden state carried from chunk to chunk, and inside a chunk
an associative scan of ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t`` over
the chunk axis in float32 -- the odd/even recursion of
`jax.lax.associative_scan` (`_assoc_scan`), so the work is O(chunk) in
about log2(chunk) levels of eager ops.  One chunk is a
`torch.autograd.Function` (`_ChunkScan`) that saves only its inputs: its
backward recomputes the states and runs the adjoint recurrence with the
same scan over the reversed chunk, so the bytes of a chunk's backward
grow linearly with its length and no intermediate of the scan is held
between the forward and the backward.  Decode runs one step on an
explicit (B, d_inner, N) float32 state and a (B, K-1, d_inner) conv tail
in the compute dtype.  The JAX version's sharding ``constraint`` calls
have no counterpart on one device and are dropped.
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


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The b part of `jax.lax.associative_scan` over dim 1 with JAX's
    ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``: the same
    odd/even recursion, so h_t = a_t h_{t-1} + b_t with h_0 = b_0 (a_0 is
    never read).  The products of the a's are formed only where a b part
    needs them."""
    n = a.shape[1]
    if n < 2:
        return b
    a_odd = a[:, 1::2]
    odd = _assoc_scan(a[:, 0:-1:2] * a_odd, a_odd * b[:, 0:-1:2] + b[:, 1::2])
    even = a[:, 2::2] * (odd[:, :-1] if n % 2 == 0 else odd) + b[:, 2::2]
    out = b.new_empty(b.shape)
    out[:, 0] = b[:, 0]
    out[:, 2::2] = even
    out[:, 1::2] = odd
    return out


def _chunk_states(dt, a, b_c, u, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's decay exp(dt A) (B, c, di, N) and its states h_0..h_c
    (B, c+1, di, N), h_0 the carried state prepended as step 0's drive with
    a decay of ones (the JAX version's concatenation)."""
    decay = torch.exp(dt[..., None] * a)
    drive = (dt * u.float())[..., None] * b_c[:, :, None, :]
    hs = _assoc_scan(torch.cat([torch.ones_like(decay[:, :1]), decay], 1),
                     torch.cat([h0[:, None], drive], 1))
    return decay, hs


class _ChunkScan(torch.autograd.Function):
    """One chunk of the selective scan: (dt (B, c, di), A (di, N), B / C
    (B, c, N), u (B, c, di), h0 (B, di, N)) -> (y (B, c, di), h_c), all
    float32 but u.  Saves only its inputs; the backward recomputes the
    states and runs the adjoint G_t = C_t dy_t + a_{t+1} G_{t+1}, seeded
    at the last step with the outgoing state's gradient, as the same
    associative scan over the reversed chunk."""

    @staticmethod
    def forward(ctx, dt, a, b_c, c_c, u, h0):
        ctx.save_for_backward(dt, a, b_c, c_c, u, h0)
        _, hs = _chunk_states(dt, a, b_c, u, h0)
        # the state is cloned: a view would keep all of hs alive in the
        # next chunk's saved inputs
        return (torch.einsum("bcdn,bcn->bcd", hs[:, 1:], c_c),
                hs[:, -1].clone())

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, a, b_c, c_c, u, h0 = ctx.saved_tensors
        decay, hs = _chunk_states(dt, a, b_c, u, h0)
        g = c_c[:, :, None, :] * dy[..., None]              # (B,c,di,N)
        g[:, -1] += dh_last
        # reversed, step k carries a_{c-k+1}; step 0's decay is never read
        a_rev = torch.cat([decay[:, :1], decay[:, 1:].flip(1)], 1)
        big_g = _assoc_scan(a_rev, g.flip(1)).flip(1)       # G_1..G_c
        del g, a_rev
        d_dta = big_g * hs[:, :-1] * decay                   # d(dt A)
        uf = u.float()
        dw = torch.einsum("bcdn,bcn->bcd", big_g, b_c)      # d(dt u)
        d_dt = (d_dta * a).sum(-1) + dw * uf
        grads = [d_dt, torch.einsum("bcdn,bcd->dn", d_dta, dt),
                 torch.einsum("bcdn,bcd->bcn", big_g, dt * uf),
                 torch.einsum("bcdn,bcd->bcn", hs[:, 1:], dy),
                 (dw * dt).to(u.dtype),
                 decay[:, 0] * big_g[:, 0]]
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad))


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
        y, h = _ChunkScan.apply(dt[:, sl], a, b_mat[:, sl], c_mat[:, sl],
                                u[:, sl], h)
        ys.append(y)
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
