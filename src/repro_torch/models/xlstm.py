"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, recurrent), used by xlstm-125m as an alternating
[mlstm, slstm] super-block pattern (counterpart of
`repro/models/xlstm.py`).

mLSTM training uses the parallel (attention-like) form with a cumulative
log-forget-gate decay matrix and max-stabilised exponential input gates;
decode uses the O(1) recurrent form on a per-head matrix state C (hd x hd),
normalizer n (hd,) and stabiliser m (scalar).  sLSTM is recurrent
(recurrent weights R act on h_{t-1}) in training too.

``impl`` selects the sLSTM recurrence in training:

* ``"flash"`` (default) -- `repro_torch.kernels.ops.slstm_scan`, the
  hand-written scan forward and backward (``csrc/slstm_scan.cu``) on CUDA
  tensors, their plain versions on CPU tensors;
* ``"plain"`` -- a Python loop over `_slstm_cell`, the counterpart of the
  JAX ``"xla"`` `lax.scan`.

Parameters keep the JAX layouts and dtypes: ``w_if``, ``b_if``,
``w_gates``, ``r_gates`` and ``b_gates`` are float32 whatever the
param_dtype.  The JAX version's sharding ``constraint`` calls have no
counterpart on one device and are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import check_impl
from repro_torch.models.layers import dtype_of, trunc_normal


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    d = cfg.d_model
    dp = int(cfg.xlstm_proj_factor * d)
    h = cfg.n_heads
    if dp % h:
        raise ValueError("xlstm proj dim must divide heads")
    return d, dp, h


# ------------------------------------------------------------------- mLSTM
def init_mlstm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, dp, h = _dims(cfg)
    dt = dtype_of(cfg.param_dtype)
    scale = 1.0 / math.sqrt(d)
    return {
        "w_up": trunc_normal(gen, (d, dp), scale, dt),
        "wq": trunc_normal(gen, (dp, dp), 1.0 / math.sqrt(dp), dt),
        "wk": trunc_normal(gen, (dp, dp), 1.0 / math.sqrt(dp), dt),
        "wv": trunc_normal(gen, (dp, dp), 1.0 / math.sqrt(dp), dt),
        "w_if": trunc_normal(gen, (dp, 2 * h), scale, torch.float32),
        "b_if": torch.cat([torch.zeros(h, device=gen.device),
                           3.0 * torch.ones(h, device=gen.device)]),
        "w_down": trunc_normal(gen, (dp, d), 1.0 / math.sqrt(dp), dt),
    }


def _mlstm_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """x (B, L, d) -> q, k, v (B, L, H, hd), input and forget gate
    pre-activations (B, L, H) float32, and the up-projection (B, L, dp)."""
    d, dp, h = _dims(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    up = x.to(cdt) @ params["w_up"].to(cdt)
    q = up @ params["wq"].to(cdt)
    k = up @ params["wk"].to(cdt)
    v = up @ params["wv"].to(cdt)
    gates = up.float() @ params["w_if"] + params["b_if"]
    ig, fg = gates.chunk(2, dim=-1)
    hd = dp // h

    def shp(z):
        return z.reshape(z.shape[0], z.shape[1], h, hd)
    return shp(q), shp(k), shp(v), ig, fg, up


def mlstm_train(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Parallel (quadratic) mLSTM:
    D_ts = exp(sum_{r=s+1..t} logsig f_r + i_s - m_t)."""
    d, dp, h = _dims(cfg)
    hd = dp // h
    q, k, v, ig, fg, up = _mlstm_qkv(params, x, cfg)
    b, l = ig.shape[:2]
    cum = torch.cumsum(F.logsigmoid(fg), dim=1)              # F_t = sum_{r<=t}
    # log decay(t, s) = F_t - F_s + i_s for s <= t
    dmat = cum[:, :, None, :] - cum[:, None, :, :] + ig[:, None, :, :]
    tri = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    dmat = dmat.masked_fill(~tri[None, :, :, None], -math.inf)  # (B,T,S,H)
    m = dmat.amax(dim=2, keepdim=True)                       # stabiliser
    dstab = torch.exp(dmat - m)
    scores = torch.einsum("bthk,bshk->btsh", q.float(),
                          k.float()) / math.sqrt(hd)
    w = scores * dstab
    norm = torch.maximum(w.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    w = w / norm
    out = torch.einsum("btsh,bshk->bthk", w.to(v.dtype), v).reshape(b, l, dp)
    y = out * F.silu(up)                                     # gated residual
    return y @ params["w_down"].to(y.dtype)


def init_mlstm_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> dict:
    d, dp, h = _dims(cfg)
    hd = dp // h
    return {
        "c": torch.zeros((batch, h, hd, hd), device=device),
        "n": torch.zeros((batch, h, hd), device=device),
        "m": torch.full((batch, h), -math.inf, device=device),
    }


def mlstm_decode(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 state: dict) -> tuple[torch.Tensor, dict]:
    """One token (x (B, 1, d)) through the recurrent form."""
    d, dp, h = _dims(cfg)
    hd = dp // h
    q, k, v, ig, fg, up = _mlstm_qkv(params, x, cfg)          # L = 1
    qt, kt, vt = (z[:, 0].float() for z in (q, k, v))         # (B, H, hd)
    it, ft = ig[:, 0], fg[:, 0]                               # (B, H)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + state["m"], it)
    m_new = torch.where(torch.isinf(state["m"]), it, m_new)
    fdec = torch.exp(logf + state["m"] - m_new)
    idec = torch.exp(it - m_new)
    c = fdec[..., None, None] * state["c"] + idec[..., None, None] * (
        kt[..., :, None] * vt[..., None, :])                   # (B, H, hd, hd)
    n = fdec[..., None] * state["n"] + idec[..., None] * kt
    qs = qt / math.sqrt(hd)
    num = torch.einsum("bhk,bhkv->bhv", qs, c)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qs, n).abs(),
                        torch.exp(-m_new))
    out = (num / den[..., None]).reshape(x.shape[0], 1, dp).to(up.dtype)
    y = out * F.silu(up)
    return y @ params["w_down"].to(y.dtype), {"c": c, "n": n, "m": m_new}


# ------------------------------------------------------------------- sLSTM
def init_slstm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, dp, h = _dims(cfg)
    hd = dp // h
    dt = dtype_of(cfg.param_dtype)
    scale = 1.0 / math.sqrt(d)
    return {
        "w_up": trunc_normal(gen, (d, dp), scale, dt),
        "w_gates": trunc_normal(gen, (dp, 4 * dp), 1.0 / math.sqrt(dp),
                                torch.float32),
        # block-diagonal recurrent weights: per head (hd x 4*hd)
        "r_gates": trunc_normal(gen, (h, hd, 4 * hd), 1.0 / math.sqrt(hd),
                                torch.float32),
        "b_gates": torch.zeros(4 * dp, device=gen.device),
        "w_down": trunc_normal(gen, (dp, d), 1.0 / math.sqrt(dp), dt),
    }


def init_slstm_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> dict:
    d, dp, h = _dims(cfg)
    return {"h": torch.zeros((batch, dp), device=device),
            "c": torch.zeros((batch, dp), device=device),
            "n": torch.ones((batch, dp), device=device),
            "m": torch.zeros((batch, dp), device=device)}


def _slstm_cell(params: dict, cfg: ArchConfig, zx: torch.Tensor,
                state: dict) -> dict:
    """zx: (B, 4*dp) pre-activation from input; recurrent contribution
    added.

    r_gates is (H, hd, 4*hd) with the last dim laid out [i|f|z|o] per head;
    the per-head recurrent output is rearranged to the gate-major layout of
    zx ([zi(dp)|zf(dp)|zz(dp)|zo(dp)]) so each gate slice receives its own
    head's recurrence."""
    d, dp, h = _dims(cfg)
    hd = dp // h
    hh = state["h"].reshape(-1, h, hd)
    rec = torch.einsum("bhk,hkg->bhg", hh, params["r_gates"])   # (B, H, 4hd)
    rec = rec.reshape(-1, h, 4, hd).transpose(1, 2).reshape(-1, 4 * dp)
    zi, zf, zz, zo = (zx + rec + params["b_gates"]).chunk(4, dim=-1)
    # stabilised exponential gating (paper eq. 15-17)
    logf = F.logsigmoid(zf)
    m_new = torch.maximum(logf + state["m"], zi)
    i_t = torch.exp(zi - m_new)
    f_t = torch.exp(logf + state["m"] - m_new)
    c = f_t * state["c"] + i_t * torch.tanh(zz)
    n = f_t * state["n"] + i_t
    hnew = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
    return {"h": hnew, "c": c, "n": n, "m": m_new}


def slstm_train(params: dict, x: torch.Tensor, cfg: ArchConfig,
                impl: str = "flash") -> torch.Tensor:
    """x (B, L, d) -> (B, L, d) in the compute dtype.  "flash" runs the
    sLSTM scan kernel; every other impl ("plain", "chunked", "auto") runs
    the plain cell loop, as the JAX version's non-Pallas branch does."""
    check_impl(impl)
    d, dp, h = _dims(cfg)
    hd = dp // h
    cdt = dtype_of(cfg.compute_dtype)
    b, l, _ = x.shape
    up = x.to(cdt) @ params["w_up"].to(cdt)
    zx = up.float() @ params["w_gates"]                      # (B, L, 4dp)

    if impl == "flash":
        # gate-major (B, L, 4dp) -> per-head (B, L, H, 4hd) [i|f|z|o]
        zx_ph = zx.reshape(b, l, 4, h, hd).transpose(2, 3) \
                  .reshape(b, l, h, 4 * hd).contiguous()
        b_ph = params["b_gates"].reshape(4, h, hd).transpose(0, 1) \
                                .reshape(h, 4 * hd).contiguous()
        hs = kops.slstm_scan(zx_ph, params["r_gates"].contiguous(), b_ph)
        y = hs.reshape(b, l, dp).to(cdt)
        return y @ params["w_down"].to(cdt)

    state = init_slstm_state(cfg, b, x.device)
    hs = []
    for t in range(l):
        state = _slstm_cell(params, cfg, zx[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(cdt)                       # (B, L, dp)
    return y @ params["w_down"].to(cdt)


def slstm_decode(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 state: dict) -> tuple[torch.Tensor, dict]:
    """One token (x (B, 1, d)) through `_slstm_cell`."""
    cdt = dtype_of(cfg.compute_dtype)
    up = x.to(cdt) @ params["w_up"].to(cdt)
    zx = (up.float() @ params["w_gates"])[:, 0]
    new = _slstm_cell(params, cfg, zx, state)
    y = new["h"][:, None].to(cdt)
    return y @ params["w_down"].to(cdt), new
