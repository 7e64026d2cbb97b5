"""Top-k mixture-of-experts with capacity-based dispatch (counterpart of
`repro/models/moe.py`).

Router: softmax over experts in float32, top-k (the lower expert index
first on ties, as `jax.lax.top_k`; `torch.topk` promises no order, so a
stable sort stands in), combine weights renormalised over the k, and the
load-balance auxiliary loss aux = E * sum_e f_e * P_e (Shazeer et al.).

Each (token, k) pair takes the next slot of its expert's capacity buffer
(a running count in (token, k) order); pairs past the capacity go to an
overflow bin that is dropped.  Every kept pair owns a distinct
(expert, slot), so the dispatch is a plain indexed write; the experts run
as stacked matmuls over every capacity slot; the combine sums each
token's k weighted outputs in k order, a fixed order that gives the same
bits on every run (no atomics).  Dispatch runs in ``cfg.moe_groups``
independent groups over the token dim, one group when the tokens do not
divide.  The JAX version's sharding ``constraint`` calls have no
counterpart on one device and are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dtype_of, trunc_normal


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.resolved_moe_d_ff, cfg.n_experts
    dt = dtype_of(cfg.param_dtype)
    scale = 1.0 / math.sqrt(d)
    p = {"router": trunc_normal(gen, (d, e), scale, torch.float32),
         "w_down": trunc_normal(gen, (e, f, d), 1.0 / math.sqrt(f), dt)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = trunc_normal(gen, (e, d, f), scale, dt)
        p["w_up"] = trunc_normal(gen, (e, d, f), scale, dt)
    else:
        p["w_up"] = trunc_normal(gen, (e, d, f), scale, dt)
    return p


def capacity(cfg: ArchConfig, num_tokens: int) -> int:
    c = math.ceil(num_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cfg.top_k, min(c, num_tokens))


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in the compute dtype, aux loss)."""
    cdt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = cfg.moe_groups if cfg.moe_groups > 0 and t % cfg.moe_groups == 0 else 1
    tg = t // g
    cap = capacity(cfg, tg)
    xf = x.reshape(g, tg, d).to(cdt)

    # ---- router (float32)
    logits = xf.float() @ params["router"].float()               # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                               # (G, Tg, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # ---- load-balance aux loss (per group, averaged)
    me = probs.mean(dim=1)                                       # (G, E)
    flat_e = top_e.reshape(g, tg * k)                            # (G, Tg*k)
    # one-hot by comparison, not F.one_hot: the same ops on every device
    # (F.one_hot checks its input's range on the host for some devices and
    # not others), so the cost counter counts the same on meta and the card
    onehot = (flat_e[..., None] == torch.arange(e, device=x.device)).long()
    ce = onehot.sum(dim=1).float() / (tg * k)
    aux = cfg.router_aux_weight * e * torch.sum(me * ce) / g

    # ---- slot of each (token, k) pair in its expert's buffer: the running
    # count of its expert over the pairs before it, in (token, k) order
    slot = torch.gather(onehot.cumsum(dim=1) - 1, 2, flat_e[..., None])[..., 0]
    keep = slot < cap
    slot_c = torch.where(keep, slot, cap)                        # overflow bin

    # ---- dispatch: kept pairs own distinct (expert, slot); the dropped
    # ones all land in bin ``cap``, which is cut off
    gsel = torch.arange(g, device=x.device)[:, None].expand(g, tg * k)
    tok_idx = torch.arange(tg, device=x.device).repeat_interleave(k)
    buf = xf.new_zeros((g, e, cap + 1, d))
    buf[gsel, flat_e, slot_c] = xf[:, tok_idx]
    buf = buf[:, :, :cap]

    # ---- expert FFN as stacked matmuls over every capacity slot
    if cfg.activation in ("swiglu", "geglu"):
        gate = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(cdt))
        up = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(cdt))
        act = F.silu(gate) if cfg.activation == "swiglu" else F.gelu(
            gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", buf,
                                params["w_up"].to(cdt)), approximate="tanh")
    out = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(cdt))

    # ---- combine: each pair's expert output, weighted; a token's k pairs
    # are adjacent and summed in k order
    pair_out = out[gsel, flat_e, slot_c.clamp(max=cap - 1)]      # (G, Tg*k, d)
    w = (top_p.reshape(g, tg * k) * keep.float()).to(cdt)
    contrib = (pair_out * w[..., None]).reshape(g, tg, k, d)
    y = xf.new_zeros((g, tg, d))
    for j in range(k):
        y = y + contrib[:, :, j]
    return y.reshape(b, s, d), aux
