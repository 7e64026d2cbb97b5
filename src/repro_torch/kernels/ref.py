"""Plain PyTorch versions of the hand-written kernels.

Counterpart of `repro/kernels/ref.py`.  These are what the kernel wrappers
in `ops` run on CPU tensors, and what the CUDA kernels are held against on
the card.  Both follow the kernels' numerics contract.  Attention: inputs
are upcast to float32, q is multiplied by ``1/sqrt(head_dim)`` before the
dot, masked logits are ``NEG_INF = -1e30`` (not -inf), and a row with no
live key gives ``o = 0`` and ``lse = -1e30``; a decode lane with
``lengths == 0`` gives exact zeros.  Fused update + mix: the contract of
``csrc/hier_mix.cu`` (float32, ``u = x - (eta*theta) g`` with two
roundings, every sum from 0 in index order, one rounding to the output
dtype), so kernel and plain version agree bit for bit.  sLSTM scan: the
stabilised recurrence in float32 (float64 for float64 inputs) with ``logsigmoid(x) = min(x, 0) -
log1p(exp(-|x|))``, the state entering each chunk as the forward's
residual, and the backward's exact VJP (ties of the stabiliser's max go to
the forget branch, gradient through ``max(n, EPS)`` only where ``n >=
EPS``), as ``csrc/slstm_scan.cu`` computes them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _masked_softmax_out(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                        eq: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-contract softmax over the last axis of masked f32 logits ``s``
    then ``einsum(eq, p, v)``.  -> (unnormalised out / denom, lse)."""
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    denom = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum(eq, p / denom, v)
    return out, (m + torch.log(denom))[..., 0]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, T, H, hd); k/v: (B, S, Hkv, hd) with H % Hkv == 0.
    -> (o (B, T, H, hd) in q's dtype, lse (B, H, T) float32).  Query i and
    key j sit at positions i and j (no offset), as in the kernel.  ``scale``
    defaults to ``1/sqrt(hd)`` (given for inputs padded along hd)."""
    b, t, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qg = q.float().reshape(b, t, hkv, group, hd) * scale
    s = torch.einsum("bthgk,bshk->bhgts", qg, k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones(t, s_len, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    out, lse = _masked_softmax_out(s, mask, v.float(), "bhgts,bshk->bthgk")
    return (out.reshape(b, t, h, hd).to(q.dtype),
            lse.reshape(b, h, t))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """(B, T, H, hd) output of `flash_attention_fwd_ref`."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)[0]


def flash_attention_delta_ref(o: torch.Tensor, do: torch.Tensor
                              ) -> torch.Tensor:
    """The backward's preprocess: o, do (B, T, H, hd) -> delta =
    rowsum(do * o) (B, H, T) in float32 (the TPU wrapper's expression)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0, scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recomputation backward with the kernel's arithmetic: q pre-scaled,
    p = exp(s - lse) on live entries, ds = p (dp - delta) with the softcap
    chain rule, delta = `flash_attention_delta_ref`.  q/o/do (B, T, H, hd),
    k/v (B, S, Hkv, hd), lse (B, H, T) -> (dq, dk, dv) in the primal dtypes,
    dk/dv summed over the GQA group.  ``scale`` as in the forward."""
    b, t, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qg = q.float().reshape(b, t, hkv, group, hd) * scale
    dog = do.float().reshape(b, t, hkv, group, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bthgk,bshk->bhgts", qg, kf)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones(t, s_len, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    lse_g = lse.float().reshape(b, hkv, group, t)[..., None]
    p = torch.where(mask, torch.exp(torch.where(mask, s - lse_g, 0.0)), 0.0)
    dp = torch.einsum("bthgk,bshk->bhgts", dog, vf)
    delta = flash_attention_delta_ref(o, do).reshape(b, hkv, group, t)
    delta = delta[..., None]
    ds = p * (dp - delta)
    if softcap > 0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = torch.einsum("bhgts,bshk->bthgk", ds, kf) * scale
    dk = torch.einsum("bhgts,bthgk->bshk", ds, qg)
    dv = torch.einsum("bhgts,bthgk->bshk", p, dog)
    return (dq.reshape(b, t, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Paged single-query attention: gather the table into a dense view,
    then a masked float32 softmax.

    q: (B, H, hd); k_pool/v_pool: (num_blocks, block_size, Hkv, hd);
    block_tables: (B, max_blocks) int; lengths: (B,) int -- tokens in cache
    including the one being decoded (query position = lengths - 1).
    Rows with lengths == 0 return zeros.  -> (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    group = h // hkv
    s_len = block_tables.shape[1] * bs
    tables = block_tables.long()
    k = k_pool[tables].reshape(b, s_len, hkv, hd).float()
    v = v_pool[tables].reshape(b, s_len, hkv, hd).float()
    qg = q.float().reshape(b, hkv, group, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bhgk,bshk->bhgs", qg, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    lengths = lengths.long()
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if window > 0:
        mask &= ((lengths - 1)[:, None] - kpos) < window
    out, _ = _masked_softmax_out(s, mask[:, None, None, :], v,
                                 "bhgs,bshk->bhgk")
    return out.reshape(b, h, hd).to(q.dtype)


def _update(x: torch.Tensor, g: torch.Tensor, theta: torch.Tensor,
            eta: float) -> torch.Tensor:
    """u = x - (eta * theta_i) * g_i in float32: eta rounded to float32,
    then each product and the difference rounded on its own."""
    a = theta.to(x.device, torch.float32) * float(np.float32(eta))
    return x.float() - a[:, None] * g.float()


def _contract(coef: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[j] = sum_r coef[r, j] * rows[r], the products added to a zero
    float32 sum in order r = 0, 1, ... (the kernel's order)."""
    out = torch.zeros((coef.shape[1],) + tuple(rows.shape[1:]),
                      dtype=torch.float32, device=rows.device)
    for r in range(rows.shape[0]):
        out.add_(coef[r][:, None] * rows[r][None, :])
    return out


def hier_mix_ref(x: torch.Tensor, g: torch.Tensor, t_op: torch.Tensor,
                 theta: torch.Tensor, eta: float) -> torch.Tensor:
    """Fused gated-SGD + averaging (paper Eq. 5, K1):
    out[j] = sum_i T[i, j] * (x[i] - eta * theta[i] * g[i]).
    x, g: (W, C); t_op: (W, W); theta: (W,) -> (W, C) in x's dtype
    (float32 arithmetic, as the TPU kernel; the JAX package's oracle
    computes in x's dtype)."""
    u = _update(x, g, theta, eta)
    return _contract(t_op.to(u.device, torch.float32), u).to(x.dtype)


def hier_mix_grouped_ref(x: torch.Tensor, g: torch.Tensor,
                         scatter: torch.Tensor, broadcast: torch.Tensor,
                         hub: torch.Tensor | None, theta: torch.Tensor,
                         eta: float) -> torch.Tensor:
    """The grouped form (K2): u as in `hier_mix_ref`, z = scatter @ u
    (D, C), z <- H^T z when ``hub`` is given, out = broadcast @ z.
    scatter (D, W), broadcast (W, D), hub (D, D) -> (W, C) in x's dtype."""
    u = _update(x, g, theta, eta)
    z = _contract(scatter.to(u.device, torch.float32).t(), u)
    if hub is not None:
        z = _contract(hub.to(u.device, torch.float32), z)
    return _contract(broadcast.to(u.device, torch.float32).t(),
                     z).to(x.dtype)


# ---------------------------------------------------------------- sLSTM scan
SLSTM_EPS = 1e-6


def _acc_dtype(zx: torch.Tensor) -> torch.dtype:
    return torch.promote_types(zx.dtype, torch.float32)


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def _slstm_step(z: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                m: torch.Tensor, hd: int):
    """One stabilised step from the pre-activation z (..., 4hd) laid out
    [i|f|z|o].  -> (h, c, n, m)."""
    zi, zf, zz, zo = z.split(hd, dim=-1)
    logf = _logsigmoid(zf)
    m_new = torch.maximum(logf + m, zi)
    i_t = torch.exp(zi - m_new)
    f_t = torch.exp(logf + m - m_new)
    c_new = f_t * c + i_t * torch.tanh(zz)
    n_new = f_t * n + i_t
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=SLSTM_EPS)
    return h_new, c_new, n_new, m_new


def _slstm_run(zx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               chunk: int = 0):
    """The recurrence from h = c = m = 0, n = 1.  -> (h (B, T, H, hd)
    float32 or float64, [(h, c, n, m) entering step s for s = 0, chunk, 2 chunk, ...]
    when ``chunk`` > 0)."""
    b, t, h, hd4 = zx.shape
    hd = hd4 // 4
    acc = _acc_dtype(zx)
    z32, r32, bias = zx.to(acc), r_gates.to(acc), b_gates.to(acc)
    zero = z32.new_zeros((b, h, hd))
    state = (zero, zero, torch.ones_like(zero), zero)
    hs, bounds = [], []
    for s in range(t):
        if chunk and s % chunk == 0:
            bounds.append(state)
        z = z32[:, s] + torch.einsum("bhk,hkg->bhg", state[0], r32) + bias
        state = _slstm_step(z, *state[1:], hd)
        hs.append(state[0])
    return torch.stack(hs, 1), bounds


def slstm_scan_ref(zx: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor) -> torch.Tensor:
    """Per-head sLSTM recurrence (K7's plain version).  zx: (B, T, H, 4hd)
    gate pre-activations laid out [i|f|z|o] per head; r_gates (H, hd, 4hd);
    b_gates (H, 4hd) -> h (B, T, H, hd) in zx's dtype.  Differentiable."""
    return _slstm_run(zx, r_gates, b_gates)[0].to(zx.dtype)


def slstm_geometry(bsz: int, t: int, block_b: int, chunk: int
                   ) -> tuple[int, int, int, int]:
    """The TPU kernel's padding: -> (block_b, chunk, Bp, T/chunk) with
    block_b and chunk clamped to B and T, Bp = B rounded up to block_b and
    T/chunk rounded up."""
    block_b, chunk = min(block_b, bsz), min(chunk, t)
    return block_b, chunk, bsz + (-bsz % block_b), -(-t // chunk)


def slstm_scan_fwd_res_ref(zx: torch.Tensor, r_gates: torch.Tensor,
                           b_gates: torch.Tensor, *, block_b: int = 8,
                           chunk: int = 128):
    """Forward with the backward's residuals: -> (h, (h, c, n, m) entering
    each chunk), each bound (Bp, T/chunk, H, hd) float32 (float64 for
    float64 inputs) in padded-batch layout; padded rows run the recurrence on zero input, as the kernel's
    do."""
    bsz, t = zx.shape[:2]
    block_b, chunk, bp, _ = slstm_geometry(bsz, t, block_b, chunk)
    zp = F.pad(zx.to(_acc_dtype(zx)), (0, 0, 0, 0, 0, 0, 0, bp - bsz))
    hs, bounds = _slstm_run(zp, r_gates, b_gates, chunk)
    return hs[:bsz].to(zx.dtype), tuple(
        torch.stack([s[i] for s in bounds], 1) for i in range(4))


def slstm_scan_bwd_ref(zx: torch.Tensor, r_gates: torch.Tensor,
                       b_gates: torch.Tensor, bounds, dh: torch.Tensor, *,
                       block_b: int = 8, chunk: int = 128):
    """Reverse-time exact VJP (K8's plain version), step by step as the
    kernel: chunks last to first, each re-run forward from its entering
    state, then walked backwards.  Padded rows carry zero adjoints and are
    left out.  dR = sum over (b, t) of h_prev^T dz and db = sum of dz are
    taken after the walk, as the kernel's reduction does.
    -> (dzx in zx's dtype, dR in r_gates' dtype, db in b_gates')."""
    bsz, t, h, hd4 = zx.shape
    hd = hd4 // 4
    block_b, chunk, bp, nt = slstm_geometry(bsz, t, block_b, chunk)
    if tuple(bounds[0].shape) != (bp, nt, h, hd):
        raise ValueError(f"chunk-boundary residuals {tuple(bounds[0].shape)} "
                         f"do not match the padded layout {(bp, nt, h, hd)}: "
                         "forward and backward must use the same "
                         "block_b/chunk")
    acc = _acc_dtype(zx)
    z32, r32, bias, dhf = (x.to(acc) for x in (zx, r_gates, b_gates, dh))
    adj = [z32.new_zeros((bsz, h, hd)) for _ in range(4)]   # dh, dc, dn, dm
    dz_all = z32.new_zeros((bsz, t, h, hd4))
    hprev = z32.new_zeros((bsz, t, h, hd))
    for tc in reversed(range(nt)):
        lo, hi = tc * chunk, min((tc + 1) * chunk, t)
        state = tuple(x[:bsz, tc].to(acc) for x in bounds)
        zs, entering = [], []
        for s in range(lo, hi):                    # pass 1: recompute
            entering.append(state)
            z = z32[:, s] + torch.einsum("bhk,hkg->bhg", state[0], r32) + bias
            zs.append(z)
            state = _slstm_step(z, *state[1:], hd)
        for s in reversed(range(lo, hi)):          # pass 2: adjoints
            z = zs[s - lo]
            h_prev, c_prev, n_prev, m_prev = entering[s - lo]
            zi, zf, zz, zo = z.split(hd, dim=-1)
            a = _logsigmoid(zf) + m_prev
            m = torch.maximum(a, zi)
            i_t, f_t = torch.exp(zi - m), torch.exp(a - m)
            tz = torch.tanh(zz)
            ct = f_t * c_prev + i_t * tz
            n_t = f_t * n_prev + i_t
            nd = torch.clamp(n_t, min=SLSTM_EPS)
            sig_o = torch.sigmoid(zo)
            hdn = ct / nd
            dh_t = adj[0] + dhf[:, s]
            dzo = dh_t * hdn * sig_o * (1.0 - sig_o)
            dct = dh_t * sig_o / nd + adj[1]
            dnt = adj[2] - torch.where(n_t >= SLSTM_EPS,
                                       dh_t * sig_o * hdn / nd, 0.0)
            df = dct * c_prev + dnt * n_prev
            di = dct * tz + dnt
            dzz = dct * i_t * (1.0 - tz * tz)
            dm = adj[3] - di * i_t - df * f_t
            sel = a >= zi                          # ties: the forget branch
            da = df * f_t + torch.where(sel, dm, 0.0)
            dzi = di * i_t + torch.where(sel, 0.0, dm)
            dzf = da * torch.sigmoid(-zf)
            dz = torch.cat([dzi, dzf, dzz, dzo], dim=-1)
            dz_all[:, s] = dz
            hprev[:, s] = h_prev
            adj = [torch.einsum("bhg,hkg->bhk", dz, r32), dct * f_t,
                   dnt * f_t, da]
    dr = torch.einsum("bthk,bthg->hkg", hprev, dz_all)
    db = dz_all.sum((0, 1))
    return dz_all.to(zx.dtype), dr.to(r_gates.dtype), db.to(b_gates.dtype)
