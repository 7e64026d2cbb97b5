"""The rounding of the tensor-core flash attention, modelled on the CPU.

The bf16 forward (K3) and backward (K4) in ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` run their products on the tensor cores: bf16 operands,
float32 accumulation.  Against the plain versions in
`repro_torch.kernels.ref` (which ``tests/test_torch_kernels.py`` holds to
the JAX Pallas kernels) they differ only where the design rounds to bf16
in registers:

* forward: P = exp(S - m) is rounded to bf16 before P V, with m the
  running row max of the kv tiles seen so far; the normaliser l sums the
  float32 p; S is scaled in float32;
* backward: P and dS = P (dP - delta) are rounded to bf16 before the
  three gradient products dQ = dS K, dK = dS^T Q, dV = P^T dO.

`tc_fwd_model` and `tc_bwd_model` compute exactly that, tile by tile as
the kernels do (64 keys a kv tile, 64 queries a q tile), in float32.  Each
test holds the model's float32 outputs to HALF of the bf16 tolerances
that ``chip_smoke.py`` holds the card to (`repro_torch.kernels.tolerance`)
against the plain version on the same inputs: the design's own rounding
uses at most half of each tolerance, and the other half is left
for the final rounding of the outputs to bf16 (at most 2^-9 relative, below
half of the relative tolerance 1e-2).  So the tolerances the card is held
to are met by design, not fitted to a chip run.  Each test also checks that
the model's rounding is visible (the error is not float32 noise), so the
comparison is not vacuous.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, tolerance

TOL = tolerance.TOL[torch.bfloat16]          # K3 output: atol, rtol
LSE_TOL = tolerance.LSE_TOL
BWD_TOL = tolerance.BWD_TOL[torch.bfloat16]  # K4 outputs, each to its scale

TILE = 64
NEG_INF = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _live(t0, t1, s0, s1, causal, window, s_len):
    """(t1 - t0, s1 - s0) bool: query t0 + i may read key s0 + j."""
    qpos = torch.arange(t0, t1)[:, None]
    kpos = torch.arange(s0, s1)[None, :]
    live = kpos < s_len
    if causal:
        live = live & (kpos <= qpos)
    if window > 0:
        live = live & (qpos - kpos < window)
    return live


def _logits(qf, kf, scale, softcap):
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    return softcap * torch.tanh(s / softcap) if softcap > 0 else s


def _expand(x, group):
    return x.float().repeat_interleave(group, dim=2)


def tc_fwd_model(q, k, v, *, causal, window, softcap):
    """K3 on the tensor cores: -> (o (B, T, H, hd), lse (B, H, T)), both
    float32 (o before its final rounding to bf16)."""
    b, t, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    qf, kf, vf = q.float(), _expand(k, h // hkv), _expand(v, h // hkv)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, h, t), NEG_INF)
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, hd)
    for s0 in range(0, s_len, TILE):
        s1 = min(s0 + TILE, s_len)
        s = _logits(qf, kf[:, s0:s1], scale, softcap)
        s = torch.where(_live(0, t, s0, s1, causal, window, s_len), s,
                        -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhts,bshd->bhtd", _bf16(p), vf[:, s0:s1])
        m = m_new
    o = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                    0.0)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    return o.permute(0, 2, 1, 3), lse


def tc_bwd_model(q, k, v, o, lse, do, *, causal, window, softcap):
    """K4 on the tensor cores: -> (dq, dk, dv) float32, dk / dv summed over
    the GQA group."""
    b, t, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qf, dof = q.float(), do.float()
    kf, vf = _expand(k, group), _expand(v, group)
    scale = 1.0 / math.sqrt(hd)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)         # (B, H, T)

    def tile(t0, t1, s0, s1):      # P and dS of one (q tile, kv tile), bf16
        s = _logits(qf[:, t0:t1], kf[:, s0:s1], scale, softcap)
        live = _live(t0, t1, s0, s1, causal, window, s_len)
        p = torch.where(live, torch.exp(s - lse[:, :, t0:t1, None]), 0.0)
        dp = torch.einsum("bthd,bshd->bhts", dof[:, t0:t1], vf[:, s0:s1])
        ds = p * (dp - delta[:, :, t0:t1, None])
        if softcap > 0:
            ds = ds * (1.0 - (s / softcap) ** 2)
        return _bf16(p), _bf16(ds)

    dq = torch.zeros(b, t, h, hd)
    dk = torch.zeros(b, s_len, h, hd)
    dv = torch.zeros(b, s_len, h, hd)
    for t0 in range(0, t, TILE):                 # the dq kernel's kv loop
        t1 = min(t0 + TILE, t)
        for s0 in range(0, s_len, TILE):
            s1 = min(s0 + TILE, s_len)
            _, ds = tile(t0, t1, s0, s1)
            dq[:, t0:t1] += torch.einsum("bhts,bshd->bthd", ds, kf[:, s0:s1])
    for s0 in range(0, s_len, TILE):             # the dk/dv kernel's q loop
        s1 = min(s0 + TILE, s_len)
        for t0 in range(0, t, TILE):
            t1 = min(t0 + TILE, t)
            p, ds = tile(t0, t1, s0, s1)
            dv[:, s0:s1] += torch.einsum("bhts,bthd->bshd", p, dof[:, t0:t1])
            dk[:, s0:s1] += torch.einsum("bhts,bthd->bshd", ds, qf[:, t0:t1])
    dk = (dk * scale).reshape(b, s_len, hkv, group, hd).sum(3)
    dv = dv.reshape(b, s_len, hkv, group, hd).sum(3)
    return dq * scale, dk, dv


def _inputs(seed, b, t, s, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .bfloat16() for shape in ((b, t, h, hd), (b, s, hkv, hd),
                                      (b, s, hkv, hd), (b, t, h, hd))]


CASES = [
    # (b, t, s, h, hkv, hd, causal, window, softcap)
    (1, 65, 65, 7, 1, 64, True, 0, 0.0),          # GQA 7, T % 64 == 1
    (1, 300, 300, 7, 1, 128, True, 100, 30.0),    # window, softcap, hd 128
    (2, 130, 200, 4, 2, 128, False, 0, 0.0),      # non-causal, T != S
    (1, 128, 128, 14, 2, 64, True, 0, 0.0),       # the sim path's heads
    (1, 128, 128, 4, 2, 128, True, 0, 30.0),      # the training heads, softcap
]


@pytest.mark.parametrize("b,t,s,h,hkv,hd,causal,window,softcap", CASES)
def test_tc_forward_rounding_within_half_the_tolerance(b, t, s, h, hkv, hd,
                                                       causal, window,
                                                       softcap):
    q, k, v, _ = _inputs(0, b, t, s, h, hkv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = tc_fwd_model(q, k, v, **kw)
    want_o, want_lse = ref.flash_attention_fwd_ref(q.float(), k.float(),
                                                   v.float(), **kw)
    err = (o - want_o).abs()
    bound = 0.5 * (TOL["atol"] + TOL["rtol"] * want_o.abs())
    assert (err <= bound).all(), (err / bound).max().item()
    assert err.max() > 1e-5        # the rounding of P is visible
    lse_bound = 0.5 * (LSE_TOL["atol"] + LSE_TOL["rtol"] * want_lse.abs())
    assert ((lse - want_lse).abs() <= lse_bound).all()
    # what the card is held to: both outputs rounded to bf16
    got16, want16 = _bf16(o), ref.flash_attention_fwd_ref(q, k, v, **kw)[0]
    torch.testing.assert_close(got16, want16.float(), **TOL)


@pytest.mark.parametrize("b,t,s,h,hkv,hd,causal,window,softcap", CASES)
def test_tc_backward_rounding_within_half_the_tolerance(b, t, s, h, hkv, hd,
                                                        causal, window,
                                                        softcap):
    q, k, v, do = _inputs(1, b, t, s, h, hkv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)     # bf16 o, as K3's
    got = tc_bwd_model(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o,
                                       lse, do.float(), **kw)
    for g, w in zip(got, want):
        scale = w.abs().max()
        err = (g - w).abs()
        bound = 0.5 * (BWD_TOL["atol_of_max"] * scale
                       + BWD_TOL["rtol"] * w.abs())
        assert (err <= bound).all(), (err / bound).max().item()
        rel = ((g - w).norm() / w.norm()).item()
        assert 1e-5 < rel <= 0.5 * BWD_TOL["rel_norm"], rel


def test_cpu_wrappers_count_no_tensor_core_launch():
    """bf16 CPU tensors run the plain versions: the tensor-core counters
    stay at 0, and `reset_launches` clears them."""
    q, k, v, do = _inputs(2, 1, 65, 65, 4, 2, 64)
    ops.flash_attention.tc_launches = ops.flash_attention_bwd.tc_launches = 7
    ops.reset_launches()
    o, lse = ops.flash_attention_fwd_res(q, k, v)
    ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert ops.flash_attention.tc_launches == 0
    assert ops.flash_attention_bwd.tc_launches == 0
    assert ops.flash_attention.launches == 0


def test_tma_alignment_is_checked():
    """A bf16 tensor the TMA maps cannot address (base not 16-byte
    aligned) is refused; float32 ones go to the CUDA-core kernels, which
    take any address."""
    base = torch.zeros(2 * 64 + 8, dtype=torch.bfloat16)
    fa._check_tma("k3", q=base[:128])
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa._check_tma("k3", q=base[1:129])
    fa._check_tma("k3", q=torch.zeros(130)[1:129])
