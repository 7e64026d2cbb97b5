"""The port's attention kernels against the JAX package's.

On the CPU the port's wrappers (`repro_torch.kernels.ops`) run their plain
PyTorch versions; they are held here against the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them, and against the
JAX plain oracles in `repro/kernels/ref.py`.  Inputs are made from a seed
with numpy and fed to both.

Tolerance: float32 throughout, atol = rtol = 2e-5 -- the JAX package's own
kernel-vs-oracle bound.  The two sides sum in another order, and the kernel
scales q before the dot where the oracle divides the logits after, so they
agree to rounding, not bit for bit.

The backward is held the same way: the port's plain recomputation backward
and autograd through `ops.flash_attention` against the JAX Pallas backward
(`flash_attention_bwd`, interpret mode) and `jax.grad` through the JAX
`ops.flash_attention` custom VJP, at the same 2e-5.

The CUDA kernels themselves are held against their plain versions in
`test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, t, s, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32))


def _paged(seed, lengths, hkv, group, hd, bs, nmax):
    """Random pools and a shuffled block table: every lane owns a distinct
    random set of physical blocks, so reading in pool order is wrong."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    nb = b * nmax + 3
    q = rng.standard_normal((b, hkv * group, hd), np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    tables = rng.permutation(nb)[:b * nmax].reshape(b, nmax).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


FWD_CASES = [
    # (b, t, s, h, hkv, hd, causal, window, softcap)
    (2, 40, 40, 4, 4, 16, True, 0, 0.0),        # GQA group 1, head_dim 16
    (1, 130, 130, 4, 2, 64, True, 0, 0.0),      # group 2, T not a multiple of 128
    (1, 70, 70, 14, 2, 16, True, 16, 0.0),      # group 7 (qwen2-0.5b), window
    (1, 50, 50, 2, 1, 128, True, 0, 30.0),      # softcap, head_dim 128
    (1, 33, 48, 4, 2, 64, False, 0, 0.0),       # non-causal, T != S
    (1, 40, 40, 4, 4, 80, True, 0, 0.0),        # head_dim 80 (stablelm-3b)
    (1, 24, 24, 32, 2, 16, True, 0, 0.0),       # group 16 (chatglm3-6b)
]


@pytest.mark.parametrize("b,t,s,h,hkv,hd,causal,window,softcap", FWD_CASES)
def test_flash_attention_matches_jax_kernel(b, t, s, h, hkv, hd, causal,
                                            window, softcap):
    """o and lse of the port's flash_attention (plain version on CPU)
    against the JAX Pallas forward kernel in interpret mode."""
    q, k, v = _qkv(b * t + hd, b, t, s, h, hkv, hd)
    want_o, want_lse = jfa.flash_attention_fwd_res(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=softcap, interpret=True)
    got_o, got_lse = tops.flash_attention_fwd_res(
        *_t(q, k, v), causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    assert got_o.dtype == torch.float32 and got_lse.shape == (b, h, t)


BWD_CASES = [
    # (b, t, s, h, hkv, hd, causal, window, softcap)
    (1, 40, 40, 4, 2, 64, True, 0, 0.0),        # GQA group 2, head_dim 64
    (1, 70, 70, 4, 1, 64, True, 16, 0.0),       # group 4, window
    (1, 50, 50, 2, 1, 128, True, 0, 30.0),      # softcap, head_dim 128
    (1, 33, 48, 4, 2, 128, False, 0, 0.0),      # non-causal, T != S
    (1, 40, 40, 2, 2, 80, True, 0, 30.0),       # head_dim 80, softcap
    (1, 24, 24, 16, 1, 16, True, 8, 0.0),       # group 16, window
]


def _bwd_inputs(b, t, s, h, hkv, hd):
    q, k, v = _qkv(7 * t + hd, b, t, s, h, hkv, hd)
    do = np.random.default_rng(t + s).standard_normal((b, t, h, hd),
                                                      np.float32)
    return q, k, v, do


@pytest.mark.parametrize("b,t,s,h,hkv,hd,causal,window,softcap", BWD_CASES)
def test_flash_attention_bwd_matches_jax_kernel(b, t, s, h, hkv, hd, causal,
                                                window, softcap):
    """dq, dk, dv of the port's flash_attention_bwd (plain version on CPU)
    against the JAX Pallas backward kernels in interpret mode, both from
    the JAX forward's (o, lse)."""
    q, k, v, do = _bwd_inputs(b, t, s, h, hkv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = jfa.flash_attention_fwd_res(*map(jnp.asarray, (q, k, v)),
                                         interpret=True, **kw)
    want = jfa.flash_attention_bwd(*map(jnp.asarray, (q, k, v)), o, lse,
                                   jnp.asarray(do), interpret=True, **kw)
    got = tops.flash_attention_bwd(*_t(q, k, v, np.asarray(o),
                                       np.asarray(lse), do), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("b,t,s,h,hkv,hd,causal,window,softcap", BWD_CASES)
def test_autograd_matches_jax_grad(b, t, s, h, hkv, hd, causal, window,
                                   softcap):
    """Gradients through the port's `ops.flash_attention` autograd Function
    against `jax.grad` through the JAX custom VJP (Pallas forward and
    backward in interpret mode) of sum(o * do)."""
    q, k, v, do = _bwd_inputs(b, t, s, h, hkv, hd)

    def jloss(q_, k_, v_):
        return jnp.sum(jops.flash_attention(q_, k_, v_, causal, window,
                                            softcap) * jnp.asarray(do))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    tops.reset_launches()
    out = tops.flash_attention(*leaves, causal=causal, window=window,
                               softcap=softcap)
    (out * torch.from_numpy(do)).sum().backward()
    assert tops.flash_attention_bwd.launches == 0       # CPU: plain versions
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL)


def test_fwd_res_refuses_to_record_gradients():
    """`flash_attention_fwd_res` is not differentiable (nor is the JAX one):
    on inputs that require grad it raises instead of returning an output
    that silently drops the attention gradient."""
    q, k, v = [x.requires_grad_() for x in _t(*_qkv(2, 1, 8, 8, 2, 1, 64))]
    with pytest.raises(ValueError, match="flash_attention to differentiate"):
        tops.flash_attention_fwd_res(q, k, v)
    with torch.no_grad():
        tops.flash_attention_fwd_res(q, k, v)


DECODE_CASES = [
    # (lengths, hkv, group, hd, bs, nmax, window, softcap, num_splits)
    ([41, 17, 0, 1], 2, 2, 64, 8, 6, 0, 0.0, 0),      # ragged incl. 0 and 1
    ([64, 3], 1, 7, 16, 16, 4, 0, 0.0, 1),            # group 7, one split
    ([120, 57, 9], 2, 1, 32, 8, 16, 20, 0.0, 3),      # window, 3 splits
    ([25, 31], 2, 2, 128, 8, 4, 0, 30.0, 0),          # softcap, head_dim 128
    ([80, 1, 0], 1, 4, 64, 32, 3, 7, 30.0, 3),        # window + softcap
]


@pytest.mark.parametrize(
    "lengths,hkv,group,hd,bs,nmax,window,softcap,splits", DECODE_CASES)
def test_flash_decode_matches_jax_kernel(lengths, hkv, group, hd, bs, nmax,
                                         window, softcap, splits):
    """The port's flash_decode (plain version on CPU) against the JAX
    paged flash-decode kernel in interpret mode; lanes of length 0 are
    exact zeros on both sides."""
    q, kp, vp, tables, lens = _paged(len(lengths) + hd, lengths, hkv, group,
                                     hd, bs, nmax)
    want = jfa.flash_decode_paged(
        *map(jnp.asarray, (q, kp, vp, tables, lens)), window=window,
        softcap=softcap, num_splits=splits, interpret=True)
    got = tops.flash_decode(*_t(q, kp, vp, tables, lens), window=window,
                            softcap=softcap, num_splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dead = lens == 0
    assert (got.numpy()[dead] == 0).all()


def test_plain_versions_match_jax_refs():
    """`repro_torch.kernels.ref` against `repro/kernels/ref.py` on a window
    and softcap case each."""
    q, k, v = _qkv(5, 2, 37, 37, 6, 3, 32)
    for window, softcap in ((0, 0.0), (9, 25.0)):
        want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=True, window=window,
                                        softcap=softcap)
        got = tref.flash_attention_ref(*_t(q, k, v), causal=True,
                                       window=window, softcap=softcap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    args = _paged(6, [30, 0, 5], 2, 3, 16, 4, 8)
    for window, softcap in ((0, 0.0), (6, 25.0)):
        want = jref.flash_decode_ref(*map(jnp.asarray, args), window=window,
                                     softcap=softcap)
        got = tref.flash_decode_ref(*_t(*args), window=window,
                                    softcap=softcap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    tops.reset_launches()
    tops.flash_attention(*_t(*_qkv(1, 1, 8, 8, 2, 1, 16)))
    tops.flash_decode(*_t(*_paged(1, [5], 1, 2, 16, 4, 2)))
    q, k, v = _t(*_qkv(1, 1, 8, 8, 2, 1, 16))
    o, lse = tops.flash_attention_fwd_res(q, k, v)
    tops.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(q))
    assert tops.flash_attention.launches == 0 == tops.flash_decode.launches
    assert tops.flash_attention_bwd.launches == 0


def test_cuda_launch_rejects_cpu_tensors():
    """The CUDA launches never take a CPU tensor (no silent fallback)."""
    q, k, v = _t(*_qkv(1, 1, 8, 8, 2, 1, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_fwd_res(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_decode_paged(*_t(*_paged(1, [5], 1, 2, 64, 4, 2)))
    o, lse = tops.flash_attention_fwd_res(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(q))


def test_num_splits_semantics():
    """K6's split count: ``num_splits <= 0`` fills about one wave (a block
    on each of 132 SMs); any count is clamped to [1, min(max_blocks,
    cluster limit)]."""
    assert tfa.choose_num_splits(4, 8, 2, 34) == 4      # busiest serve tick
    assert tfa.choose_num_splits(1, 8, 2, 256) == 16    # one long lane
    assert tfa.choose_num_splits(4, 8, 2, 3) == 3       # a page a split at least
    assert tfa.choose_num_splits(4, 8, 2, 34, 99) == 16
    assert tfa.choose_num_splits(4, 8, 2, 5, 99) == 5
    assert tfa.choose_num_splits(1, 8, 2, 256, cluster_max=8) == 8
    assert tfa.choose_num_splits(1, 1, 1, 1, -1) == 1
