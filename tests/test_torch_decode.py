"""The port's paged flash-decode (K6) at any GQA group and head_dim 80,
the head_dim padding of K3 / K4, the backward's delta preprocess and the
split chooser, against the JAX package where it has a counterpart.

On the CPU the port's wrappers run their plain versions; they are held
here against the JAX Pallas kernels in interpret mode, as the JAX package's
own tests run them.  Inputs are made from a seed with numpy and fed to both.
Tolerance: float32 throughout, atol = rtol = 2e-5, the JAX package's own
kernel-vs-oracle bound (the two sides sum in another order).  The padding
helper is held to 1e-6: zero columns add exact zeros, only the products'
blocking may differ.

The CUDA kernels themselves are held against their plain versions in
`test_torch_cuda.py`.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=2e-5, rtol=2e-5)
PAD_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paged(seed, lengths, hkv, group, hd, bs, nmax):
    """Random pools and a shuffled block table."""
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


DECODE_CASES = [
    # (lengths, hkv, group, hd, bs, nmax, window, softcap, num_splits)
    ([41, 0, 17], 2, 16, 64, 8, 6, 0, 0.0, 0),        # group 16 (chatglm3)
    ([41, 0, 17], 2, 16, 64, 8, 6, 0, 0.0, 1),        # group 16, one split
    ([30, 9], 1, 32, 16, 8, 4, 0, 0.0, 0),            # group 32
    ([30, 9], 1, 32, 16, 8, 4, 12, 30.0, 1),          # group 32, window, cap
    ([50, 3, 0], 4, 1, 80, 16, 4, 0, 0.0, 0),         # head_dim 80 (stablelm)
    ([50, 3, 0], 4, 1, 80, 16, 4, 0, 0.0, 1),         # head_dim 80, one split
    ([70, 26], 2, 2, 80, 8, 9, 20, 30.0, 3),          # head_dim 80, window, cap
]


@pytest.mark.parametrize(
    "lengths,hkv,group,hd,bs,nmax,window,softcap,splits", DECODE_CASES)
def test_flash_decode_any_group_and_head_dim_80(lengths, hkv, group, hd, bs,
                                                nmax, window, softcap,
                                                splits):
    """flash_decode (plain version on CPU) against the JAX paged
    flash-decode kernel in interpret mode at groups above 8 and head_dim
    80; lanes of length 0 are exact zeros."""
    q, kp, vp, tables, lens = _paged(len(lengths) * group + hd, lengths, hkv,
                                     group, hd, bs, nmax)
    want = jfa.flash_decode_paged(
        *map(jnp.asarray, (q, kp, vp, tables, lens)), window=window,
        softcap=softcap, num_splits=splits, interpret=True)
    got = tops.flash_decode(*_t(q, kp, vp, tables, lens), window=window,
                            softcap=softcap, num_splits=splits)
    assert got.shape == (len(lengths), hkv * group, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[lens == 0] == 0).all()


@pytest.mark.parametrize("b,t,h,hd", [(2, 9, 3, 64), (1, 17, 4, 80),
                                      (2, 5, 2, 128)])
def test_delta_ref_matches_jax_wrapper_expression(b, t, h, hd):
    """`ref.flash_attention_delta_ref` against the reference wrapper's
    preprocess (`flash_attention_bwd`: the float32 row sum of do * o, the
    head axis moved before time)."""
    rng = np.random.default_rng(b * t + hd)
    o = rng.standard_normal((b, t, h, hd), np.float32)
    do = rng.standard_normal((b, t, h, hd), np.float32)
    want = jnp.moveaxis(jnp.sum(jnp.asarray(do) * jnp.asarray(o), axis=-1),
                        2, 1)
    got = tref.flash_attention_delta_ref(*_t(o, do))
    assert got.shape == (b, h, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hd,want", [(64, 64), (80, 128), (128, 128),
                                     (16, 64)])
def test_kernel_head_dim_rounds_up_to_64(hd, want):
    """As the reference's `_pad_head_dim`."""
    assert tfa.kernel_head_dim(hd) == want == jfa._pad_head_dim(hd)


@pytest.mark.parametrize("t,s,h,hkv,causal,window,softcap", [
    (33, 33, 4, 2, True, 0, 0.0), (20, 41, 2, 1, False, 0, 30.0),
    (40, 40, 4, 4, True, 9, 0.0)])
def test_padded_plain_equals_unpadded_plain(t, s, h, hkv, causal, window,
                                            softcap):
    """`pad_head_dim` at head_dim 80: the plain forward and backward on the
    padded inputs, with the unpadded softmax scale, sliced back to 80
    columns, equal them on the unpadded inputs; the padded columns of the
    outputs are exact zeros."""
    rng = np.random.default_rng(t + s)
    q, do = (torch.from_numpy(rng.standard_normal((2, t, h, 80), np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, s, hkv, 80), np.float32))
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    qp, kp, vp, dop = tfa.pad_head_dim(q, k, v, do)
    assert qp.shape[-1] == kp.shape[-1] == 128
    assert (qp[..., 80:] == 0).all() and torch.equal(qp[..., :80], q)
    scale = 1.0 / math.sqrt(80)
    o, lse = tref.flash_attention_fwd_ref(q, k, v, **kw)
    op, lsep = tref.flash_attention_fwd_ref(qp, kp, vp, scale=scale, **kw)
    assert (op[..., 80:] == 0).all()
    torch.testing.assert_close(op[..., :80], o, **PAD_TOL)
    torch.testing.assert_close(lsep, lse, **PAD_TOL)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = tref.flash_attention_bwd_ref(qp, kp, vp, op, lsep, dop,
                                       scale=scale, **kw)
    for g, w in zip(got, want):
        assert (g[..., 80:] == 0).all()
        torch.testing.assert_close(g[..., :80], w, **PAD_TOL)


def test_pad_head_dim_leaves_kernel_widths_alone():
    """At head_dim 64 and 128 the same tensors come back, not copies."""
    for hd in (64, 128):
        x = torch.zeros(1, 2, 3, hd)
        assert tfa.pad_head_dim(x)[0] is x


SPLIT_CASES = [
    # (batch, hkv, group, max_blocks, num_splits, cluster_max, want)
    (4, 8, 2, 34, 0, 16, 4),       # qwen3 serve, busiest tick
    (1, 8, 2, 256, 0, 16, 16),     # one 4,096-token qwen3 lane
    (4, 2, 16, 17, 0, 16, 16),     # chatglm3 serve, 4 lanes of <= 272
    (4, 32, 1, 20, 0, 16, 1),      # stablelm-3b serve
    (1, 4, 128, 64, 0, 16, 8),     # a group of 128: four row blocks a head
    (4, 4, 64, 64, 0, 16, 4),      # a group of 64: two row blocks a head
    (64, 8, 2, 34, 0, 16, 1),      # a large batch fills the card alone
    (1, 8, 2, 3, 0, 16, 3),        # at most a split per page
    (1, 8, 2, 256, 0, 8, 8),       # a card that schedules only 8
    (2, 2, 2, 40, 12, 16, 12),     # explicit, inside the limits
    (2, 2, 2, 40, 40, 16, 16),     # explicit, clamped to the cluster
    (2, 2, 2, 5, 12, 16, 5),       # explicit, clamped to the pages
    (2, 2, 2, 5, -3, 16, 5),       # <= 0: chosen
]


@pytest.mark.parametrize("batch,hkv,group,max_blocks,num_splits,cluster,want",
                         SPLIT_CASES)
def test_split_chooser(batch, hkv, group, max_blocks, num_splits, cluster,
                       want):
    """`choose_num_splits`: >= 1, <= max_blocks, <= the cluster limit, and
    about one wave of 132 SMs (a block each) where the shape allows."""
    got = tfa.choose_num_splits(batch, hkv, group, max_blocks, num_splits,
                                num_sms=132, cluster_max=cluster)
    assert got == want
    assert 1 <= got <= min(max_blocks, cluster)
    if num_splits <= 0 and 1 < got < min(max_blocks, cluster):
        lanes = batch * hkv * -(-group // 32)    # clusters of the launch
        assert lanes * got <= 132 < lanes * (got + 1)
