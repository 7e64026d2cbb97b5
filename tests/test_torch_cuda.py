"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here is marked ``cuda`` and skips (visibly) where
`torch.cuda.is_available()` is False, as on a CPU-only test machine.  The
file imports no JAX, so it also runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: both sides compute in float32 from the same inputs, so float32
outputs differ by summation order only (atol 1e-4); bf16 outputs may round
to neighbouring bf16 values (one bf16 ulp is 2^-7 relative; atol 2e-2 for
|o| <= 2).  lse is float32 on both sides (atol 1e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


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


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips (visibly) where there is none.  The
    check runs here, at test time, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


GPU_FWD_CASES = [
    # (h, hkv, hd, window, softcap, dtype)
    (16, 8, 128, 0, 0.0, torch.bfloat16),
    (14, 2, 64, 64, 0.0, torch.float32),
    (4, 4, 64, 0, 30.0, torch.bfloat16),
]


def _gpu_tol(dtype):
    return dict(atol=2e-2, rtol=0) if dtype == torch.bfloat16 else \
        dict(atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,hd,window,softcap,dtype", GPU_FWD_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, h, hkv, hd, window,
                                            softcap, dtype):
    g = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn(2, 200, h, hd, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, 200, hkv, hd, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, 200, hkv, hd, generator=g, device=cuda_device).to(dtype)
    before = ops.flash_attention.launches
    o, lse = ops.flash_attention_fwd_res(q, k, v, window=window,
                                         softcap=softcap)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, window=window,
                                                   softcap=softcap)
    torch.testing.assert_close(o.float(), want_o.float(), **_gpu_tol(dtype))
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("group,hd,bs,window,softcap,dtype", [
    (2, 128, 8, 0, 0.0, torch.bfloat16), (7, 64, 32, 40, 0.0, torch.float32),
    (8, 64, 16, 0, 30.0, torch.bfloat16), (1, 128, 16, 0, 0.0, torch.float32)])
def test_cuda_flash_decode_matches_plain(cuda_device, group, hd, bs, window,
                                         softcap, dtype):
    args = _paged(3, [0, 1, 17, 300], 2, group, hd, bs, -(-301 // bs))
    q, kp, vp, tables, lens = [torch.from_numpy(a).to(cuda_device)
                               for a in args]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = ops.flash_decode.launches
    out = ops.flash_decode(q, kp, vp, tables, lens, window=window,
                           softcap=softcap)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want = ref.flash_decode_ref(q, kp, vp, tables, lens, window=window,
                                softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), **_gpu_tol(dtype))
    assert (out[0] == 0).all()


GPU_BWD_CASES = [
    # (t, s, h, hkv, hd, causal, window, softcap, dtype)
    (128, 128, 16, 8, 128, True, 0, 0.0, torch.bfloat16),   # training path
    (200, 200, 14, 2, 64, True, 64, 0.0, torch.float32),    # group 7, window
    (130, 130, 4, 4, 64, True, 0, 30.0, torch.bfloat16),    # softcap, T % 64
    (77, 150, 4, 2, 128, False, 0, 0.0, torch.float32),     # non-causal, T != S
]


def _bwd_inputs(device, t, s, h, hkv, hd, dtype, seed=1):
    g = torch.Generator(device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)
    return rnd(2, t, h, hd), rnd(2, s, hkv, hd), rnd(2, s, hkv, hd), \
        rnd(2, t, h, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,h,hkv,hd,causal,window,softcap,dtype",
                         GPU_BWD_CASES)
def test_cuda_flash_attention_bwd_matches_plain(cuda_device, t, s, h, hkv,
                                                hd, causal, window, softcap,
                                                dtype):
    """K4 against its plain version on the forward's own (o, lse); two runs
    give the same bits (no atomics)."""
    q, k, v, do = _bwd_inputs(cuda_device, t, s, h, hkv, hd, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = ops.flash_attention_fwd_res(q, k, v, **kw)
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    tol = dict(atol=2e-2, rtol=1e-2) if dtype == torch.bfloat16 else \
        dict(atol=1e-4, rtol=1e-4)
    for a, b, w in zip(got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), **tol)


@pytest.mark.cuda
def test_cuda_autograd_runs_k3_then_k4(cuda_device):
    """`ops.flash_attention` under autograd: one forward launch, one
    backward launch, gradients equal to autograd through the plain forward
    within float32 rounding."""
    q, k, v, do = _bwd_inputs(cuda_device, 96, 96, 8, 4, 64, torch.float32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    ops.flash_attention(*leaves, window=40).backward(do)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == fwd + 1
    assert ops.flash_attention_bwd.launches == bwd + 1
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.flash_attention_ref(*plain, window=40).backward(do)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_harness_slot_trains_through_k3_and_k4(cuda_device):
    """One plan slot of the trainer at the smoke config (float32) on the
    card: one K3 and one K4 launch per layer and worker, and the slot's
    fleet equals the ``impl="plain"`` slot's within float32 rounding."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import protocol
    from repro_torch.core.mllsgd import MLLConfig, build_network, build_state
    from repro_torch.core.simulator import replicate
    from repro_torch.models import model as model_mod
    from repro_torch.train.train_step import mll_harness_step
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              param_dtype="float32", compute_dtype="float32")
    mll = MLLConfig(tau=1, q=1, hub_topology="ring", mixing="two_stage")
    net = build_network(mll, 2, 2)
    st = build_state(mll, net, device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(0)
    params = model_mod.init_model(g, cfg, device=cuda_device)
    tokens = torch.randint(1, cfg.vocab_size, (4, 2, 33), generator=g,
                           device=cuda_device)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
    out = {}
    for impl in ("flash", "plain"):
        state = protocol.init_train_state(replicate(params, 4), cfg=mll)
        ops.reset_launches()
        state, m = mll_harness_step(state, batch, np.ones(4, np.float32),
                                    cfg, mll, st, phase=protocol.PHASE_HUB,
                                    impl=impl)
        torch.cuda.synchronize()
        n = cfg.num_layers * 4 if impl == "flash" else 0
        assert ops.flash_attention.launches == n
        assert ops.flash_attention_bwd.launches == n
        assert torch.isfinite(m["loss"]).all()
        out[impl] = tree_leaves(state.params)
    for a, b in zip(out["flash"], out["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
