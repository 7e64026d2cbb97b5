"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here is marked ``cuda`` and skips (visibly) where
`torch.cuda.is_available()` is False, as on a CPU-only test machine.  The
file imports no JAX, so it also runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: both sides compute in float32 from the same inputs, so float32
outputs differ by summation order only (atol 1e-4); bf16 outputs may round
to neighbouring bf16 values (one bf16 ulp is 2^-7 relative; atol 2e-2 for
|o| <= 2).  lse is float32 on both sides (atol 1e-3).  The fused update +
mix kernel (``csrc/hier_mix.cu``) and its plain version share one
arithmetic (separately rounded products and sums in one order), so they
are held equal bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels import ops, ref
from repro_torch.kernels import slstm_scan as ss
from repro_torch.kernels.profiling import graph_nodes


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
    # (t, s, h, hkv, hd, causal, window, softcap, dtype); bf16 runs on the
    # tensor cores, float32 on the CUDA cores
    (200, 200, 16, 8, 128, True, 0, 0.0, torch.bfloat16),
    (200, 200, 14, 2, 64, True, 64, 0.0, torch.float32),
    (200, 200, 4, 4, 64, True, 0, 30.0, torch.bfloat16),
    (1, 1, 16, 8, 128, True, 0, 0.0, torch.bfloat16),        # T = 1
    (1, 77, 14, 2, 64, False, 0, 0.0, torch.bfloat16),       # T = 1 < S
    (63, 63, 8, 8, 64, True, 0, 0.0, torch.bfloat16),        # group 1
    (65, 65, 14, 2, 64, True, 0, 30.0, torch.bfloat16),      # group 7
    (65, 200, 16, 8, 128, False, 0, 0.0, torch.bfloat16),    # T < S
    (200, 65, 4, 2, 128, True, 0, 0.0, torch.bfloat16),      # T > S
    (300, 300, 14, 2, 64, True, 100, 0.0, torch.bfloat16),   # window
    (300, 300, 32, 8, 128, True, 0, 0.0, torch.bfloat16),    # many blocks
    (300, 300, 28, 4, 64, True, 100, 30.0, torch.bfloat16),  # group 7
    (200, 20, 4, 2, 64, True, 30, 0.0, torch.bfloat16),      # dead rows
    (200, 20, 4, 2, 64, True, 30, 0.0, torch.float32),       # dead rows
    (200, 200, 32, 32, 80, True, 0, 0.0, torch.bfloat16),    # hd 80, padded
    (130, 130, 4, 2, 80, True, 40, 30.0, torch.float32),     # hd 80, float32
    (1, 77, 8, 4, 80, False, 0, 0.0, torch.bfloat16),        # hd 80, T = 1
    (200, 200, 32, 2, 128, True, 0, 0.0, torch.bfloat16),    # group 16
]


def _gpu_tol(dtype):
    return dict(atol=2e-2, rtol=0) if dtype == torch.bfloat16 else \
        dict(atol=1e-4, rtol=0)


def _dead_rows(t, s, causal, window):
    """(T,) bool: queries with no live key."""
    qpos = np.arange(t)[:, None]
    kpos = np.arange(s)[None, :]
    live = np.ones((t, s), bool)
    if causal:
        live &= kpos <= qpos
    if window > 0:
        live &= qpos - kpos < window
    return torch.from_numpy(~live.any(1))


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,h,hkv,hd,causal,window,softcap,dtype",
                         GPU_FWD_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, t, s, h, hkv, hd,
                                            causal, window, softcap, dtype):
    """K3 against its plain version; a query with no live key gives o = 0
    and lse = -1e30 exactly."""
    g = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn(2, t, h, hd, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, s, hkv, hd, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, s, hkv, hd, generator=g, device=cuda_device).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.flash_attention.launches
    o, lse = ops.flash_attention_fwd_res(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(o.float(), want_o.float(), **_gpu_tol(dtype))
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    dead = _dead_rows(t, s, causal, window).to(cuda_device)
    assert (o[:, dead] == 0).all()
    assert (lse[:, :, dead] == -1e30).all()


def _decode_inputs(device, group, hd, bs, dtype, lengths=(0, 1, 17, 300),
                   hkv=2):
    args = _paged(3, list(lengths), hkv, group, hd, bs,
                  -(-(max(lengths) + 1) // bs))
    q, kp, vp, tables, lens = [torch.from_numpy(a).to(device) for a in args]
    return q.to(dtype), kp.to(dtype), vp.to(dtype), tables, lens


@pytest.mark.cuda
@pytest.mark.parametrize("group,hd,bs,window,softcap,dtype", [
    (2, 128, 8, 0, 0.0, torch.bfloat16), (7, 64, 32, 40, 0.0, torch.float32),
    (8, 64, 16, 0, 30.0, torch.bfloat16), (1, 128, 16, 0, 0.0, torch.float32),
    (16, 128, 16, 0, 0.0, torch.bfloat16), (16, 128, 16, 0, 0.0, torch.float32),
    (32, 64, 16, 50, 0.0, torch.bfloat16), (32, 128, 8, 0, 30.0, torch.float32),
    (1, 80, 16, 0, 0.0, torch.bfloat16), (4, 80, 16, 30, 30.0, torch.float32),
    (80, 64, 16, 0, 0.0, torch.bfloat16), (130, 80, 8, 0, 0.0, torch.bfloat16)])
def test_cuda_flash_decode_matches_plain(cuda_device, group, hd, bs, window,
                                         softcap, dtype):
    """K6 against its plain version at any group (above 32 a head takes
    several row blocks) and head_dim 64, 80 and 128: one launch per call,
    exact zeros for a lane of length 0."""
    q, kp, vp, tables, lens = _decode_inputs(cuda_device, group, hd, bs,
                                             dtype)
    before = ops.flash_decode.launches
    out = ops.flash_decode(q, kp, vp, tables, lens, window=window,
                           softcap=softcap)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want = ref.flash_decode_ref(q, kp, vp, tables, lens, window=window,
                                softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), **_gpu_tol(dtype))
    assert (out[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("group,hd,dtype", [
    (16, 128, torch.bfloat16), (32, 128, torch.bfloat16),
    (2, 80, torch.bfloat16), (16, 80, torch.float32)])
@pytest.mark.parametrize("num_splits", [1, 16, 0])
def test_cuda_flash_decode_splits_one_launch_same_bits(cuda_device, group, hd,
                                                       dtype, num_splits):
    """K6 with one split, 16 and the chosen count: within tolerance of the
    plain version (counts differ by rounding only), one device kernel per
    call and no other (no partial buffers, no combine kernel), and the same
    bits on two runs."""
    from repro_torch.kernels import flash_attention as fa
    q, kp, vp, tables, lens = _decode_inputs(
        cuda_device, group, hd, 16, dtype, lengths=(0, 5, 700, 4096))
    splits = fa.decode_splits(q, kp, tables, num_splits)
    assert 1 <= splits <= 16

    def call():
        return ops.flash_decode(q, kp, vp, tables, lens,
                                num_splits=num_splits)
    assert graph_nodes(call) == ["kernel"]
    first, again = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    want = ref.flash_decode_ref(q, kp, vp, tables, lens)
    torch.testing.assert_close(first.float(), want.float(), **_gpu_tol(dtype))
    assert (first[0] == 0).all()


@pytest.mark.cuda
def test_cuda_serve_engine_group_16(cuda_device):
    """`ServeEngine(impl="flash")` at a GQA group of 16 (the chatglm3 smoke
    config with 16 heads over one kv head) serves every request, through
    K6 on every decode tick."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import (EngineConfig, ServeEngine,
                                          poisson_arrivals)

    cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"), n_heads=16,
                              n_kv_heads=1)
    params = model_mod.init_model(torch.Generator(cuda_device).manual_seed(0),
                                  cfg, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 19, 33)]
    eng = ServeEngine(params, cfg, EngineConfig(
        max_batch=2, block_size=8, max_len=48, num_blocks=16, impl="flash"),
        device=cuda_device)
    ops.reset_launches()
    out = eng.run(poisson_arrivals(prompts, max_new=6, seed=0))
    assert len(out["outputs"]) == 3 and out["generated"] == 18
    assert ops.flash_decode.launches > 0
    assert ops.flash_decode.launches % cfg.num_layers == 0


GPU_BWD_CASES = [
    # (t, s, h, hkv, hd, causal, window, softcap, dtype)
    (128, 128, 16, 8, 128, True, 0, 0.0, torch.bfloat16),   # training path
    (200, 200, 14, 2, 64, True, 64, 0.0, torch.float32),    # group 7, window
    (130, 130, 4, 4, 64, True, 0, 30.0, torch.bfloat16),    # softcap, T % 64
    (77, 150, 4, 2, 128, False, 0, 0.0, torch.float32),     # non-causal, T != S
    (128, 128, 14, 2, 64, True, 0, 0.0, torch.bfloat16),    # sim path
    (1, 1, 16, 8, 128, True, 0, 0.0, torch.bfloat16),       # T = 1
    (63, 63, 8, 8, 64, True, 0, 0.0, torch.bfloat16),       # group 1
    (65, 65, 14, 2, 64, True, 0, 30.0, torch.bfloat16),     # group 7, softcap
    (300, 300, 14, 2, 64, True, 100, 0.0, torch.bfloat16),  # window
    (300, 300, 16, 16, 128, True, 0, 0.0, torch.bfloat16),  # group 1, hd 128
    (77, 150, 4, 2, 128, False, 0, 0.0, torch.bfloat16),    # T < S
    (150, 77, 8, 4, 64, True, 0, 0.0, torch.bfloat16),      # T > S
    (200, 20, 4, 2, 64, True, 30, 0.0, torch.bfloat16),     # dead rows
    (128, 128, 32, 32, 80, True, 0, 0.0, torch.bfloat16),   # hd 80, padded
    (77, 150, 4, 2, 80, False, 0, 30.0, torch.float32),     # hd 80, float32
    (256, 256, 32, 2, 128, True, 0, 0.0, torch.bfloat16),   # group 16
    (130, 130, 16, 1, 64, True, 50, 0.0, torch.float32),    # group 16
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
def test_cuda_flash_attention_bwd_bf16_same_bits(cuda_device):
    """bf16 K4 at the training path's shape gives the same bits on every
    run, with other launches in between (no atomics, fixed-order sums)."""
    q, k, v, do = _bwd_inputs(cuda_device, 128, 128, 16, 8, 128,
                              torch.bfloat16)
    o, lse = ops.flash_attention_fwd_res(q, k, v)
    first = ops.flash_attention_bwd(q, k, v, o, lse, do)
    for t in (64, 300):
        q2, k2, v2, do2 = _bwd_inputs(cuda_device, t, t, 14, 2, 64,
                                      torch.bfloat16, seed=t)
        ops.flash_attention_bwd(q2, k2, v2,
                                *ops.flash_attention_fwd_res(q2, k2, v2), do2)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,hd,dtype", [
    (128, 16, 128, torch.bfloat16), (77, 14, 64, torch.bfloat16),
    (65, 4, 128, torch.float32), (130, 32, 80, torch.bfloat16),
    (33, 3, 80, torch.float32)])
def test_cuda_delta_kernel_matches_plain(cuda_device, t, h, hd, dtype):
    """K4's delta preprocess, launched alone, against
    `ref.flash_attention_delta_ref`: float32 sums of hd products in another
    order, and the same bits on two runs."""
    from repro_torch.kernels import flash_attention as fa
    _, _, _, do = _bwd_inputs(cuda_device, t, t, h, h, hd, dtype)
    o = _bwd_inputs(cuda_device, t, t, h, h, hd, dtype, seed=2)[0]
    got = fa.flash_attention_delta(o, do)
    again = fa.flash_attention_delta(o, do)
    torch.cuda.synchronize()
    assert got.shape == (2, h, t) and got.dtype == torch.float32
    assert torch.equal(got, again)
    want = ref.flash_attention_delta_ref(o, do)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


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


@pytest.mark.cuda
def test_cuda_mesh_two_gloo_ranks_equal_one_process(cuda_device):
    """Two gloo ranks sharing the card (mesh (2, 1), two workers each,
    qwen3-1.7b's smoke config in bf16, two_stage, 4 slots through K3 / K4)
    equal one process on the card bit for bit: params, u_k and u_k's
    loss."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.mllsgd import MLLConfig
    from repro_torch.launch import mesh, train
    from repro_torch.tree import tree_leaves

    cfg = get_smoke_config("qwen3-1.7b")
    mll = MLLConfig(tau=1, q=2, eta=0.05, hub_topology="ring",
                    mixing="two_stage", worker_rates=(1.0, 0.8, 1.0, 0.6))

    def loop(shape):
        return train.TrainLoopConfig(steps=4, eval_every=4, seq_len=64,
                                     batch_per_worker=2,
                                     tokens_per_worker=4096, impl="flash",
                                     mesh=shape)
    want = train.run_training(cfg, mll, loop(None), log=lambda *a: None)
    torch.cuda.empty_cache()
    ranks = mesh.spawn(train.train_rank, 2, cfg,
                       [dict(mll=mll, loop=loop((2, 1)))], backend="gloo",
                       device="cuda", timeout=300)
    for r in ranks:
        run = r[0]
        lo, hi = run["rows"]
        for a, b in zip(tree_leaves(run["state"].params),
                        tree_leaves(want["train_state"].params), strict=True):
            assert torch.equal(a, b[lo:hi].cpu())
        assert run["history"]["avg_loss"] == want["history"]["avg_loss"]
        assert run["launches"]["flash_attention_bwd"] == \
            cfg.num_layers * (hi - lo) * 4
    for a, b in zip(tree_leaves(ranks[0][0]["u"]),
                    tree_leaves(want["avg_params"]), strict=True):
        assert torch.equal(a, b.cpu())


# ------------------------------------------------------ fused update + mix
def _mix_inputs(device, w, c, dtype, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(w, c, generator=g, device=device).to(dtype)
    gr = torch.randn(w, c, generator=g, device=device).to(dtype)
    t = torch.rand(w, w, generator=g, device=device)
    t = t / t.sum(0, keepdim=True)
    theta = (torch.rand(w, generator=g, device=device) > 0.3).float()
    return x, gr, t, theta


def _grouped_op(w, d, hub, device):
    from repro_torch.core.hierarchy import MultiLevelNetwork
    from repro_torch.kernels.hier_mix import make_grouped_operator
    net = MultiLevelNetwork.build("ring", [w // d] * d)
    return make_grouped_operator(net.subnet_of, net.v,
                                 net.hub_net.h if hub else None,
                                 device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("w,c,dtype", [
    (3, 1, torch.float32), (4, 301, torch.float32), (13, 4101, torch.float32),
    (100, 257, torch.float32), (4, 301, torch.bfloat16),
    (8, 5000, torch.bfloat16)])
def test_cuda_hier_mix_dense_equals_plain_bit_for_bit(cuda_device, w, c,
                                                      dtype):
    x, g, t, theta = _mix_inputs(cuda_device, w, c, dtype)
    before = ops.hier_mix.launches
    got = ops.hier_mix(x, g, t, theta, 0.05)
    torch.cuda.synchronize()
    assert ops.hier_mix.launches == before + 1
    want = ref.hier_mix_ref(x, g, t, theta, 0.05)
    assert got.dtype == dtype and got.shape == (w, c)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("w,d,hub", [(4, 2, False), (4, 2, True),
                                     (8, 4, True), (100, 10, True)])
def test_cuda_hier_mix_grouped_equals_plain_bit_for_bit(cuda_device, w, d,
                                                        hub):
    x, g, _, theta = _mix_inputs(cuda_device, w, 1031, torch.float32, 1)
    op = _grouped_op(w, d, hub, cuda_device)
    before = ops.hier_mix.grouped_launches
    got = ops.hier_mix(x, g, op, theta, 0.1)
    torch.cuda.synchronize()
    assert ops.hier_mix.grouped_launches == before + 1
    want = ref.hier_mix_grouped_ref(x, g, op.scatter, op.broadcast, op.hub,
                                    theta, 0.1)
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
def test_cuda_packed_per_leaf_and_chunked_agree_bit_for_bit(cuda_device,
                                                            grouped):
    """packed (K1b / K2) = per leaf (K1a) for a dense operator, chunked
    (K5) = one launch, and the launch counters count each launch."""
    g = torch.Generator(cuda_device).manual_seed(2)

    def tree():
        return {"a": torch.randn(8, 37, 11, generator=g, device=cuda_device),
                "b": torch.randn(8, generator=g, device=cuda_device),
                "h": torch.randn(8, 300, generator=g,
                                 device=cuda_device).to(torch.bfloat16)}
    params, grads = tree(), tree()
    theta = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1.0], device=cuda_device)
    op = (_grouped_op(8, 2, True, cuda_device) if grouped else
          _mix_inputs(cuda_device, 8, 1, torch.float32)[2])
    ops.reset_launches()
    packed = ops.hier_mix_packed(params, grads, op, theta, 0.1)
    chunked = ops.hier_mix_packed_chunked(params, grads, op, theta, 0.1,
                                          num_chunks=3)
    torch.cuda.synchronize()
    n_chunks = len(packing.chunk_views(packing.pack_spec(params), 3))
    assert ops.hier_mix_packed.launches == 1
    assert ops.hier_mix_packed_chunked.launches == n_chunks == 3
    assert ops.hier_mix_packed.grouped_launches == int(grouped)
    for k in params:
        assert packed[k].dtype == params[k].dtype
        assert torch.equal(packed[k], chunked[k])
    cpu = ops.hier_mix_packed({k: v.cpu() for k, v in params.items()},
                              {k: v.cpu() for k, v in grads.items()},
                              op if not grouped else _grouped_op(8, 2, True,
                                                                 "cpu"),
                              theta.cpu(), 0.1)
    for k in params:
        torch.testing.assert_close(packed[k].cpu(), cpu[k], atol=1e-6,
                                   rtol=1e-6)
    if not grouped:
        perleaf = ops.hier_mix_pytree(params, grads, op, theta, 0.1)
        torch.cuda.synchronize()
        assert ops.hier_mix_pytree.launches == 3
        for k in params:
            assert torch.equal(packed[k], perleaf[k])


@pytest.mark.cuda
def test_cuda_timeline_runs_the_kernels(cuda_device):
    """A deadline run with two_stage mixing on the card: one K2 launch per
    event of the plan, the same u as on the CPU within float32 rounding
    (atol 1e-5), and chunked = one launch bit for bit."""
    from repro_torch.core import baselines, timeline
    from repro_torch.core.hierarchy import MLLSchedule
    from repro_torch.core.simulator import SimConfig
    from repro_torch.data.pipeline import make_classification

    data = make_classification(4, 64, dim=8, num_classes=3, test_size=64)

    def loss_fn(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        gold = torch.gather(logits, 1, b["y"].long()[:, None])[:, 0]
        return (torch.logsumexp(logits, -1) - gold).mean()

    net, _ = baselines.mll_sgd("ring", [2, 2], tau=2, q=2,
                               worker_rates=[1.0, 0.8, 1.0, 0.6])
    init = {"w": torch.zeros(8, 3), "b": torch.zeros(3)}
    out = {}
    for device, overlap in (("cpu", "none"), (cuda_device, "none"),
                            (cuda_device, "chunked")):
        ops.reset_launches()
        out[(str(device), overlap)] = res = timeline.run_timeline(
            loss_fn, loss_fn, init, data.worker_data(), data.full, data.test,
            net, MLLSchedule(2, 2), slots=12, policy="deadline",
            cfg=SimConfig(eta=0.1, batch_size=8, kernel="pallas",
                          mixing="two_stage", overlap=overlap,
                          overlap_chunks=2), seed=0, device=device)
        events = int((res.plan.op_ids != 0).sum())
        used = (ops.hier_mix_packed if overlap == "none"
                else ops.hier_mix_packed_chunked)
        assert used.grouped_launches == (events if device != "cpu" else 0)
    cpu, gpu, chunked = out.values()
    for k in ("w", "b"):
        torch.testing.assert_close(gpu.final_avg_params[k].cpu(),
                                   cpu.final_avg_params[k], atol=1e-5,
                                   rtol=0)
        assert torch.equal(gpu.final_avg_params[k],
                           chunked.final_avg_params[k])


# -------------------------------------------------------------- sLSTM scan
def _slstm_inputs(device, b, t, h, hd, dtype, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    zx = torch.randn(b, t, h, 4 * hd, generator=g, device=device).to(dtype)
    r = torch.randn(h, hd, 4 * hd, generator=g, device=device) / hd ** 0.5
    bias = 0.1 * torch.randn(h, 4 * hd, generator=g, device=device)
    dh = torch.randn(b, t, h, hd, generator=g, device=device).to(dtype)
    return zx, r, bias, dh


def _scaled_close(got, want, tol):
    """Every element within tol * max|want| + tol * |want|."""
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hd,bb,chunk,dtype", [
    (4, 512, 4, 384, 8, 128, torch.float32),   # xlstm-125m's training shape
    (3, 200, 2, 32, 2, 64, torch.float32),     # ragged B and T
    (2, 21, 1, 16, 8, 32, torch.float32),      # T < chunk, H 1
    (5, 100, 4, 128, 8, 128, torch.bfloat16),  # 8 compiled rows, bf16 zx
    (8, 128, 2, 384, 8, 64, torch.float32),    # hd 384 at 8 rows
    (4, 96, 2, 512, 4, 32, torch.float32),     # hd 512: R partly resident
    (8, 64, 1, 512, 8, 32, torch.float32),     # the same at 8 rows
    (4, 256, 4, 128, 4, 64, torch.float32),    # hd 128 (xlstm smoke)
    (3, 100, 2, 20, 4, 32, torch.float32),     # ragged hd, a padded row
    (5, 120, 2, 200, 8, 64, torch.float32),    # ragged hd at 8 rows
    (4, 200, 4, 384, 4, 64, torch.bfloat16),   # bf16 at the training width
    (1, 64, 1, 90, 8, 32, torch.float32),      # 1 row, hd NR not 4-aligned
    (2, 50, 1, 45, 2, 16, torch.float32),      # odd hd at 2 rows
    (1, 40, 2, 45, 8, 16, torch.bfloat16),     # odd hd at 1 row, bf16
])
def test_cuda_slstm_scan_matches_plain(cuda_device, b, t, h, hd, bb, chunk,
                                       dtype):
    """K7 (h and the four chunk-entering states) and K8 (dzx, dR, db from
    K7's states) against their plain versions, each output to its own
    scale: 1e-4 in float32 (summation order, math-library ulps through up
    to 512 steps), 1e-2 for a bf16 output (one rounding); K8 twice gives
    the same bits."""
    zx, r, bias, dh = _slstm_inputs(cuda_device, b, t, h, hd, dtype)
    kw = dict(block_b=bb, chunk=chunk)
    fwd, bwd = ops.slstm_scan.launches, ops.slstm_scan_bwd.launches
    h_out, bounds = ops.slstm_scan_fwd_res(zx, r, bias, **kw)
    got = ops.slstm_scan_bwd(zx, r, bias, bounds, dh, **kw)
    again = ops.slstm_scan_bwd(zx, r, bias, bounds, dh, **kw)
    torch.cuda.synchronize()
    assert ops.slstm_scan.launches == fwd + 1
    assert ops.slstm_scan_bwd.launches == bwd + 2
    low = 1e-2 if dtype == torch.bfloat16 else 1e-4
    want_h, want_bounds = ref.slstm_scan_fwd_res_ref(zx, r, bias, **kw)
    _scaled_close(h_out, want_h, low)
    for g, w in zip(bounds, want_bounds):
        torch.testing.assert_close(g, w, atol=1e-4 * max(
            1.0, w.abs().max().item()), rtol=1e-4)
    want = ref.slstm_scan_bwd_ref(zx, r, bias, bounds, dh, **kw)
    for a, c, w, tol in zip(got, again, want, (low, 1e-4, 1e-4)):
        assert torch.equal(a, c)
        assert a.dtype == w.dtype and a.shape == w.shape
        _scaled_close(a, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cuda_slstm_scan_every_cluster_size(cuda_device, cluster):
    """K7 and K8 forced to each cluster size at hd 128 (128 down to 8 units
    a block; at 1 block the R slice is only partly resident): each within
    the plain version's tolerance, K8 the same bits twice."""
    zx, r, bias, dh = _slstm_inputs(cuda_device, 4, 96, 2, 128,
                                    torch.float32, seed=3)
    plans = [ss.cluster_plan(zx.device, 128, 4, zx.dtype, bwd, cluster)
             for bwd in (False, True)]
    assert all(p["clusters_at_once"] > 0 for p in plans)
    assert (plans[0]["resident_rows"] < 128) == (cluster == 1)
    h_out, bounds = ss._fwd(zx, r, bias, 4, 32, True, cluster)
    got = ss._bwd(zx, r, bias, bounds, dh, 4, 32, cluster)
    again = ss._bwd(zx, r, bias, bounds, dh, 4, 32, cluster)
    torch.cuda.synchronize()
    kw = dict(block_b=4, chunk=32)
    want_h, want_bounds = ref.slstm_scan_fwd_res_ref(zx, r, bias, **kw)
    _scaled_close(h_out, want_h, 1e-4)
    for g, w in zip(bounds, want_bounds):
        torch.testing.assert_close(g, w, atol=1e-4 * max(
            1.0, w.abs().max().item()), rtol=1e-4)
    want = ref.slstm_scan_bwd_ref(zx, r, bias, bounds, dh, **kw)
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        _scaled_close(a, w, 1e-4)


@pytest.mark.cuda
def test_cuda_slstm_train_runs_k7_then_k8(cuda_device):
    """`slstm_train(impl="flash")` under autograd at the smoke config in
    float32: one K7 and one K8 launch, output and gradients equal to the
    cell loop's within float32 rounding."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import xlstm as xlstm_mod

    cfg = dataclasses.replace(get_smoke_config("xlstm-125m"),
                              param_dtype="float32", compute_dtype="float32")
    g = torch.Generator(cuda_device).manual_seed(1)
    p = xlstm_mod.init_slstm(g, cfg)
    x = torch.randn(2, 64, cfg.d_model, generator=g, device=cuda_device)
    out = {}
    for impl in ("flash", "plain"):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        fwd, bwd = ops.slstm_scan.launches, ops.slstm_scan_bwd.launches
        y = xlstm_mod.slstm_train(leaves, x, cfg, impl=impl)
        grads = torch.autograd.grad(y.square().sum(), list(leaves.values()))
        torch.cuda.synchronize()
        n = int(impl == "flash")
        assert ops.slstm_scan.launches == fwd + n
        assert ops.slstm_scan_bwd.launches == bwd + n
        out[impl] = [y.detach(), *grads]
    for a, w in zip(out["flash"], out["plain"]):
        _scaled_close(a, w, 1e-4)


LADDER = ("int8", "int8_ef", "int4_ef", "bf16", "topk_ef", "powersgd")


def _ladder_tree(w, device):
    """A matrix leaf, an all-ones norm leaf (the top-k tie case) and a
    two-super-block group, as CPU and card copies of the same values."""
    g = torch.Generator().manual_seed(4)
    tree = {"w": torch.randn(w, 64, 48, generator=g),
            "norm": torch.ones(w, 96),
            "blocks": [{"k": torch.randn(w, 32, 8, generator=g),
                        "scale": torch.ones(w, 96)} for _ in range(2)]}
    from repro_torch.tree import tree_map
    return tree, tree_map(lambda x: x.to(device), tree)


@pytest.mark.cuda
def test_cuda_topk_keeps_the_lowest_index_among_ties(cuda_device):
    """`protocol._topk_sparsify` on the card keeps what it keeps on the
    CPU (jax.lax.top_k's rule, tests/test_torch_compression.py): ties go
    to the lowest index, whatever order `torch.topk` returns them in."""
    from repro_torch.core import protocol

    g = torch.Generator().manual_seed(0)
    rows = torch.stack([torch.ones(100_000),
                        torch.randint(-3, 4, (100_000,), generator=g).float(),
                        torch.randn(100_000, generator=g)])
    for k in (1, 7, 3125, 50_000):
        want = protocol._topk_sparsify(rows, k)
        got = protocol._topk_sparsify(rows.to(cuda_device), k).cpu()
        assert torch.equal(got, want), k
        assert torch.equal(got[0, :k], torch.ones(k))


@pytest.mark.cuda
@pytest.mark.parametrize("name", LADDER)
def test_cuda_hub_round_matches_cpu(cuda_device, name):
    """One hub round of each compression rung, W = 3 x 2 on a ring, on the
    card against the CPU at `tolerance.LADDER_TOL`."""
    from repro_torch.core import mllsgd, protocol
    from repro_torch.interop import flatten
    from repro_torch.kernels.tolerance import align_columns, ladder_error

    cfg = mllsgd.MLLConfig(hub_topology="ring", mixing=name)
    net = mllsgd.build_network(cfg, 3, 2)
    out = {}
    for dev, tree in zip(("cpu", cuda_device), _ladder_tree(6, cuda_device)):
        st = mllsgd.build_state(cfg, net, device=dev)
        strat = protocol.get_mixing(name)
        params, state = strat.hub_with_state(tree, st,
                                             strat.init_state(tree))
        out[str(dev)[:4]] = (flatten(params, worker_axis=True),
                             flatten(state, worker_axis=True))
    (pc, sc), (pg, sg) = out["cpu"], out["cuda"]
    scale = max(float(np.abs(v).max()) for v in pc.values())
    for k in pc:
        ladder_error(name, torch.from_numpy(pg[k]), torch.from_numpy(pc[k]))
    for k in sc:
        got, want = torch.from_numpy(sg[k]), torch.from_numpy(sc[k])
        if k.startswith("q::"):
            got = align_columns(got, want)
        ladder_error(name, got, want, scale=scale)


# -------------------------------------------- offline generation, MoE, mamba
def _smoke_model(arch, device, **kw):
    """A smoke config's float32 params, drawn on the CPU from a seed, and
    a copy on ``device``."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as model_mod
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype="float32",
                              compute_dtype="float32", **kw)
    cpu = model_mod.init_model(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    return cfg, cpu, tree_map(lambda x: x.to(device), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prefill", [("qwen2-0.5b", "batched"),
                                          ("qwen2-0.5b", "loop"),
                                          ("qwen3-1.7b", "batched"),
                                          ("jamba-v0.1-52b", "loop"),
                                          ("xlstm-125m", "loop")])
def test_cuda_generate_matches_cpu(cuda_device, arch, prefill):
    """`generate` on the card against the CPU port at smoke size, greedy
    and sampled (the Gumbel noise is drawn on each side's device, with the
    same bits): the same tokens."""
    from repro_torch.serve import serve_step as ss_mod

    cfg, cpu, gpu = _smoke_model(arch, cuda_device)
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 7))
    for kw in (dict(), dict(temperature=1.0, seed=3)):
        want = ss_mod.generate(cpu, prompt, cfg, max_new=8, prefill=prefill,
                               **kw)
        got = ss_mod.generate(gpu, prompt, cfg, max_new=8, prefill=prefill,
                              **kw)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), kw


@pytest.mark.cuda
def test_cuda_gumbel_bits_equal_cpu(cuda_device):
    """The sampler's noise: threefry and XLA's float32 log, the same bits
    on the card as on the CPU (and so as `jax.random.gumbel`)."""
    from repro_torch.core import prng

    for seed in (0, 3, 2**31 - 1):
        key = prng.prng_key(seed)
        want = prng.gumbel(key, (4, 151936))
        got = prng.gumbel(key, (4, 151936), cuda_device)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_same_bits_twice(cuda_device, dtype):
    """MoE dispatch and combine on the card: the same bits on two runs
    (indexed writes, a k-ordered combine, no atomics), drops included,
    and the CPU's output within float32 / bf16 rounding."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"),
                              param_dtype=dtype, compute_dtype=dtype,
                              capacity_factor=0.5)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(getattr(torch, dtype))
    gparams = {k: v.to(cuda_device) for k, v in params.items()}
    y1, aux1 = moe.moe_apply(gparams, x.to(cuda_device), cfg)
    y2, aux2 = moe.moe_apply(gparams, x.to(cuda_device), cfg)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    want, want_aux = moe.moe_apply(params, x, cfg)
    dropped = want.float().norm(dim=-1) == 0
    assert dropped.any()
    assert torch.equal(y1.cpu().float().norm(dim=-1) == 0, dropped)
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(y1.cpu().float(), want.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(aux1.cpu(), want_aux, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------ cost counter
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-125m"])
def test_cuda_cost_count_equals_meta(cuda_device, arch):
    """`launch.cost_analysis.CostCounter` over one worker's forward and
    backward (the smoke config, bf16, through K3 / K4 or K7 / K8, under
    remat="full"): the count on the card equals the same step's count on
    meta, FLOPs and bytes exactly, the kernels' work included."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import cost_analysis
    from repro_torch.models import model as model_mod
    from repro_torch.train.train_step import loss_fn
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config(arch)
    toks = torch.randint(1, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(0))

    def count(device):
        params = (model_mod.param_skeleton(cfg) if device.type == "meta"
                  else model_mod.init_model(
                      torch.Generator(device).manual_seed(0), cfg,
                      device=device))
        params = tree_map(lambda x: x.requires_grad_(), params)
        batch = {"tokens": toks[:, :-1].to(device),
                 "labels": toks[:, 1:].to(device)}
        with cost_analysis.CostCounter() as c:
            loss, _ = loss_fn(params, batch, cfg, impl="flash", remat="full")
            torch.autograd.grad(loss, tree_leaves(params))
        return c

    ops.reset_launches()
    card, meta = count(cuda_device), count(torch.device("meta"))
    assert sum(ops.launch_counts().values()) > 0
    assert card.costs.kernels == meta.costs.kernels
    assert dict(card.by_op) == dict(meta.by_op)
    assert (card.costs.flops, card.costs.bytes) == \
        (meta.costs.flops, meta.costs.bytes)
