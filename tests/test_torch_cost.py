"""The port's cost accounting (`repro_torch.launch.cost_analysis`) against
the JAX package's `launch/hlo_analysis.py`, on the CPU.

* Matrix-product FLOPs of a smoke forward (plain attention / the plain
  sLSTM loop on both sides) equal ``analyze_hlo``'s ``dot_flops`` of the
  compiled JAX forward: tolerance rtol 1e-9 (both count 2 * prod(result) *
  prod(contracted) of the same products; measured equal);
  ``torch.utils.flop_counter`` agrees exactly.
* ``model_flops`` and ``roofline_terms``: the JAX formulas with the H100
  constants in place of the TPU's (exact up to float rounding, rtol 1e-12).
* The kernels' ``meta`` branches (K3, K4, K7, K8) return what the plain
  versions return, in shape and dtype, and count their work by formula.
* The collective helpers on ``meta`` stand-in groups record the kind,
  bytes and ranks that the same calls record in a gloo world of two.
* Mamba's chunked selective scan, forward and backward on ``meta``, moves
  bytes linearly in its chunk: at most 1.75 GB at chunk 256 (B 1,
  d_inner 512, N 16; a step-by-step loop under autograd counted 17.49 GB
  there, growing ~3.9x per doubling), and chunk 256 at most 2.2 times
  chunk 128.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.launch import hlo_analysis as hlo
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.core import collectives
from repro_torch.kernels import ops, ref
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import mesh as tmesh
from repro_torch.models import mamba as tmamba
from repro_torch.models import model as tmodel
from repro_torch.train.train_step import loss_fn
from repro_torch.tree import tree_leaves, tree_map

DOT_RTOL = 1e-9
FORMULA_RTOL = 1e-12


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-125m"])
def test_dot_flops_equal_analyze_hlo(arch):
    jcfg, tcfg = jax_smoke(arch), torch_smoke(arch)
    b, s = 2, 32
    fwd = jax.jit(lambda p, t: jmodel.forward_train(
        p, {"tokens": t}, jcfg, impl="xla")[0])
    text = fwd.lower(jmodel.init_model(jax.random.PRNGKey(0), jcfg),
                     jnp.zeros((b, s), jnp.int32)).compile().as_text()
    want = hlo.analyze_hlo(text).dot_flops
    batch = {"tokens": _meta(b, s, dtype=torch.int32)}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        _, got = ca.count(tmodel.forward_train, tmodel.param_skeleton(tcfg),
                          batch, tcfg, impl="plain")
    assert got.dot_flops == pytest.approx(want, rel=DOT_RTOL)
    assert got.dot_flops == fc.get_total_flops()
    assert got.flops > got.dot_flops > 0 and got.bytes > 0


def test_roofline_and_model_flops_follow_the_reference():
    costs = ca.Costs(flops=3.0e15, dot_flops=2.9e15, bytes=7.0e12,
                     collective_bytes=5.0e10, dcn_bytes=2.0e9)
    want = hlo.roofline_terms(hlo.HloCosts(
        flops=costs.flops, dot_flops=costs.dot_flops, bytes=costs.bytes,
        collective_bytes=costs.collective_bytes,
        dcn_bytes=costs.dcn_bytes), 256)
    got = ca.roofline_terms(costs, 256)
    rel = dict(rel=FORMULA_RTOL)
    assert got.compute_s * ca.PEAK_FLOPS == pytest.approx(
        want.compute_s * hlo.PEAK_FLOPS, **rel)
    assert got.memory_s * ca.HBM_BW == pytest.approx(
        want.memory_s * hlo.HBM_BW, **rel)
    assert got.collective_s * ca.NVLINK_BW == pytest.approx(
        want.collective_s * hlo.ICI_BW, **rel)
    assert got.dcn_s * ca.DCN_BW == pytest.approx(
        want.dcn_s * hlo.DCN_BW, **rel)
    for k in ("flops", "bytes", "collective_bytes", "dcn_bytes", "chips"):
        assert getattr(got, k) == getattr(want, k), k
    assert set(got.as_dict()) == set(want.as_dict())
    assert ca.model_flops(1_700_000_000, 4096) == hlo.model_flops(
        1_700_000_000, 4096)
    assert (ca.PEAK_FLOPS, ca.PEAK_FLOPS_F32, ca.HBM_BW) == \
        (989e12, 67e12, 3.35e12)


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    return tuple(_shapes(y) for y in x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_meta_branches_match_plain_shapes(dtype):
    """K3 / K4 on meta: the plain versions' output shapes and dtypes, no
    launch, and the work of `attention_fwd_work` / `attention_bwd_work`."""
    b, t, h, hkv, hd = 2, 24, 4, 2, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, t, n, hd, generator=g).to(dtype)
               for n in (h, hkv, hkv))
    kw = dict(causal=True, window=8, softcap=0.0)
    o, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    do = torch.randn(o.shape, generator=g).to(dtype)
    want_f = _shapes((o, lse))
    want_b = _shapes(ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw))
    mq, mk, mv, mo, mdo = (x.to("meta") for x in (q, k, v, o, do))
    ops.reset_launches()
    with ca.CostCounter() as c:
        got_f = ops.flash_attention_fwd_res(mq, mk, mv, **kw)
        got_b = ops.flash_attention_bwd(mq, mk, mv, mo, lse.to("meta"), mdo,
                                        **kw)
    assert _shapes(got_f) == want_f and _shapes(got_b) == want_b
    assert all(x.device.type == "meta" for x in got_f + got_b)
    assert ops.launch_counts()["flash_attention"] == 0
    fwd = ops.attention_fwd_work(mq, mk, causal=True, window=8)
    bwd = ops.attention_bwd_work(mq, mk, causal=True, window=8)
    assert c.costs.kernels["flash_attention"] == dict(
        calls=1, flops=fwd[0], bytes=fwd[1])
    assert c.costs.kernels["flash_attention_bwd"] == dict(
        calls=1, flops=bwd[0], bytes=bwd[1])
    # 8-wide window over 24 causal queries: 1 + 2 + ... + 8 + 16 * 8 pairs
    assert fwd[0] == 4 * hd * h * b * (36 + 16 * 8)
    assert c.costs.flops == fwd[0] + bwd[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slstm_meta_branches_match_plain_shapes(dtype):
    """K7 (with and without residuals) and K8 on meta: the plain versions'
    output shapes and dtypes, and their work by formula."""
    b, t, h, hd = 3, 20, 2, 8
    g = torch.Generator().manual_seed(1)
    zx = torch.randn(b, t, h, 4 * hd, generator=g).to(dtype)
    r = torch.randn(h, hd, 4 * hd, generator=g) * 0.1
    bias = torch.randn(h, 4 * hd, generator=g)
    kw = dict(block_b=2, chunk=8)
    hs, bounds = ref.slstm_scan_fwd_res_ref(zx, r, bias, **kw)
    dh = torch.randn(hs.shape, generator=g).to(dtype)
    want_b = _shapes(ref.slstm_scan_bwd_ref(zx, r, bias, bounds, dh, **kw))
    mz, mr, mb, mdh = (x.to("meta") for x in (zx, r, bias, dh))
    with ca.CostCounter() as c:
        got_f = ops.slstm_scan_fwd_res(mz, mr, mb, **kw)
        got_b = ops.slstm_scan_bwd(mz, mr, mb, tuple(x.to("meta")
                                                     for x in bounds),
                                   mdh, **kw)
        with torch.no_grad():
            got_h = ops.slstm_scan(mz, mr, mb, **kw)
    assert _shapes(got_f) == _shapes((hs, bounds))
    assert _shapes(got_b) == want_b
    assert _shapes(got_h) == _shapes(ref.slstm_scan_ref(zx, r, bias))
    fwd = ops.slstm_fwd_work(mz, mr, mb, residuals=True, **kw)
    bwd = ops.slstm_bwd_work(mz, mr, mb, **kw)
    nores = ops.slstm_fwd_work(mz, mr, mb, residuals=False, **kw)
    assert c.costs.kernels["slstm_scan"]["calls"] == 2
    assert c.costs.kernels["slstm_scan"]["flops"] == fwd[0] + nores[0]
    assert c.costs.kernels["slstm_scan"]["bytes"] == fwd[1] + nores[1]
    assert c.costs.kernels["slstm_scan_bwd"] == dict(
        calls=1, flops=bwd[0], bytes=bwd[1])
    assert fwd[0] == 2 * b * t * h * hd * 4 * hd and bwd[0] == 3 * fwd[0]
    assert fwd[1] - nores[1] == 4 * 4 * 4 * 3 * h * hd    # Bp 4, 3 chunks


def test_full_width_step_on_meta_counts_kernels_under_remat():
    """qwen3-1.7b at full width, one worker's forward and backward on meta
    through the flash path: K3 once a layer (twice under remat="full", the
    recomputation), K4 once; the matrix products equal
    ``torch.utils.flop_counter``'s count."""
    cfg = get_config("qwen3-1.7b")
    params = tree_map(lambda x: x.requires_grad_(),
                      tmodel.param_skeleton(cfg))
    batch = {k: _meta(1, 256, dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    calls = {}
    for remat in ("none", "full"):
        with ca.CostCounter() as c, FlopCounterMode(display=False) as fc:
            loss, _ = loss_fn(params, batch, cfg, impl="flash", remat=remat)
            torch.autograd.grad(loss, tree_leaves(params))
        assert c.costs.dot_flops == fc.get_total_flops()
        calls[remat] = {k: v["calls"] for k, v in c.costs.kernels.items()}
    n = cfg.num_layers
    assert calls["none"] == {"flash_attention": n, "flash_attention_bwd": n}
    assert calls["full"] == {"flash_attention": 2 * n,
                             "flash_attention_bwd": n}


def _scan_bytes(chunk: int, di: int = 512, n: int = 16) -> float:
    """Counted bytes of `_selective_scan_chunked`'s forward and backward
    over one chunk on meta."""
    dt, u = (_meta(1, chunk, di, dtype=torch.float32) for _ in range(2))
    bm, cm = (_meta(1, chunk, n, dtype=torch.float32) for _ in range(2))
    ins = [x.requires_grad_() for x in (dt, _meta(di, n, dtype=torch.float32),
                                        bm, cm, u)]

    def step():
        y = tmamba._selective_scan_chunked(*ins)
        torch.autograd.grad(y, ins, torch.empty_like(y))
    return ca.count(step)[1].bytes


def test_mamba_scan_backward_bytes_linear_in_the_chunk():
    assert tmamba._chunk_size(256) == 256 and tmamba._chunk_size(128) == 128
    b128, b256 = _scan_bytes(128), _scan_bytes(256)
    assert b256 <= 1.75e9
    assert b256 / b128 <= 2.2


def _collective_ranks(meta: bool) -> list:
    """One rank of a gloo world of two: an all-reduce, an all-gather and a
    send / recv to the other rank, recorded -- on CPU tensors over the
    world's group, or on meta tensors over a stand-in of it."""
    rank = torch.distributed.get_rank()
    group = (collectives.StandInGroup((0, 1), rank) if meta
             else torch.distributed.group.WORLD)
    x = torch.ones(3, 5, dtype=torch.bfloat16,
                   device="meta" if meta else "cpu")
    recs = []
    with collectives.record_into(recs):
        outs = [collectives.all_reduce_sum(x, group),
                collectives.all_gather_rows(x, group),
                collectives.sendrecv(x, 1 - rank, 1 - rank, group)]
    return [dataclasses.astuple(r) for r in recs], \
        [(tuple(o.shape), o.dtype) for o in outs]


def _both(*_):
    return _collective_ranks(False), _collective_ranks(True)


def test_meta_collectives_record_what_gloo_moves():
    ranks = tmesh.spawn(_both, 2, backend="gloo", device="cpu",
                        timeout=120)
    for rank, (real, meta) in enumerate(ranks):
        assert real == meta
        recs, shapes = real
        assert recs == [("all_reduce", 30, rank, (0, 1)),
                        ("all_gather", 60, rank, (0, 1)),
                        ("sendrecv", 30, rank, (1 - rank,))]
        assert shapes == [((3, 5), torch.bfloat16), ((6, 5), torch.bfloat16),
                          ((3, 5), torch.bfloat16)]


def test_counter_splits_cross_pod_bytes():
    """Peers ``pod_stride`` apart count as cross-node (dcn) bytes; a meta
    collective touches no process group."""
    x = _meta(4, 8, dtype=torch.float32)
    with ca.CostCounter(pod_stride=256) as c:
        collectives.all_reduce_sum(x, collectives.StandInGroup((0, 16), 0))
        collectives.all_reduce_sum(x, collectives.StandInGroup((0, 256), 0))
        collectives.sendrecv(x, 256, 256, collectives.StandInGroup(
            (0, 256), 0))
    assert c.costs.collective_bytes == 3 * 128
    assert c.costs.dcn_bytes == 2 * 128
    assert dict(c.costs.collective_counts) == {"all_reduce": 2,
                                               "sendrecv": 1}
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="stand-in"):
        collectives.all_reduce_sum(torch.zeros(2),
                                   collectives.StandInGroup((0, 1), 0))
