"""The port's ServeEngine against the JAX package's.

Both engines serve the same prompts, with the same engine geometry, from
the same params (JAX `init_model`, carried over as numpy by
`repro_torch.interop`), in float32 on the CPU.  Greedy decoding is compared
token for token and the traces field for field, except the wall-clock
fields (``ttft_s``, ``latency_s``).  The port cannot reproduce `jax.random`
bits, so sampled decoding is tested for same-seed determinism within the
port only.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import timeline
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.serve import engine as tengine
from repro_torch.serve.kv_cache import BlockAllocator, PagedCacheConfig

F32 = dict(param_dtype="float32", compute_dtype="float32")
# 5 requests through 2 lanes on a pool of 12 blocks: a request's budget
# (prompt of <= 13 tokens + 8 new) takes up to 6 blocks, so the 5 requests
# need more blocks than the pool has and later admissions reuse the blocks
# that finished requests freed, mid-batch
GEOMETRY = dict(max_batch=2, block_size=4, num_blocks=12, max_len=32)
WALL_CLOCK = ("ttft_s", "latency_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(window=0):
    return (dataclasses.replace(jax_smoke("qwen2-0.5b"), sliding_window=window,
                                **F32),
            dataclasses.replace(torch_smoke("qwen2-0.5b"),
                                sliding_window=window, **F32))


@pytest.fixture(scope="module")
def params():
    jparams = jmodel.init_model(jax.random.PRNGKey(0), _cfgs()[0])
    return jparams, jax.tree.map(np.asarray, jparams)


def _requests(n=5, lo=4, hi=14, seed=1, rate=0.7):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 512, size=int(rng.integers(lo, hi)))
               .astype(np.int32) for _ in range(n)]
    return prompts, rate


def _serve(module, params, cfg, prompts, rate, **kw):
    ecfg = module.EngineConfig(**dict(GEOMETRY, **kw))
    extra = {} if module is jengine else {"device": "cpu"}
    eng = module.ServeEngine(params, cfg, ecfg, **extra)
    out = eng.run(module.poisson_arrivals(prompts, max_new=8, rate=rate,
                                          seed=0))
    return eng, out


def _strip_wall_clock(trace):
    meta = dict(trace["meta"])
    meta["requests"] = [{k: v for k, v in r.items() if k not in WALL_CLOCK}
                        for r in meta["requests"]]
    return dict(trace, meta=meta)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_engine_matches_jax_engine(params, window, impl):
    """Greedy tokens equal token for token, and the trace -- slots,
    busy/idle slots, events, round costs, request slot records -- equal
    field for field, with block reuse mid-batch; also under a sliding
    window shorter than the prompts."""
    jcfg, tcfg = _cfgs(window)
    jparams, nparams = params
    prompts, rate = _requests(seed=1 + window)
    jeng, jout = _serve(jengine, jparams, jcfg, prompts, rate)
    teng, tout = _serve(tengine, interop.params_from_numpy(
        nparams, tcfg, device="cpu"), tcfg, prompts, rate, impl=impl)
    assert len(tout["outputs"]) == 5 and teng.alloc.available == 12
    for rid, toks in jout["outputs"].items():
        assert tout["outputs"][rid] == [int(t) for t in toks]
    assert (_strip_wall_clock(teng.trace(run="x"))
            == _strip_wall_clock(jeng.trace(run="x")))
    assert tout["slots"] == jout["slots"]
    assert tout["generated"] == jout["generated"]


def test_exported_trace_loads_in_jax_timeline(params, tmp_path):
    _, tcfg = _cfgs()
    prompts, rate = _requests(n=3, seed=9)
    eng, _ = _serve(tengine, interop.params_from_numpy(params[1], tcfg,
                                                       device="cpu"),
                    tcfg, prompts, rate)
    doc = timeline.load_trace(eng.export_trace(str(tmp_path / "t.json"),
                                               note="port"))
    assert doc["schema"] == timeline.TRACE_SCHEMA == tengine.TRACE_SCHEMA
    assert doc["rounds_completed"] == 3 and doc["meta"]["note"] == "port"
    assert all(b + i == GEOMETRY["max_batch"]
               for b, i in zip(doc["busy_slots"], doc["idle_slots"]))


def test_sampled_decoding_is_deterministic_per_seed(params):
    _, tcfg = _cfgs()
    tparams = interop.params_from_numpy(params[1], tcfg, device="cpu")
    prompts, rate = _requests(n=3, seed=4)
    # qwen2-0.5b-smoke's tied head gives logits of ~100: a high temperature
    # keeps the draws from collapsing onto the argmax
    runs = [_serve(tengine, tparams, tcfg, prompts, rate, temperature=50.0,
                   seed=seed)[1]["outputs"] for seed in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_block_allocator_accounting():
    a = BlockAllocator(8)
    got = a.alloc(3)
    assert got == [0, 1, 2] and a.available == 5
    assert a.alloc(6) is None and a.available == 5   # all-or-nothing
    a.free(got)
    assert a.available == 8 and a.alloc(1) == [2]    # LIFO reuse
    with pytest.raises(ValueError, match="double free"):
        a.free([0])
    with pytest.raises(ValueError, match="unknown block"):
        a.free([99])
    with pytest.raises(ValueError):
        PagedCacheConfig(block_size=4, num_blocks=4, max_len=64)


def test_engine_rejects_unknown_impl_and_unported_patterns(params):
    _, tcfg = _cfgs()
    tparams = interop.params_from_numpy(params[1], tcfg, device="cpu")
    for impl in ("xla", "pallas", "cuda"):
        with pytest.raises(ValueError, match="unknown impl"):
            tengine.ServeEngine(tparams, tcfg, tengine.EngineConfig(impl=impl),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        tengine.ServeEngine(tparams, torch_smoke("jamba-v0.1-52b"),
                            tengine.EngineConfig(), device="cpu")


def test_engine_needs_a_gpu_unless_cpu_is_asked_for(params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tcfg = _cfgs()
    tparams = interop.params_from_numpy(params[1], tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.ServeEngine(tparams, tcfg, tengine.EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.params_from_numpy(params[1], tcfg)
