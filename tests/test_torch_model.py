"""The port's model against the JAX package's on the same params.

Params come from the JAX `init_model` and cross over as numpy through
`repro_torch.interop.params_from_numpy`; tokens, pools and tables are made
from a seed with numpy.  Both smoke configs (2 layers) run in float32, so
the comparison is about the algorithm, not bf16 rounding.

Tolerance: atol = rtol = 1e-4 on logits and caches.  The two frameworks sum
in other orders through two layers of projections, norms and attention;
qwen2-0.5b-smoke ties its LM head to an embedding of scale 1, so its logits
reach ~170 and differ by ~1e-4 absolute (~1e-6 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_leaves

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen3-1.7b", "qwen2-0.5b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(jax_smoke(arch), **f32),
            dataclasses.replace(torch_smoke(arch), **f32))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    nparams = jax.tree.map(np.asarray, jparams)
    tparams = interop.params_from_numpy(nparams, tcfg, device="cpu")
    return jcfg, tcfg, jparams, nparams, tparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_forward_train_logits(setup, impl):
    jcfg, tcfg, jparams, _, tparams = setup
    toks = _tokens(jcfg, 2, 21)
    want, _ = jmodel.forward_train(jparams, {"tokens": jnp.asarray(toks)},
                                   jcfg)
    got, aux = tmodel.forward_train(
        tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_prefill_forward_logits_and_kv(setup, impl):
    jcfg, tcfg, jparams, _, tparams = setup
    toks = _tokens(jcfg, 3, 16, seed=1)
    want, want_kv = jmodel.prefill_forward(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, got_kv = tmodel.prefill_forward(
        tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(got_kv) == tcfg.num_super_blocks
    for layer, kv in enumerate(got_kv):
        for name, (k, v) in kv.items():
            np.testing.assert_allclose(
                k.numpy(), np.asarray(want_kv[name][0][layer]), **TOL)
            np.testing.assert_allclose(
                v.numpy(), np.asarray(want_kv[name][1][layer]), **TOL)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_paged_decode_step_logits_and_pools(setup, impl):
    """One decode step on a filled pool: the new token's k/v land in the
    right physical slot, the inactive lane writes nothing, and the active
    lanes' logits agree."""
    jcfg, tcfg, jparams, _, tparams = setup
    rng = np.random.default_rng(2)
    nb, bs, nmax = 12, 4, 3
    hkv, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim
    shape = (jcfg.num_super_blocks, nb, bs, hkv, hd)
    pools = {"k_pool": rng.standard_normal(shape, np.float32),
             "v_pool": rng.standard_normal(shape, np.float32)}
    tables = rng.permutation(nb)[:3 * nmax].reshape(3, nmax).astype(np.int32)
    lengths = np.array([7, 0, 12], np.int32)          # lane 1 inactive
    toks = _tokens(jcfg, 3, 1, seed=3)

    want, want_state = jmodel.paged_decode_step(
        jparams, {"pos0": jax.tree.map(jnp.asarray, pools)},
        {"tokens": jnp.asarray(toks)}, jnp.asarray(tables),
        jnp.asarray(lengths), jcfg)
    state = [{"pos0": {k: torch.from_numpy(v[i].copy())
                       for k, v in pools.items()}}
             for i in range(jcfg.num_super_blocks)]
    got, got_state = tmodel.paged_decode_step(
        tparams, state, {"tokens": torch.from_numpy(toks).long()},
        torch.from_numpy(tables), torch.from_numpy(lengths), tcfg, impl=impl)
    live = lengths > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)
    for layer, st in enumerate(got_state):
        for name in ("k_pool", "v_pool"):
            np.testing.assert_allclose(
                st["pos0"][name].numpy(),
                np.asarray(want_state["pos0"][name][layer]), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_exact(dtype):
    jcfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), param_dtype=dtype)
    tcfg = dataclasses.replace(torch_smoke("qwen3-1.7b"), param_dtype=dtype)
    nparams = jax.tree.map(np.asarray,
                           jmodel.init_model(jax.random.PRNGKey(1), jcfg))
    tparams = interop.params_from_numpy(nparams, tcfg, device="cpu")
    assert tparams["embed"]["table"].dtype == getattr(torch, dtype)
    assert len(tparams["blocks"]) == tcfg.num_super_blocks
    back = interop.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(nparams)
    for a, b in zip(jax.tree.leaves(nparams), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_init_model_follows_device_rule():
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    gen = torch.Generator().manual_seed(0)
    params = tmodel.init_model(gen, tcfg, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    assert tmodel.count_params(params) == jmodel.count_params(
        jmodel.init_model(jax.random.PRNGKey(0), jcfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodel.init_model(gen, tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodel.init_paged_state(tcfg, 4, 4)


def test_unported_blocks_raise():
    tcfg = torch_smoke("jamba-v0.1-52b")
    with pytest.raises(NotImplementedError, match="Other architectures"):
        tmodel.init_model(torch.Generator(), tcfg, device="cpu")


def test_param_skeleton_is_init_model_without_memory():
    """`param_skeleton` (what `load_u_k` restores into) has `init_model`'s
    keys, shapes and dtypes, on the meta device."""
    _, tcfg = _cfgs("qwen3-1.7b")
    params = tmodel.init_model(torch.Generator().manual_seed(0), tcfg,
                               device="cpu")
    skeleton = tmodel.param_skeleton(tcfg)
    assert interop.leaf_spec(skeleton) == interop.leaf_spec(params)
    assert {x.device.type for x in tree_leaves(skeleton)} == {"meta"}
