"""Every architecture of the registry through the port, against the JAX
package (the port's counterpart of tests/test_arch_smoke.py).

For each `ARCH_IDS` smoke config (2 layers, d_model 256, <= 4 experts):
the train forward's logits and MoE aux loss and three decode steps'
logits and state against JAX's in float32 (params from the JAX
`init_model`, through `repro_torch.interop`; inputs from a numpy seed),
decode against the train forward inside the port, the bf16 forward and
decode on the port's own init, one MLL tick of each phase through the
port's `per_worker_grads` + `protocol_step`, and the parameter count.
That covers mamba and MoE (jamba, qwen3-moe, grok), musicgen's frame
embeddings and qwen2-vl's patches.

Tolerances:
* against JAX: atol = rtol = 1e-4 (qwen2-0.5b-smoke's tied logits reach
  ~170 and differ by ~1e-4 absolute; mamba's scan rounds in another
  order, tests/test_torch_moe_mamba.py);
* decode against the train forward, float32, capacity factor 8 (no MoE
  drops, so a decoded token routes as in the forward): atol = rtol =
  2e-3, the JAX test's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.core import mllsgd as tmll
from repro_torch.core import protocol as tp
from repro_torch.models import model as tmodel
from repro_torch.train.train_step import per_worker_grads
from repro_torch.tree import tree_leaves, tree_map

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, b, s, seed=0):
    """numpy inputs in the config's input mode, with labels."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    elif cfg.input_mode == "embeds":
        out = {"frame_embeds": rng.standard_normal((b, s, cfg.d_model))}
    else:                     # patches first; only text carries labels
        p = cfg.num_patches
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - p)),
               "patch_embeds": rng.standard_normal((b, p, cfg.d_model))}
    out["labels"] = rng.integers(0, cfg.vocab_size,
                                 (b, out.get("tokens", np.zeros((b, s))).shape[1]))
    return {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
            for k, v in out.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


def _decode_feed(cfg, b, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return {"frame_embeds": rng.standard_normal(
            (b, 1, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)}


@pytest.fixture(scope="module", params=ARCH_IDS)
def f32(request):
    jcfg = dataclasses.replace(jax_smoke(request.param), **F32)
    tcfg = dataclasses.replace(torch_smoke(request.param), **F32)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_forward_train_matches_jax(f32):
    jcfg, tcfg, jparams, tparams = f32
    batch = _batch(jcfg, B, S)
    want, waux = jmodel.forward_train(jparams, _jax(batch), jcfg)
    got, gaux = tmodel.forward_train(tparams, _torch(batch), tcfg,
                                     impl="plain")
    assert got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    assert (float(gaux) > 0) == (tcfg.n_experts > 0)


def test_decode_step_matches_jax(f32):
    """Three decode steps from a fresh state: each step's logits and the
    final state (caches, recurrent states) leaf by leaf."""
    jcfg, tcfg, jparams, tparams = f32
    jstate = jmodel.init_decode_state(jcfg, B, 8)
    tstate = tmodel.init_decode_state(tcfg, B, 8, device="cpu")
    for t in range(3):
        feed = _decode_feed(jcfg, B, seed=t)
        want, jstate = jmodel.decode_step(jparams, jstate, _jax(feed),
                                          jnp.asarray(t, jnp.int32), jcfg)
        got, tstate = tmodel.decode_step(tparams, tstate, _torch(feed), t,
                                         tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_state = interop.decode_state_to_numpy(tstate)
    assert jax.tree.structure(got_state) == jax.tree.structure(jstate)
    for g, w in zip(jax.tree.leaves(got_state), jax.tree.leaves(jstate)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_decode_matches_train_forward(f32):
    """float32: the sequence one token at a time through `decode_step`
    reproduces the train forward's logits (cache, rotation and recurrence
    in every block family).  Capacity factor 8: a train forward at 1.25
    drops overflow tokens where one decoded token always fits."""
    _, tcfg, _, tparams = f32
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    if tcfg.input_mode == "tokens+patches":
        tcfg = dataclasses.replace(tcfg, input_mode="tokens")  # text only
    s = 12
    batch = _torch(_batch(tcfg, 1, s, seed=2))
    batch.pop("labels")
    key = "tokens" if "tokens" in batch else "frame_embeds"
    logits, _ = tmodel.forward_train(tparams, batch, tcfg, impl="plain")
    state = tmodel.init_decode_state(tcfg, 1, s, device="cpu")
    outs = []
    for t in range(s):
        lg, state = tmodel.decode_step(
            tparams, state, {key: batch[key][:, t:t + 1]}, t, tcfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), logits.numpy(),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_decode(arch):
    """The smoke config as published (bf16) on the port's own init: output
    shapes, finite values, and a decode step that changes the state."""
    cfg = torch_smoke(arch)
    params = tmodel.init_model(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    batch = _torch(_batch(cfg, B, S), torch.bfloat16)
    logits, aux = tmodel.forward_train(params, batch, cfg)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)
    state = tmodel.init_decode_state(cfg, B, 32, device="cpu")
    before = tree_map(torch.clone, state)
    feed = _torch(_decode_feed(cfg, B, 0), torch.bfloat16)
    lg, state = tmodel.decode_step(params, state, feed, 0, cfg)
    assert lg.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(lg.float()).all()
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(before), tree_leaves(state)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_no_nans(arch):
    """Four MLL ticks over W = 4 workers (local, subnet, local, hub with
    tau = q = 2) through `per_worker_grads` + `protocol_step`."""
    cfg = torch_smoke(arch)
    mll = tmll.MLLConfig(tau=2, q=2, eta=0.01, hub_topology="ring",
                         worker_rates=(1.0, 0.5, 1.0, 0.8))
    net = tmll.build_network(mll, 2, 2)
    st = tmll.build_state(mll, net, device="cpu")
    params = tmodel.init_model(torch.Generator().manual_seed(1), cfg,
                               device="cpu")
    state = tp.init_train_state(
        tree_map(lambda x: x[None].repeat((4,) + (1,) * x.dim()), params),
        cfg=mll)
    one = _torch(_batch(cfg, 1, S, seed=1), torch.bfloat16)
    batch = {k: v[None].expand((4,) + v.shape) for k, v in one.items()}
    for _ in range(4):
        grads, metrics = per_worker_grads(state.params, batch, cfg)
        state = tp.protocol_step(state, grads, mll, st)
    assert int(state.step) == 4
    assert torch.isfinite(metrics["loss"]).all()
    for leaf in tree_leaves(state.params):
        assert torch.isfinite(leaf.float()).all()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_jax_and_the_analytic_count(arch):
    tcfg = torch_smoke(arch)
    params = tmodel.init_model(torch.Generator().manual_seed(0), tcfg,
                               device="cpu")
    actual = tmodel.count_params(params)
    jparams = jax.eval_shape(lambda k: jmodel.init_model(k, jax_smoke(arch)),
                             jax.random.PRNGKey(0))
    assert actual == sum(int(np.prod(x.shape))
                         for x in jax.tree.leaves(jparams))
    # every leaf (mamba's a_log / dt_bias / d_skip, the router, the
    # (E, d, f) experts) has the JAX key, layout and dtype: interop copies
    want = {"::".join(str(k.key) for k in path): (tuple(x.shape),
                                                  str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert interop.leaf_spec(params) == want
    if arch in ("qwen3-1.7b", "grok-1-314b", "jamba-v0.1-52b", "xlstm-125m"):
        assert abs(actual - tcfg.param_count()) / actual < 0.15
