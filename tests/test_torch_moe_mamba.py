"""The port's MoE (`models.moe`) and mamba (`models.mamba`) blocks against
the JAX package's, on the CPU, and the properties the JAX tests hold them
to (tests/test_extensions.py, tests/test_substrate.py).

Params come from the JAX initialisers and cross over as numpy; inputs are
made from a numpy seed; everything runs in float32.

Tolerances:
* `moe_apply` output and aux loss against JAX: atol = rtol = 1e-5.  The
  router's softmax rounds alike to a few ulps, so top-k picks the same
  experts and the capacity drops the same (token, k) pairs, which is
  asserted exactly (the dropped tokens' rows are exact zeros on both
  sides);
* grouped dispatch against global without drops, and one expert against
  the dense MLP: atol = rtol = 2e-4 and 1e-4, the JAX tests' own;
* `mamba_train` / `mamba_decode` against JAX: atol = rtol = 1e-4.  The
  port runs JAX's associative scan (the same odd/even recursion) inside
  each chunk, but its backward is a hand-written adjoint scan where JAX
  differentiates through the recursion: the same gradients in another
  rounding order, so the gradients of `mamba_train` and of the jamba
  smoke model's `loss_fn` are held to the same 1e-4;
* mamba decode against mamba train inside the port: atol = rtol = 1e-4;
* the jamba smoke model under remat full / dots against none: bit for
  bit (the recomputation repeats the same CPU arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import mlp_apply
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(atol=1e-5, rtol=1e-5)
MAMBA_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(arch), **F32, **kw),
            dataclasses.replace(torch_smoke(arch), **F32, **kw))


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _both_moe(jcfg, tcfg, x, jp, tp):
    wy, waux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    gy, gaux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    return np.asarray(wy), float(waux), gy.numpy(), float(gaux)


# ---------------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3, 8.0])
def test_moe_apply_matches_jax(arch, capacity_factor):
    """Each MoE smoke config (swiglu, geglu) at the default capacity, a
    tight one and a generous one: output, aux loss and the dropped
    tokens."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = _moe_params(jcfg)
    x = _x((3, 20, jcfg.d_model))
    wy, waux, gy, gaux = _both_moe(jcfg, tcfg, x, jp, tp)
    np.testing.assert_allclose(gy, wy, **TOL)
    np.testing.assert_allclose(gaux, waux, **TOL)
    dropped = lambda y: np.linalg.norm(y.reshape(-1, jcfg.d_model), axis=-1) == 0
    np.testing.assert_array_equal(dropped(gy), dropped(wy))
    if capacity_factor == 0.3:
        assert dropped(gy).any()


def test_moe_capacity_drops_tokens():
    """A tiny capacity factor drops overflow tokens (their rows exactly
    zero, the same rows as JAX's), never NaN."""
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b", capacity_factor=0.05)
    jp, tp = _moe_params(jcfg)
    x = _x((2, 32, jcfg.d_model))
    wy, _, gy, _ = _both_moe(jcfg, tcfg, x, jp, tp)
    assert np.isfinite(gy).all()
    norms = np.linalg.norm(gy.reshape(-1, jcfg.d_model), axis=-1)
    assert (norms == 0.0).any()
    np.testing.assert_array_equal(
        norms == 0.0, np.linalg.norm(wy.reshape(-1, jcfg.d_model), axis=-1) == 0)


def test_grouped_moe_equals_global_without_drops():
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b", capacity_factor=8.0)
    jp, tp = _moe_params(jcfg)
    x = torch.from_numpy(_x((4, 16, tcfg.d_model)))
    y1, _ = tmoe.moe_apply(tp, x, tcfg)
    y4, _ = tmoe.moe_apply(tp, x, dataclasses.replace(tcfg, moe_groups=4))
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=2e-4, rtol=2e-4)
    jy4, _ = jmoe.moe_apply(jp, jnp.asarray(x.numpy()),
                            dataclasses.replace(jcfg, moe_groups=4))
    np.testing.assert_allclose(y4.numpy(), np.asarray(jy4), **TOL)


@pytest.mark.parametrize("groups", [4, 7])
def test_grouped_moe_with_drops_and_indivisible_fallback(groups):
    """moe_groups 4 routes each group with its own capacity (drops per
    group); 7 does not divide 64 tokens and falls back to one group."""
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b", moe_groups=groups,
                       capacity_factor=0.5)
    jp, tp = _moe_params(jcfg)
    x = _x((4, 16, jcfg.d_model))
    wy, waux, gy, gaux = _both_moe(jcfg, tcfg, x, jp, tp)
    assert np.isfinite(gy).all()
    np.testing.assert_allclose(gy, wy, **TOL)
    np.testing.assert_allclose(gaux, waux, **TOL)
    if groups == 7:
        y1, _ = tmoe.moe_apply(tp, torch.from_numpy(x),
                               dataclasses.replace(tcfg, moe_groups=1))
        np.testing.assert_array_equal(gy, y1.numpy())


def test_moe_single_expert_equals_dense_mlp():
    """E = 1, top-1, generous capacity: the MoE is the dense MLP with the
    same weights (the combine weight renormalises to 1)."""
    _, tcfg = _cfgs("qwen3-moe-235b-a22b", n_experts=1, top_k=1,
                    capacity_factor=4.0)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    x = torch.from_numpy(_x((2, 8, tcfg.d_model)))
    y_moe, _ = tmoe.moe_apply(tp, x, tcfg)
    dense = {k: tp[k][0] for k in ("w_gate", "w_up", "w_down")}
    y_mlp = mlp_apply(dense, x, dataclasses.replace(
        tcfg, d_ff=tcfg.resolved_moe_d_ff))
    np.testing.assert_allclose(y_moe.numpy(), y_mlp.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_moe_aux_loss_balanced_vs_skewed():
    """The load-balance loss is larger for a router collapsed on expert 0
    (positive inputs: every token's logit for it is large) than a random
    one, and both equal JAX's."""
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b")
    jp, tp = _moe_params(jcfg)
    x = np.abs(_x((4, 64, jcfg.d_model)))
    router = np.zeros((jcfg.d_model, jcfg.n_experts), np.float32)
    router[:, 0] = 10.0
    jskew = dict(jp, router=jnp.asarray(router))
    tskew = dict(tp, router=torch.from_numpy(router))
    _, aux_rand, _, got_rand = _both_moe(jcfg, tcfg, x, jp, tp)
    _, aux_skew, _, got_skew = _both_moe(jcfg, tcfg, x, jskew, tskew)
    assert got_skew > got_rand
    np.testing.assert_allclose([got_rand, got_skew], [aux_rand, aux_skew],
                               **TOL)


def test_top_k_keeps_the_lower_index_on_ties():
    """`jax.lax.top_k`'s order: descending values, the lower index first
    among equal values."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (50, 16)).astype(np.float32) / 4
    for k in (1, 2, 8, 16):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_moe_capacity_matches_jax():
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b")
    for t in (1, 2, 7, 64, 1000):
        for cf in (0.05, 1.25, 8.0):
            assert tmoe.capacity(dataclasses.replace(tcfg, capacity_factor=cf),
                                 t) == jmoe.capacity(
                dataclasses.replace(jcfg, capacity_factor=cf), t)


# -------------------------------------------------------------------- mamba
@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("length", [24, 300, 512])
def test_mamba_train_matches_jax(mamba, length):
    """One chunk (24), one chunk of a length CHUNK does not divide (300),
    two chunks of 256 (512): the state crosses the chunk boundary."""
    jcfg, tcfg, jp, tp = mamba
    x = _x((2, length, jcfg.d_model)) * 0.5
    want = jmamba.mamba_train(jp, jnp.asarray(x), jcfg)
    got = tmamba.mamba_train(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MAMBA_TOL)
    assert tmamba._chunk_size(length) == {24: 24, 300: 300, 512: 256}[length]


@pytest.mark.parametrize("length", [24, 300, 512])
def test_mamba_train_grads_match_jax(mamba, length):
    """The gradients of sum(mamba_train(x) * w) with respect to every
    parameter leaf and the input x against `jax.grad` of JAX's: one chunk,
    one chunk of a length CHUNK does not divide, two chunks (the carried
    state's gradient crosses the chunk boundary)."""
    jcfg, tcfg, jp, tp = mamba
    x = _x((2, length, jcfg.d_model)) * 0.5
    w = _x((2, length, jcfg.d_model), seed=2)
    jgp, jgx = jax.jit(jax.grad(lambda p, v: jnp.sum(
        jmamba.mamba_train(p, v, jcfg) * w), argnums=(0, 1)))(
            jp, jnp.asarray(x))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    loss = (tmamba.mamba_train(params, tx, tcfg) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [*params.values(), tx])
    for name, got in zip([*params, "x"], grads, strict=True):
        want = np.asarray(jgx if name == "x" else jgp[name])
        np.testing.assert_allclose(got.numpy(), want, err_msg=name,
                                   **MAMBA_TOL)


@pytest.fixture(scope="module")
def jamba():
    """The jamba smoke model (mamba + attention, MoE) in float32, params
    from JAX's `init_model`, and one batch of 2 x 48 tokens."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jp = jax.jit(jmodel.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 49))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    return jcfg, tcfg, jp, batch


def _jamba_grads(tp, batch, tcfg, remat):
    leaves = [x.clone().requires_grad_() for x in tree_leaves(tp)]
    it = iter(leaves)
    wp = tree_map(lambda _: next(it), tp)
    loss, _ = tts.loss_fn(wp, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, tcfg, impl="flash",
                          remat=remat)
    return loss.detach(), wp, torch.autograd.grad(loss, leaves)


def test_jamba_loss_grads_match_jax_and_remat_bit_equal(jamba):
    """loss_fn of the jamba smoke model: the value and every gradient leaf
    against `jax.value_and_grad` of JAX's; under remat full and dots the
    port's loss and gradients equal its own un-rematerialised ones bit for
    bit."""
    jcfg, tcfg, jp, batch = jamba
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    loss, wp, grads = _jamba_grads(tp, batch, tcfg, "none")
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jts.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        impl="xla")[0]))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), **MAMBA_TOL)
    it = iter(grads)
    got = interop.flatten(tree_map(lambda _: next(it), wp),
                          worker_axis=False)
    want = jckpt._flatten(jgrads)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **MAMBA_TOL)
    for remat in ("full", "dots"):
        rloss, _, rgrads = _jamba_grads(tp, batch, tcfg, remat)
        assert torch.equal(rloss, loss), remat
        for a, b in zip(rgrads, grads, strict=True):
            assert torch.equal(a, b), remat


def test_mamba_decode_matches_jax_and_train(mamba):
    """16 decode steps against JAX's (outputs and the h / conv state), and
    the steps together against the port's train forward."""
    jcfg, tcfg, jp, tp = mamba
    x = _x((2, 16, jcfg.d_model)) * 0.5
    jstate = jmamba.init_mamba_state(jcfg, 2)
    tstate = tmamba.init_mamba_state(tcfg, 2, torch.device("cpu"))
    assert tstate["h"].dtype == torch.float32
    outs = []
    for t in range(16):
        wy, jstate = jmamba.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                         jstate)
        gy, tstate = tmamba.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                         tcfg, tstate)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **MAMBA_TOL)
        outs.append(gy)
    for name in ("h", "conv"):
        np.testing.assert_allclose(tstate[name].numpy(),
                                   np.asarray(jstate[name]), **MAMBA_TOL)
    train = tmamba.mamba_train(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), train.numpy(),
                               **MAMBA_TOL)


def test_mamba_bf16_keeps_state_float32_and_tail_in_compute_dtype():
    _, tcfg = _cfgs("jamba-v0.1-52b")
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tp = tmamba.init_mamba(torch.Generator().manual_seed(0), tcfg)
    assert tp["a_log"].dtype == tp["dt_bias"].dtype == torch.float32
    assert tp["in_proj"].dtype == torch.bfloat16
    state = tmamba.init_mamba_state(tcfg, 2, torch.device("cpu"))
    x = torch.from_numpy(_x((2, 1, tcfg.d_model))).bfloat16()
    y, state = tmamba.mamba_decode(tp, x, tcfg, state)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    assert state["h"].dtype == torch.float32
    assert state["conv"].dtype == torch.bfloat16
