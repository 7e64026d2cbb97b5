"""The port's protocol engine against the JAX package's, in float32 on the
CPU: the inner optimizers, the gated update, every ported mixing strategy
in every phase, one `protocol_step` per (phase, strategy, optimizer), and
the stacked-worker helpers.

The gate needs no injection: the port draws θ bit for bit as `jax.random`
does (tests/test_torch_network.py).  Inputs are made from a seed with numpy
and fed to both.  Tolerance: atol = rtol = 1e-6 -- the two frameworks may
round single products and sums of at most W terms differently (adamw's
``b ** t`` and square roots included), nothing accumulates over steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mllsgd as jmll
from repro.core import protocol as jp
from repro.core import simulator as jsim
from repro.optim import optimizers as jopt
from repro.train import checkpoint as jckpt
from repro_torch import interop
from repro_torch.core import mllsgd as tmll
from repro_torch.core import protocol as tp
from repro_torch.core import simulator as tsim
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(atol=1e-6, rtol=1e-6)
RATES = (1.0, 0.8, 1.0, 0.6, 0.9, 0.5)


def _tree(seed, w=6):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((w, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((w, 5)).astype(np.float32),
            "blocks": {"pos0": {"k": rng.standard_normal(
                (w, 2, 3, 4)).astype(np.float32)}}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    """Port layout: the JAX ``blocks`` dict (stacked on axis 1) as a list."""
    return interop.tree_from_numpy(tree, "cpu", worker_axis=True)


def _flat_j(tree):
    return jckpt._flatten(tree)


def _assert_close(port_tree, jax_tree, tol=TOL, worker_axis=True):
    got = interop.flatten(port_tree, worker_axis=worker_axis)
    want = _flat_j(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


OPTS = [("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
        ("adamw", {"weight_decay": 0.01})]


@pytest.mark.parametrize("name,kw", OPTS)
def test_optimizer_step_matches_jax(name, kw):
    params, grads = _tree(0), _tree(1)
    step = np.array([1, 3, 2, 5, 1, 7], np.int32)
    jo, to = jopt.get(name, 0.05, **kw), topt.get(name, 0.05, **kw)
    js = jo.init(_j(params))
    if name == "momentum":   # non-zero state so beta * m matters
        js = _j(_tree(2))
    elif name == "adamw":
        js = {"m": _j(_tree(2)), "v": jax.tree.map(jnp.abs, _j(_tree(3)))}
    npy = jax.tree.map(np.asarray, js)
    ts = {"m": _t(npy["m"]), "v": _t(npy["v"])} if name == "adamw" else \
        _t(npy) if name == "momentum" else ()
    jnew, jstate = jo.update(_j(grads), js, _j(params), jnp.asarray(step))
    tnew, tstate = to.update(_t(grads), ts, _t(params), torch.from_numpy(step))
    _assert_close(tnew, jnew)
    _assert_close(tstate, jstate)


def _networks():
    jmc = jmll.MLLConfig(tau=2, q=2, hub_topology="ring", worker_rates=RATES)
    jn = jmll.build_network(jmc, 3, 2)
    tn = tmll.build_network(tmll.MLLConfig(tau=2, q=2, hub_topology="ring",
                                           worker_rates=RATES), 3, 2)
    return jn, tn


@pytest.mark.parametrize("mixing", ["dense", "two_stage", "ppermute"])
@pytest.mark.parametrize("inner_opt", ["sgd", "adamw"])
def test_protocol_step_matches_jax_in_every_phase(mixing, inner_opt):
    """Steps 1 (local), 2 (subnet) and 4 (hub) of tau = q = 2 on a 3-hub
    ring with heterogeneous rates, from the same params and grads."""
    jn, tn = _networks()
    kw = dict(tau=2, q=2, eta=0.05, hub_topology="ring", worker_rates=RATES,
              mixing=mixing, inner_opt=inner_opt, seed=3)
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jst, tst = jmll.build_state(jcfg, jn), tmll.build_state(tcfg, tn,
                                                            device="cpu")
    params, grads = _tree(4), _tree(5)
    for step in (1, 2, 4):
        js = jp.init_train_state(_j(params), cfg=jcfg)._replace(
            step=jnp.int32(step - 1))
        ts = tp.init_train_state(_t(params), cfg=tcfg)._replace(
            step=torch.tensor(step - 1, dtype=torch.int32))
        jout = jp.protocol_step(js, _j(grads), jcfg, jst)
        tout = tp.protocol_step(ts, _t(grads), tcfg, tst)
        assert int(tout.step) == int(jout.step) == step
        _assert_close(tout.params, jout.params)
        _assert_close(tout.opt_state, jout.opt_state)


def test_mll_train_step_and_gated_sgd_match_jax():
    jn, tn = _networks()
    kw = dict(tau=2, q=2, hub_topology="ring", worker_rates=RATES,
              mixing="two_stage", seed=1)
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jst, tst = jmll.build_state(jcfg, jn), tmll.build_state(tcfg, tn,
                                                            device="cpu")
    params, grads = _tree(6), _tree(7)
    for step in (1, 2, 4):
        want = jmll.mll_train_step(_j(params), _j(grads), jnp.int32(step),
                                   jcfg, jst)
        got = tmll.mll_train_step(_t(params), _t(grads), step, tcfg, tst)
        _assert_close(got, want)


def test_gated_off_workers_are_frozen_exactly():
    """θ_i = 0 keeps params, momentum and the step count bit for bit."""
    params, grads = _t(_tree(8)), _t(_tree(9))
    opt = topt.momentum(0.1)
    state = tp.init_gated_opt_state(opt, params)
    before = interop.flatten(params, worker_axis=True)
    theta = torch.tensor([1, 0, 1, 0, 0, 1], dtype=torch.float32)
    params, state = tp.gated_inner_update(opt, params, state, grads, theta)
    after = interop.flatten(params, worker_axis=True)
    mom = interop.flatten(state["inner"], worker_axis=True)
    for k in before:
        for i in range(6):
            same = np.array_equal(after[k][i], before[k][i])
            assert same == (theta[i] == 0), (k, i)
            assert (mom[k][i] == 0).all() == (theta[i] == 0)
    assert state["counts"].tolist() == [1, 0, 1, 0, 0, 1]


def test_mixing_registry_and_guards():
    assert tp.available_mixing() == ("dense", "ppermute", "two_stage")
    for name in tp.UNPORTED_MIXING:
        assert name in jp.MIXING_REGISTRY
        with pytest.raises(NotImplementedError, match="Queue 1"):
            tmll.MLLConfig(mixing=name)
    with pytest.raises(ValueError, match="unknown mixing"):
        tp.get_mixing("nope")
    # grouped strategies need equal subnets; dense takes unequal ones
    from repro_torch.core.hierarchy import MultiLevelNetwork
    net = MultiLevelNetwork.build("ring", (1, 2, 3))
    st = tp.state_from_network(net, device="cpu")
    x = {"a": torch.ones(6, 3)}
    with pytest.raises(ValueError, match="equal-size"):
        tp.get_mixing("two_stage").subnet(x, st)
    y = tp.get_mixing("dense").hub(x, st)
    torch.testing.assert_close(y["a"], torch.ones(6, 3))
    # ppermute needs a circulant H: star over 3 hubs is not
    st = tp.state_from_network(MultiLevelNetwork.build("star", (2,) * 3),
                               device="cpu")
    with pytest.raises(ValueError, match="circulant"):
        tp.get_mixing("ppermute").hub({"a": torch.ones(6, 3)}, st)


def test_stacked_helpers_match_jax_and_promote_like_jax():
    tree = _tree(10)
    a = np.linspace(0.1, 0.3, 6).astype(np.float32)
    a = a / a.sum()
    _assert_close(tsim.weighted_average(_t(tree), torch.from_numpy(a)),
                  jsim.weighted_average(_j(tree), jnp.asarray(a)),
                  worker_axis=False)
    t = np.random.default_rng(11).random((6, 6)).astype(np.float32)
    _assert_close(tsim.apply_operator(_t(tree), torch.from_numpy(t)),
                  jsim.apply_operator(_j(tree), jnp.asarray(t)))
    rep = tsim.replicate({"x": torch.arange(3.0)}, 4)["x"]
    assert rep.shape == (4, 3) and rep.is_contiguous()
    # u of a bf16 fleet is float32, as JAX's tensordot promotes
    xb = torch.randn(6, 4).to(torch.bfloat16)
    u = tsim.weighted_average({"x": xb}, torch.from_numpy(a))["x"]
    want = jsim.weighted_average(
        {"x": jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)},
        jnp.asarray(a))["x"]
    assert u.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(u.numpy(), np.asarray(want), **TOL)


def test_train_state_crosses_both_ways_bit_for_bit():
    """A JAX MLLTrainState (momentum inner state) -> numpy -> the port ->
    numpy: every leaf, key and dtype unchanged."""
    jcfg = jmll.MLLConfig(inner_opt="momentum", mixing="two_stage")
    js = jp.init_train_state(_j(_tree(12)), cfg=jcfg)
    js = js._replace(opt_state={"inner": _j(_tree(13)),
                                "counts": jnp.arange(6, dtype=jnp.int32)},
                     step=jnp.int32(9))
    ts = interop.train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(ts, tp.MLLTrainState)
    assert isinstance(ts.params["blocks"], list)
    got = interop.flatten(ts, worker_axis=True)
    want = _flat_j(js)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = interop.tree_to_numpy(ts, worker_axis=True)
    np.testing.assert_array_equal(back.params["blocks"]["pos0"]["k"],
                                  np.asarray(js.params["blocks"]["pos0"]["k"]))


def test_tree_walkers_share_one_leaf_order():
    """`tree_leaves`, `tree_map`, `map_with_keys` and `flatten` visit the
    leaves in one order, JAX's sorted key order, whatever the dicts'
    insertion order; rebuilt dicts keep their own key order."""
    ts = _t(_tree(14))
    shuffled = {"w": ts["w"], "blocks": ts["blocks"], "b": ts["b"]}
    assert list(shuffled) != sorted(shuffled)
    order = []
    mapped = tree_map(lambda x: order.append(x) or x + 1, shuffled)
    assert list(mapped) == list(shuffled)
    keyed = []
    interop.map_with_keys(lambda k, b, x: keyed.append((k, b, x)), shuffled)
    assert [k for k, _, _ in keyed] == ["b", "blocks::pos0::k",
                                       "blocks::pos0::k", "w"]
    assert [b for _, b, _ in keyed] == [None, 0, 1, None]
    leaves = tree_leaves(shuffled)
    assert all(a is b for a, b in zip(leaves, order))
    assert all(a is x for a, (_, _, x) in zip(leaves, keyed))
    assert list(interop.flatten(shuffled, worker_axis=True)) == [
        "b", "blocks::pos0::k", "w"]
