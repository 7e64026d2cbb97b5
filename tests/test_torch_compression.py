"""The port's compression ladder (int8, int8_ef, int4_ef, bf16, topk_ef,
powersgd) and the harness's chunked overlap against the JAX package's, on
the CPU in float32.

Inputs are made from a seed with numpy and fed to both packages.
Tolerances, per rung, on the params and the mixing state:

* int8 / int8_ef / int4_ef: each quantized value is ``round(z / scale)``
  (half to even in both frameworks).  A compensated hub model z that the
  two frameworks' sums put on opposite sides of a half level lands one
  level apart, so at most 2% of the elements may differ by up to one
  level (2 max|value| / levels, times a coefficient <= 1); every other
  element agrees to 1e-6 (abs + rel);
* bf16 and topk_ef: 1e-6 (abs + rel): the only difference is the
  rounding of the v-weighted mean of W / D terms; top-k keeps the lowest
  index among equal magnitudes, as ``jax.lax.top_k`` does;
* powersgd: 1e-5 (abs + rel) on params and residuals, the factors Q up to
  each column's sign at 1e-5 abs + 1e-4 rel: the initial Q of
  `prng.normal` agrees to 2 float32 ulps (tests/test_torch_prng.py), and
  a QR may flip a column's sign (P P^T M does not depend on it);
* trajectories (simulate, run_timeline, the harness): atol 1e-5, as in
  tests/test_torch_simulator.py and tests/test_torch_train.py;
* within the port (kill + resume, checkpoint round trips, chunk-wise =
  whole-buffer packing): bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import mllsgd as jmll
from repro.core import outer as jouter
from repro.core import packing as jpacking
from repro.core import protocol as jp
from repro.core import simulator as jsim
from repro.core import timeline as jtl
from repro.core.hierarchy import MLLSchedule as JSched
from repro.data import pipeline as jpipe
from repro.launch import harness as jharness
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.core import mllsgd as tmll
from repro_torch.core import outer as touter
from repro_torch.core import packing as tpacking
from repro_torch.core import protocol as tp
from repro_torch.core import simulator as tsim
from repro_torch.core import timeline as ttl
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import harness as tharness
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.train import checkpoint as tckpt
from repro_torch.tree import tree_leaves, tree_map

from test_torch_simulator import jax_task, torch_task
from test_torch_timeline import _nets, _run_port

LADDER = ("int8", "int8_ef", "int4_ef", "bf16", "topk_ef", "powersgd")
LEVELS = {"int8": 127, "int8_ef": 127, "int4_ef": 7}
F32 = dict(param_dtype="float32", compute_dtype="float32")
JCFG = dataclasses.replace(jax_smoke("qwen3-1.7b"), **F32)
TCFG = dataclasses.replace(torch_smoke("qwen3-1.7b"), **F32)
TOL = dict(atol=1e-5, rtol=1e-4)
QUIET = dict(log=lambda *a, **k: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(mixing="two_stage", d=3, nd=2, rates=1.0):
    kw = dict(tau=2, q=2, eta=0.05, hub_topology="ring", mixing=mixing,
              worker_rates=rates)
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jnet, tnet = jmll.build_network(jcfg, d, nd), tmll.build_network(tcfg, d,
                                                                     nd)
    return (jcfg, tcfg, jmll.build_state(jcfg, jnet),
            tmll.build_state(tcfg, tnet, device="cpu"))


def _tree(rng, w):
    """Matrix, vector and per-worker scalar leaves, two all-ones leaves (an
    RMSNorm scale: the top-k tie case) and a two-super-block ``blocks``
    group, whose leaves the compressed rungs treat as one JAX leaf."""
    def n(*shape):
        return rng.standard_normal((w,) + shape).astype(np.float32)
    return {"w": n(6, 5), "b": n(5), "t": n(), "norm": np.ones((w, 40),
                                                                np.float32),
            "blocks": {"pos0": {"k": n(2, 3, 4),
                                "scale": np.ones((w, 2, 40), np.float32)}}}


def _t(tree):
    return interop.tree_from_numpy(tree, "cpu", worker_axis=True)


def _flat(port_tree):
    return interop.flatten(port_tree, worker_axis=True)


def _close_int(got, want, levels, key):
    err = np.abs(got - want)
    off = err > 1e-6 + 1e-6 * np.abs(want)
    assert off.mean() <= 0.02, key
    if off.any():
        assert err.max() <= 2 * np.abs(want).max() / levels, key


def _close_q(got, want, key):
    """Factors (W, c, r) up to each column's sign."""
    sign = np.sign((got * want).sum(axis=1, keepdims=True))
    np.testing.assert_allclose(got * np.where(sign == 0, 1, sign), want,
                               atol=1e-5, rtol=1e-4, err_msg=key)


def _check(name, port_tree, jax_tree):
    got, want = _flat(port_tree), jckpt._flatten(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        if name in LEVELS:
            _close_int(got[k], want[k], LEVELS[name], k)
        elif name == "powersgd" and "::q::" in "::" + k:
            _close_q(got[k], want[k], k)
        else:
            tol = 1e-5 if name == "powersgd" else 1e-6
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("name", LADDER)
def test_hub_rounds_match_jax_threading_state(name):
    """Three hub rounds of W = 3 x 2 on a ring, the state threaded through
    each package on its own, with the same local change before each."""
    _, _, jst, tst = _states()
    rng = np.random.default_rng(0)
    tree = _tree(rng, 6)
    js, ts = jax.tree.map(jnp.asarray, tree), _t(tree)
    jstrat, tstrat = jp.get_mixing(name), tp.get_mixing(name)
    jm, tm = jstrat.init_state(js), tstrat.init_state(ts)
    _check(name, tm, jm)
    for _ in range(3):
        delta = jax.tree.map(
            lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
            tree)
        js = jax.tree.map(lambda x, e: x + e, js, delta)
        for x, e in zip(tree_leaves(ts), tree_leaves(_t(delta))):
            x += e
        js, jm = jstrat.hub_with_state(js, jst, jm)
        ts, tm = tstrat.hub_with_state(ts, tst, tm)
        _check(name, ts, js)
        _check(name, tm, jm)
    if name in ("int8_ef", "int4_ef", "topk_ef", "powersgd"):
        ef = tm["ef"] if name == "powersgd" else tm
        assert any(bool(x.abs().max() > 0) for x in tree_leaves(ef))


def test_apply_schedule_with_state_threads_int8_ef_like_jax():
    """`apply_schedule_with_state` at two hub steps (4, 8) of W = 3 x 2,
    the int8_ef residuals threaded from the first call (fresh state from
    ``None``) into the second, against the JAX function; the state-free
    `apply_schedule` gives the first call's params (tests/test_protocol.py
    holds JAX's to the same)."""
    jcfg, tcfg, jst, tst = _states("int8_ef")
    rng = np.random.default_rng(3)
    trees = [_tree(rng, 6) for _ in range(2)]
    js, ts = jax.tree.map(jnp.asarray, trees[0]), _t(trees[0])
    jm = tm = None
    for step, tree in zip((4, 8), trees):
        if step == 8:          # a local change between the two hub rounds
            js = jax.tree.map(lambda x, e: x + 0.1 * e, js, tree)
            for x, e in zip(tree_leaves(ts), tree_leaves(_t(tree))):
                x += 0.1 * e
        else:
            stateless = tmll.apply_schedule(
                tree_map(torch.clone, ts), step, tcfg, tst)
        js, jm = jmll.apply_schedule_with_state(js, jm, jnp.asarray(step),
                                                jcfg, jst)
        ts, tm = tmll.apply_schedule_with_state(ts, tm, step, tcfg, tst)
        _check("int8_ef", ts, js)
        _check("int8_ef", tm, jm)
        if step == 4:
            for a, b in zip(tree_leaves(stateless), tree_leaves(ts)):
                assert torch.equal(a, b)
    assert any(bool(x.abs().max() > 0) for x in tree_leaves(tm))


@pytest.mark.parametrize("k", [1, 3, 32, 40])
def test_topk_ties_keep_the_lowest_index_like_jax(k):
    """All-ones rows (every RMSNorm scale at init) and rows of few distinct
    magnitudes: the kept entries are jax.lax.top_k's."""
    rng = np.random.default_rng(k)
    z = np.stack([np.ones(40, np.float32),
                  rng.integers(-3, 4, 40).astype(np.float32),
                  rng.choice([-2.0, 2.0, 0.5], 40).astype(np.float32)])
    want = np.asarray(jp._topk_sparsify(jnp.asarray(z), k))
    got = tp._topk_sparsify(torch.from_numpy(z), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, :k] == 1).all() and (got[0, k:] == 0).all()


@pytest.mark.parametrize("name", jp.available_mixing())
def test_wire_bytes_equal_the_reference_on_the_qwen3_smoke_spec(name):
    _, _, jst, tst = _states(d=2)
    jshapes = jax.eval_shape(lambda: jmodel.init_model(
        jax.random.PRNGKey(0), jax_smoke("qwen3-1.7b")))
    jstk = jax.tree.map(lambda x: jax.ShapeDtypeStruct((4,) + x.shape,
                                                       x.dtype), jshapes)
    params = tmodel.init_model(torch.Generator().manual_seed(0),
                               torch_smoke("qwen3-1.7b"), device="cpu")
    tstk = tree_map(lambda x: x.expand((4,) + tuple(x.shape)), params)
    want = jp.get_mixing(name).wire_bytes(jst, jpacking.pack_spec(jstk))
    assert tp.get_mixing(name).wire_bytes(tst, tp.wire_spec(tstk)) == want
    assert tp.wire_spec(tstk).total_cols == \
        tpacking.pack_spec(tstk).total_cols


def test_describe_mixing_is_the_reference_text():
    assert tp.describe_mixing() == jp.describe_mixing()


# ------------------------------------------ properties (the port alone)
def _exact_params(name, w):
    """tests/test_compression.py's per-worker-identical params whose shared
    value the strategy's wire carries exactly."""
    rng = np.random.default_rng(7)
    if name in ("int8", "int8_ef"):
        a = rng.integers(-127, 128, (5, 4)).astype(np.float32)
        b = rng.integers(-127, 128, (4,)).astype(np.float32)
        a[0, 0], b[0] = 127.0, 127.0
    elif name == "int4_ef":
        a = rng.integers(-7, 8, (5, 4)).astype(np.float32)
        b = rng.integers(-7, 8, (4,)).astype(np.float32)
        a[0, 0], b[0] = 7.0, 7.0
    elif name == "topk_ef":
        a = np.zeros((5, 4), np.float32)
        b = np.zeros((4,), np.float32)
        a[2, 1], b[3] = 3.0, -5.0
    elif name == "powersgd":
        a = np.outer(rng.integers(-4, 5, (5,)),
                     rng.integers(-4, 5, (4,))).astype(np.float32)
        b = rng.integers(-4, 5, (4,)).astype(np.float32)
    else:
        a = rng.integers(-8, 9, (5, 4)).astype(np.float32)
        b = rng.integers(-8, 9, (4,)).astype(np.float32)
    return tsim.replicate({"w": torch.from_numpy(a),
                           "b": torch.from_numpy(b)}, w)


def _pow2_state(rates=1.0):
    cfg = tmll.MLLConfig(tau=2, q=2, eta=0.1, hub_topology="ring",
                         worker_rates=rates)
    return tmll.build_state(cfg, tmll.build_network(cfg, 2, 4), device="cpu")


@pytest.mark.parametrize("name", tp.available_mixing())
def test_hub_round_fixed_point(name):
    """tests/test_compression.py:79 through the port: an all-equal state
    the wire carries exactly passes a hub round unchanged and leaves the
    residuals zero."""
    st = _pow2_state()
    stacked = _exact_params(name, 8)
    before = tree_map(torch.clone, stacked)
    strat = tp.get_mixing(name)
    out, state = strat.hub_with_state(stacked, st, strat.init_state(stacked))
    tol = 1e-5 if name == "powersgd" else 0.0
    for a, b in zip(tree_leaves(before), tree_leaves(out)):
        torch.testing.assert_close(b, a, atol=tol, rtol=0)
    ef = state["ef"] if name == "powersgd" else state
    for leaf in tree_leaves(ef):
        if leaf.numel():
            assert float(leaf.abs().max()) <= tol


@pytest.mark.parametrize("name", ["int8_ef", "int4_ef", "topk_ef",
                                  "powersgd"])
def test_ef_mixing_contracts_worker_spread(name):
    """tests/test_compression.py:103 through the port: repeated V + Z
    rounds halve the worker spread; the residual stays bounded."""
    st = _pow2_state(rates=(1.0, 0.9, 0.8, 1.0, 0.7, 1.0, 0.6, 0.9))
    rng = np.random.default_rng(3)
    stacked = {"w": torch.from_numpy(rng.standard_normal((8, 5, 4))
                                     .astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal((8, 4))
                                     .astype(np.float32))}

    def spread(t):
        return max(float((x - x.mean(0, keepdim=True)).abs().max())
                   for x in tree_leaves(t))
    strat = tp.get_mixing(name)
    state = strat.init_state(stacked)
    spread0 = spread(stacked)
    for _ in range(8):
        stacked, state = strat.subnet_with_state(stacked, st, state)
        stacked, state = strat.hub_with_state(stacked, st, state)
    assert spread(stacked) < 0.5 * spread0
    ef = state["ef"] if name == "powersgd" else state
    for leaf in tree_leaves(ef):
        assert float(leaf.abs().max()) < 2.0 * spread0


# ------------------------------------------------- every consumer vs JAX
@pytest.mark.parametrize("mixing", ["int4_ef", "topk_ef", "powersgd"])
def test_simulate_runs_the_ladder_like_the_reference(mixing):
    from repro.core import baselines as jbase
    from repro_torch.core import baselines as tbase
    kw = dict(tau=2, q=2, worker_rates=[1.0, 0.7, 0.9, 1.0, 0.5, 0.8])
    (jnet, jsched), (tnet, tsched) = (jbase.mll_sgd("ring", [2, 2, 2], **kw),
                                      tbase.mll_sgd("ring", [2, 2, 2], **kw))
    jd, jl, ja, ji = jax_task(6)
    td, tl, ta, ti = torch_task(6)
    cfg = dict(eta=0.1, batch_size=8, eval_every=4, mixing=mixing)
    jr = jsim.simulate(jl, ja, ji, jd.worker_data(), jd.full, jd.test, jnet,
                       jsched, steps=12, cfg=jsim.SimConfig(**cfg), seed=0)
    tr = tsim.simulate(tl, ta, ti, td.worker_data(), td.full, td.test, tnet,
                       tsched, steps=12, cfg=tsim.SimConfig(**cfg), seed=0,
                       device="cpu")
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, atol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tr.final_avg_params[k].numpy(),
                                   np.asarray(jr.final_avg_params[k]),
                                   atol=1e-5)
    assert tr.train_loss[-1] < tr.train_loss[0]


@pytest.mark.parametrize("mixing,policy", [
    ("int4_ef", "barrier"), ("topk_ef", "deadline"), ("powersgd", "barrier")])
def test_run_timeline_runs_the_ladder_like_the_reference(mixing, policy):
    jnet, tnet = _nets()
    data, loss_fn, acc_fn, init = jax_task(8, per_worker=128, seed=1)
    jr = jtl.run_timeline(loss_fn, acc_fn, init, data.worker_data(),
                          data.full, data.test, jnet, JSched(4, 2), slots=32,
                          policy=policy, cfg=jsim.SimConfig(
                              eta=0.1, batch_size=8, eval_every=16,
                              mixing=mixing),
                          seed=2, policy_rng=np.random.default_rng(11))
    tr = _run_port(tnet, policy, mixing=mixing)
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, atol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tr.final_avg_params[k].numpy(),
                                   np.asarray(jr.final_avg_params[k]),
                                   atol=1e-5)


def test_outer_hub_step_with_int8_ef_matches_reference():
    jcfg, tcfg, jst, tst = _states("int8_ef")
    rng = np.random.default_rng(4)
    stacked = {"w": rng.standard_normal((6, 5, 3)).astype(np.float32),
               "b": rng.standard_normal((6, 3)).astype(np.float32)}
    jx, tx = jax.tree.map(jnp.asarray, stacked), _t(stacked)
    jo, to = jouter.init_outer_state(jx, jcfg), touter.init_outer_state(
        tree_map(torch.clone, tx), tcfg)
    ocfg = dict(lr=0.7, beta=0.9)
    for _ in range(3):
        g = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in stacked.items()}
        jx = jax.tree.map(lambda x, e: x + e, jx, g)
        for k in g:
            tx[k] += torch.from_numpy(g[k])
        jx, jo = jouter.outer_hub_step(jx, jo, jcfg, jst,
                                       jouter.OuterConfig(**ocfg))
        tx, to = touter.outer_hub_step(tx, to, tcfg, tst,
                                       touter.OuterConfig(**ocfg))
        _check("int8_ef", tx, jx)
        _check("int8_ef", to, jo)
    assert any(bool(x.abs().max() > 0) for x in tree_leaves(to["mixing"]))


def _plan_pair(mixing, policy, slots, overlap="none", tau=2, seed=0,
               with_jax=True):
    kw = dict(tau=tau, q=2, eta=0.05, hub_topology="ring", mixing=mixing,
              worker_rates=(1.0, 0.8, 1.0, 0.6))
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jnet, tnet = jmll.build_network(jcfg, 2, 2), tmll.build_network(tcfg, 2, 2)
    jst_, tst_ = (jmll.build_state(jcfg, jnet),
                  tmll.build_state(tcfg, tnet, device="cpu"))
    jplan = jtl.get_policy(policy).plan(jnet, jcfg.schedule, slots,
                                        np.random.default_rng(0))
    tplan = ttl.get_policy(policy).plan(tnet, tcfg.schedule, slots,
                                        np.random.default_rng(0))
    stream = jpipe.make_token_stream(4, 400, vocab_size=512, seed=0)
    jparams = jmodel.init_model(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(1)
    jstk = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (4,) + x.shape)
        + 0.01 * jnp.asarray(rng.standard_normal((4,) + x.shape), x.dtype),
        jparams)
    tstk = _t(jax.tree.map(np.asarray, jstk))
    common = dict(eval_every=slots // 2, policy=policy, overlap=overlap,
                  **QUIET)
    jrun = jharness.run_plan(
        JCFG, jcfg, jnet, jst_, jplan, jpipe.LMBatcher(stream, 16, 2),
        np.random.default_rng(0), jp.init_train_state(jstk, cfg=jcfg),
        impl="xla", **common) if with_jax else None
    trun = tharness.run_plan(
        TCFG, tcfg, tnet, tst_, tplan, tpipe.LMBatcher(stream, 16, 2),
        np.random.default_rng(0), tp.init_train_state(tstk, cfg=tcfg),
        impl="flash", **common)
    return jrun, trun


def _assert_run_close(jrun, trun):
    for k in ("loss", "avg_loss"):
        np.testing.assert_allclose(trun.history[k], jrun.history[k], **TOL)
    got = _flat(trun.train_state.params)
    want = jckpt._flatten(jrun.train_state.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("mixing,policy", [("int8_ef", "gossip"),
                                           ("powersgd", "deadline")])
def test_harness_runs_the_ladder_like_the_reference(mixing, policy):
    """tests/test_harness.py:144 (gossip + int8_ef) and a deadline plan
    whose slot 4 is a powersgd hub round, 4 slots of the qwen3 smoke
    model, against the JAX harness."""
    jrun, trun = _plan_pair(mixing, policy, 4)
    assert np.isfinite(trun.history["avg_loss"]).all()
    _assert_run_close(jrun, trun)
    got = _flat(trun.train_state.mix_state)
    want = jckpt._flatten(jrun.train_state.mix_state)
    assert sorted(got) == sorted(want)
    for k in want:
        if got[k].size and "::q::" not in "::" + k:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_harness_chunked_overlap_matches_jax_and_none():
    """overlap="chunked" (4 chunks) over 4 deadline slots with a subnet
    and a hub event: the JAX chunked path within the trajectory
    tolerance, and the port's "none" within the reference's documented
    reduction-order change."""
    jrun, trun = _plan_pair("two_stage", "deadline", 4, overlap="chunked")
    _assert_run_close(jrun, trun)
    _, none = _plan_pair("two_stage", "deadline", 4, with_jax=False)
    for a, b in zip(tree_leaves(trun.train_state.params),
                    tree_leaves(none.train_state.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    net = tmll.build_network(tmll.MLLConfig(), 2, 2)
    st = tmll.build_state(tmll.MLLConfig(), net, device="cpu")
    for kw, match in ((dict(overlap="sometimes"), "unknown overlap"),
                      (dict(overlap="chunked", overlap_chunks=0), ">= 1"),
                      (dict(overlap="chunked", mesh=object()), "ONE device")):
        with pytest.raises(ValueError, match=match):
            tharness.TrainHarness(TCFG, tmll.MLLConfig(), st,
                                  gate_mode="bernoulli", **kw)
    for mll in (tmll.MLLConfig(mixing="int8_ef"),
                tmll.MLLConfig(mix_dtype="bfloat16")):
        with pytest.raises(ValueError, match="dense"):
            tharness.TrainHarness(TCFG, mll, st, gate_mode="bernoulli",
                                  overlap="chunked")


@pytest.mark.parametrize("chunks", [1, 3, 7])
def test_chunkwise_pack_equals_the_whole_buffer_bit_for_bit(chunks):
    """`chunked_apply_operator` / `chunked_update_mix` gather one chunk at
    a time; the whole-buffer form packs every column first.  Leaves of
    float32 and bfloat16 straddle the chunk boundaries."""
    rng = np.random.default_rng(chunks)
    tree = {"a": torch.from_numpy(rng.standard_normal((4, 300))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((4, 7, 11))
                                  .astype(np.float32)).bfloat16(),
            "c": [torch.from_numpy(rng.standard_normal((4, 130))
                                   .astype(np.float32)) for _ in range(2)]}
    grads = tree_map(lambda x: torch.from_numpy(rng.standard_normal(
        tuple(x.shape)).astype(np.float32)).to(x.dtype), tree)
    t = torch.from_numpy(rng.random((4, 4)).astype(np.float32))
    theta = torch.tensor([1.0, 0.0, 1.0, 1.0])
    spec = tpacking.pack_spec(tree)
    x, g = tpacking.pack(tree, spec), tpacking.pack(grads, spec)
    a = (theta * float(np.float32(0.1)))[:, None]
    mixed, fused = torch.empty_like(x), torch.empty_like(x)
    for ch in tpacking.chunk_views(spec, chunks):
        cols = slice(ch.lo, ch.hi)
        mixed[:, cols] = torch.einsum("ij,ic->jc", t, x[:, cols])
        fused[:, cols] = torch.einsum("ij,ic->jc", t,
                                      x[:, cols] - a * g[:, cols])
    want_mix = tpacking.unpack(mixed, spec)
    want_fused = tpacking.unpack(fused, spec)
    got_fused = ttl.chunked_update_mix(tree, grads, t, theta, 0.1, chunks)
    got_mix = ttl.chunked_apply_operator(tree, t, chunks)
    in_place = tree_map(torch.clone, tree)
    assert ttl.chunked_apply_operator(in_place, t, chunks,
                                      out=in_place) is in_place
    for want, got in ((want_mix, got_mix), (want_mix, in_place),
                      (want_fused, got_fused)):
        for w_, g_ in zip(tree_leaves(want), tree_leaves(got)):
            assert g_.dtype == w_.dtype
            assert torch.equal(g_, w_)


# ------------------------------------------------------------ checkpoints
def _loop(tmp_path, **kw):
    base = dict(steps=4, eval_every=2, seq_len=16, batch_per_worker=2,
                tokens_per_worker=600, checkpoint_dir=str(tmp_path / "ck"),
                checkpoint_every=2, device="cpu")
    return ttrain.TrainLoopConfig(**dict(base, **kw))


def _assert_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("mixing", ["int8_ef", "powersgd"])
def test_kill_resume_bit_identical_with_mixing_state(tmp_path, mixing):
    """tau = 1, q = 2: a hub round every second slot, so the kill point
    (slot 2) checkpoints a nonzero residual (and PowerSGD's factors)."""
    cfg = torch_smoke("qwen3-1.7b")
    mll = tmll.MLLConfig(tau=1, q=2, eta=0.05, hub_topology="ring",
                         mixing=mixing, worker_rates=(1.0, 0.8, 1.0, 0.6))
    full = ttrain.run_training(cfg, mll, _loop(tmp_path / "a"), **QUIET)
    ttrain.run_training(cfg, mll, _loop(tmp_path / "b", stop_slot=2),
                        **QUIET)
    ef = _flat(tckpt.restore_state(
        str(tmp_path / "b" / "ck"), full["train_state"])[0].mix_state)
    assert any(np.abs(v).max() > 0 for v in ef.values() if v.size)
    resumed = ttrain.run_training(cfg, mll, _loop(tmp_path / "b",
                                                  resume=True), **QUIET)
    assert resumed["history"]["avg_loss"] == full["history"]["avg_loss"][-1:]
    _assert_equal(resumed["train_state"], full["train_state"])


@pytest.mark.parametrize("mixing", ["int8_ef", "powersgd"])
def test_mixing_state_checkpoints_cross_both_ways(tmp_path, mixing):
    """A JAX checkpoint carrying a nonzero residual tree (and PowerSGD's
    factors, with the (W, 0) placeholders of vector leaves) restores into
    the port, and the port's into the JAX package, leaf for leaf."""
    kw = dict(tau=2, q=2, eta=0.05, hub_topology="ring", mixing=mixing)
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jnet = jmll.build_network(jcfg, 2, 2)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(2)
    jstk = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (4,) + x.shape)
        + 0.01 * jnp.asarray(rng.standard_normal((4,) + x.shape), x.dtype),
        jparams)
    js = jp.init_train_state(jstk, cfg=jcfg)
    params, mix = jp.get_mixing(mixing).hub_with_state(
        js.params, jmll.build_state(jcfg, jnet), js.mix_state)
    js = js._replace(params=params, mix_state=mix, step=jnp.int32(2))
    jdir = str(tmp_path / "jax")
    jckpt.save_state(jdir, js, slot=2)
    like = tp.init_train_state(
        tsim.replicate(tmodel.init_model(torch.Generator().manual_seed(5),
                                         TCFG, device="cpu"), 4), cfg=tcfg)
    ts, slot, _ = tckpt.restore_state(jdir, like)
    assert slot == 2
    want = interop.train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    _assert_equal(ts, want)
    if mixing == "powersgd":
        shapes = {tuple(x.shape) for x in tree_leaves(ts.mix_state["q"])}
        assert (4, 0) in shapes
    tdir = str(tmp_path / "port")
    tckpt.save_state(tdir, ts, slot=2)
    back, jslot, _ = jckpt.restore_state(tdir, js)
    assert jslot == 2
    got, ref = _flat(ts), jckpt._flatten(back)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
