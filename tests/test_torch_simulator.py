"""The port's simulator (`repro_torch.core.simulator`), baselines and outer
optimizer against the JAX package's, on the CPU.

`simulate` runs the logistic-regression task of the JAX package's own
simulator tests (tests/test_protocol.py `_sim_task`) from the same numpy
data; the port draws the same batch indices and gates (`core.prng`), so
nothing is injected.  Tolerance: the u_k losses and the final u within
atol 1e-5 (float32 gradients of two frameworks, accumulated over the
run).  The outer optimizer's single steps: atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import mllsgd as jmll
from repro.core import outer as jouter
from repro.core import simulator as jsim
from repro.data.pipeline import make_classification as jmake
from repro_torch import interop
from repro_torch.core import baselines as tbase
from repro_torch.core import mllsgd as tmll
from repro_torch.core import outer as touter
from repro_torch.core import protocol as tprotocol
from repro_torch.core import simulator as tsim
from repro_torch.core.hierarchy import MLLSchedule
from repro_torch.data.pipeline import make_classification as tmake
from repro_torch.tree import tree_leaves

ATOL = 1e-5


def jax_task(n, per_worker=64, dim=8, classes=3, test=64, seed=0):
    data = jmake(n, per_worker, dim=dim, num_classes=classes, test_size=test,
                 seed=seed)

    def loss_fn(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, b["y"][:, None], axis=1)[:, 0]
        return (lse - gold).mean()

    def acc_fn(p, b):
        pred = jnp.argmax(b["x"] @ p["w"] + p["b"], -1)
        return (pred == b["y"]).astype(jnp.float32).mean()

    init = {"w": jnp.zeros((dim, classes)), "b": jnp.zeros((classes,))}
    return data, loss_fn, acc_fn, init


def torch_task(n, per_worker=64, dim=8, classes=3, test=64, seed=0):
    data = tmake(n, per_worker, dim=dim, num_classes=classes, test_size=test,
                 seed=seed)

    def loss_fn(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, b["y"].long()[:, None])[:, 0]
        return (lse - gold).mean()

    def acc_fn(p, b):
        pred = (b["x"] @ p["w"] + p["b"]).argmax(-1)
        return (pred == b["y"]).float().mean()

    init = {"w": torch.zeros(dim, classes), "b": torch.zeros(classes)}
    return data, loss_fn, acc_fn, init


def _both(jnet_sched, tnet_sched, steps, seed=0, **cfg):
    (jnet, jsched), (tnet, tsched) = jnet_sched, tnet_sched
    jd, jl, ja, ji = jax_task(jnet.num_workers)
    td, tl, ta, ti = torch_task(tnet.num_workers)
    jr = jsim.simulate(jl, ja, ji, jd.worker_data(), jd.full, jd.test, jnet,
                       jsched, steps=steps, cfg=jsim.SimConfig(**cfg),
                       seed=seed)
    tr = tsim.simulate(tl, ta, ti, td.worker_data(), td.full, td.test, tnet,
                       tsched, steps=steps, cfg=tsim.SimConfig(**cfg),
                       seed=seed, device="cpu")
    return jr, tr


def _assert_result_close(jr, tr, atol=ATOL):
    np.testing.assert_array_equal(tr.steps, jr.steps)
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, atol=atol)
    np.testing.assert_allclose(tr.test_acc, jr.test_acc, atol=atol)
    for k in ("w", "b"):
        np.testing.assert_allclose(tr.final_avg_params[k].numpy(),
                                   np.asarray(jr.final_avg_params[k]),
                                   atol=atol)


def test_classification_data_is_the_reference_draw():
    jd, td = jmake(3, 20, dim=5, num_classes=4, test_size=7, seed=4), \
        tmake(3, 20, dim=5, num_classes=4, test_size=7, seed=4)
    for a, b in ((td.worker_x, jd.worker_x), (td.worker_y, jd.worker_y),
                 (td.test_x, jd.test_x), (td.test_y, jd.test_y),
                 (td.full["x"], jd.full["x"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    shares = np.array([0.05, 0.25, 0.7])
    js = jmake(3, 20, dim=5, seed=1, shares=shares)
    ts = tmake(3, 20, dim=5, seed=1, shares=shares)
    np.testing.assert_array_equal(ts.worker_y.numpy(), np.asarray(js.worker_y))


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_simulate_matches_reference(kernel):
    args = ("ring", [2, 2])
    kw = dict(tau=2, q=2, worker_rates=[1.0, 0.7, 0.9, 1.0])
    jr, tr = _both(jbase.mll_sgd(*args, **kw), tbase.mll_sgd(*args, **kw),
                   steps=12, eta=0.1, batch_size=8, eval_every=4,
                   kernel=kernel)
    _assert_result_close(jr, tr)


@pytest.mark.parametrize("mixing,inner_opt", [
    ("two_stage", "sgd"), ("ppermute", "sgd"), ("dense", "momentum"),
    ("two_stage", "adamw")])
def test_simulate_mixing_and_inner_opt_axes_match_reference(mixing,
                                                            inner_opt):
    args = ("ring", [2, 2, 2])
    kw = dict(tau=2, q=2, worker_rates=[1.0, 0.7, 0.9, 1.0, 0.5, 0.8])
    jr, tr = _both(jbase.mll_sgd(*args, **kw), tbase.mll_sgd(*args, **kw),
                   steps=8, seed=3, eta=0.05, batch_size=8, eval_every=4,
                   mixing=mixing, inner_opt=inner_opt)
    _assert_result_close(jr, tr)
    assert tr.train_loss[-1] < tr.train_loss[0]


BAD_CONFIGS = [dict(kernel="pallas", inner_opt="momentum"),
               dict(kernel="pallas", mixing="two_stage"),
               dict(kernel="pallas", mix_dtype="bfloat16"),
               dict(kernel="warp"),
               dict(overlap="chunked", inner_opt="momentum"),
               dict(overlap="chunked", overlap_chunks=0),
               dict(overlap="sideways"),
               dict(kernel="pallas", mixing="dense"),
               dict(overlap="chunked", mixing="two_stage")]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_kernel_and_overlap_guards_raise_as_in_the_reference(kw):
    for structured_ok in (False, True):
        outcomes = []
        for mod in (jsim, tsim):
            cfg = mod.SimConfig(**kw)
            try:
                mod._check_kernel(cfg, structured_ok=structured_ok)
                mod._check_overlap(cfg)
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]


def test_simconfig_fields_cross_unchanged():
    jf = [(f.name, f.default) for f in dataclasses.fields(jsim.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsim.SimConfig)]
    assert tf == jf
    assert list(tsim._phase_ids(MLLSchedule(3, 2), 4, 9)) == \
        list(jsim._phase_ids(jbase.mll_sgd("ring", [2], 3, 2)[1], 4, 9))


def test_unequal_subnets_require_dense():
    net, sched = tbase.mll_sgd("ring", [3, 2], tau=2, q=2)
    data, loss_fn, acc_fn, init = torch_task(net.num_workers)
    r = tsim.simulate(loss_fn, acc_fn, init, data.worker_data(), data.full,
                      data.test, net, sched, steps=4, device="cpu",
                      cfg=tsim.SimConfig(eta=0.1, batch_size=8, eval_every=4))
    assert np.isfinite(r.train_loss).all()
    with pytest.raises(ValueError, match="equal-size"):
        tsim.simulate(loss_fn, acc_fn, init, data.worker_data(), data.full,
                      data.test, net, sched, steps=4, device="cpu",
                      cfg=tsim.SimConfig(eta=0.1, batch_size=8, eval_every=4,
                                         mixing="two_stage"))


def test_sim_carry_crosses_both_ways_and_continues_like_the_reference():
    """A JAX carry after 5 steps, carried into the port, runs the next 6
    steps as the JAX package does (same draws from the carried key)."""
    jnet, jsched = jbase.mll_sgd("ring", [2, 2], tau=2, q=2,
                                 worker_rates=[1.0, 0.6, 0.9, 1.0])
    tnet, _ = tbase.mll_sgd("ring", [2, 2], tau=2, q=2,
                            worker_rates=[1.0, 0.6, 0.9, 1.0])
    jd, jl, _, ji = jax_task(4)
    td, tl, _, _ = torch_task(4)
    cfg = dict(eta=0.1, batch_size=8, inner_opt="momentum")
    jstep = jsim.make_step_fn(jl, jnet, jsim.SimConfig(**cfg))
    carry = jsim.init_sim_carry(jsim.replicate(ji, 4), jsim.SimConfig(**cfg),
                                seed=7)
    carry = jstep(carry, jd.worker_data(),
                  jnp.asarray(jsim._phase_ids(jsched, 0, 5)))
    npy = jax.tree.map(np.asarray, carry)
    tcarry = interop.sim_carry_from_numpy(npy, "cpu")
    assert tcarry[3] == tuple(int(k) for k in np.asarray(carry[3]))
    back = interop.sim_carry_to_numpy(tcarry)
    for a, b in zip(jax.tree.leaves(npy), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ops_ids = jsim._phase_ids(jsched, 5, 6)
    jout = jstep(carry, jd.worker_data(), jnp.asarray(ops_ids))
    tstep = tsim.make_step_fn(tl, tnet, tsim.SimConfig(**cfg), device="cpu")
    tout = tstep(tcarry, td.worker_data(), ops_ids)
    got = interop.sim_carry_to_numpy(tout)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(
            jax.tree.map(np.asarray, jout))):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_baselines_are_the_reference_networks():
    pairs = [(jbase.distributed_sgd(8), tbase.distributed_sgd(8)),
             (jbase.local_sgd(6, tau=4), tbase.local_sgd(6, tau=4)),
             (jbase.hl_sgd([2, 3], tau=2, q=3), tbase.hl_sgd([2, 3], tau=2,
                                                             q=3)),
             (jbase.mll_sgd("path", [2, 2, 2], 3, 2, worker_rates=[.5] * 6),
              tbase.mll_sgd("path", [2, 2, 2], 3, 2, worker_rates=[.5] * 6)),
             (jbase.async_local_sgd(5, 8), tbase.async_local_sgd(5, 8)),
             (jbase.gossip_sgd(6, 4), tbase.gossip_sgd(6, 4))]
    for j, t in pairs:
        (jn, js), (tn, ts) = j[:2], t[:2]
        assert j[2:] == t[2:]
        assert (ts.tau, ts.q) == (js.tau, js.q)
        np.testing.assert_array_equal(tn.z_matrix(), jn.z_matrix())
        np.testing.assert_array_equal(tn.a, jn.a)
    for name in ("distributed_sgd", "local_sgd", "hl_sgd", "mll_sgd"):
        jc = jbase.protocol_config(name, mixing="two_stage")
        tc = tbase.protocol_config(name, mixing="two_stage")
        assert (tc.tau, tc.q, tc.hub_topology, tc.worker_rates, tc.mixing) \
            == (jc.tau, jc.q, jc.hub_topology, jc.worker_rates, jc.mixing)
    with pytest.raises(ValueError, match="unknown baseline"):
        tbase.protocol_config("nope")


def _outer_setup(mixing="dense"):
    kw = dict(tau=2, q=2, hub_topology="ring", mixing=mixing)
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jn, tn = jmll.build_network(jcfg, 3, 2), tmll.build_network(tcfg, 3, 2)
    rng = np.random.default_rng(0)
    base = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    stacked = {k: (np.broadcast_to(v, (6,) + v.shape)
                   + 0.05 * rng.standard_normal((6,) + v.shape)
                   ).astype(np.float32) for k, v in base.items()}
    return (jcfg, tcfg, jmll.build_state(jcfg, jn),
            tmll.build_state(tcfg, tn, device="cpu"), base, stacked)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("mixing", ["dense", "two_stage"])
def test_outer_lr1_beta0_reduces_to_the_paper_hub_step(mixing):
    jcfg, tcfg, jst, tst, _, stacked = _outer_setup(mixing)
    x = _t(stacked)
    outer = touter.init_outer_state(x, tcfg)
    new, new_outer = touter.outer_hub_step(
        _t(stacked), outer, tcfg, tst, touter.OuterConfig(lr=1.0, beta=0.0))
    want = tprotocol.get_mixing(mixing).hub(_t(stacked), tst)
    for k in stacked:
        torch.testing.assert_close(new[k], want[k], atol=1e-6, rtol=0)
        assert torch.equal(new_outer["anchor"][k], new[k])
        assert new_outer["anchor"][k].data_ptr() != new[k].data_ptr()
    assert new_outer["mixing"] == ()
    # and the reference's outer step from the same state
    jnew, _ = jouter.outer_hub_step(jax.tree.map(jnp.asarray, stacked),
                                    jouter.init_outer_state(
                                        jax.tree.map(jnp.asarray, stacked)),
                                    jcfg, jst, jouter.OuterConfig(1.0, 0.0))
    for k in stacked:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   atol=1e-6)


def test_outer_train_step_matches_reference_through_every_phase():
    jcfg, tcfg, jst, tst, base, stacked = _outer_setup()
    ocfg = dict(lr=0.5, beta=0.9)
    rep = {k: np.broadcast_to(v, (6,) + v.shape).copy()
           for k, v in base.items()}
    jx, jo = jax.tree.map(jnp.asarray, stacked), jouter.init_outer_state(
        jax.tree.map(jnp.asarray, rep))
    tx, to = _t(stacked), touter.init_outer_state(_t(rep))
    rng = np.random.default_rng(5)
    for step in range(1, 9):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in stacked.items()}
        jx, jo = jouter.mll_outer_train_step(
            jx, jo, jax.tree.map(jnp.asarray, g), jnp.asarray(step), jcfg,
            jst, jouter.OuterConfig(**ocfg))
        tx, to = touter.mll_outer_train_step(
            tx, to, _t(g), step, tcfg, tst, touter.OuterConfig(**ocfg))
        for k in stacked:
            np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                       atol=1e-5, err_msg=f"{step} {k}")
            np.testing.assert_allclose(to["momentum"][k].numpy(),
                                       np.asarray(jo["momentum"][k]),
                                       atol=1e-5)
    assert sum(float(m.abs().sum()) for m in tree_leaves(to["momentum"])) > 0
    # a compressed rung through the outer hub step, as in the JAX package
    # (int8 is stateless); a stateful rung without its state raises
    ocfg8 = dict(lr=0.7, beta=0.9)
    jx, jo = jouter.outer_hub_step(jx, jo,
                                   dataclasses.replace(jcfg, mixing="int8"),
                                   jst, jouter.OuterConfig(**ocfg8))
    tx, to = touter.outer_hub_step(tx, to,
                                   dataclasses.replace(tcfg, mixing="int8"),
                                   tst, touter.OuterConfig(**ocfg8))
    for k in stacked:
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                   atol=1e-5, err_msg=f"int8 {k}")
    with pytest.raises(ValueError, match="stateful"):
        touter.outer_hub_step(tx, to,
                              dataclasses.replace(tcfg, mixing="int8_ef"),
                              tst, touter.OuterConfig())


def test_paper_claim_heterogeneous_rates_still_converge():
    """tests/test_convergence_paper.py `test_heterogeneous_rates_still_
    converge` through the port: workers with p in [0.6, 1.0] drive the
    loss of u_k below 0.55x its first value, test accuracy above 0.8."""
    rates = list(np.linspace(0.6, 1.0, 8))
    net, _ = tbase.mll_sgd("ring", [4, 4], tau=4, q=2, worker_rates=rates)
    data, loss_fn, acc_fn, init = torch_task(8, per_worker=512, dim=16,
                                             classes=4, test=512)
    res = tsim.simulate(loss_fn, acc_fn, init, data.worker_data(), data.full,
                        data.test, net, MLLSchedule(tau=4, q=2), steps=768,
                        cfg=tsim.SimConfig(eta=0.1, batch_size=16), seed=0,
                        device="cpu")
    assert res.train_loss[-1] < 0.55 * res.train_loss[0]
    assert res.test_acc[-1] > 0.8


def test_transformer_tree_through_run_timeline_matches_reference():
    """The qwen2-0.5b smoke transformer (float32) as a simulator task: the
    JAX package's parameters carried through `interop` (stacked blocks ->
    per-layer list, so the packed column orders differ), 4 deadline slots
    with two_stage mixing on the fused kernel path, the same draws.
    Tolerance: u within atol 1e-5 of the reference (|u| <= ~2), the loss
    within rtol 1e-6."""
    from repro.configs.registry import get_smoke_config as jget
    from repro.core import timeline as jtl
    from repro.models import model as jmodel
    from repro.train import train_step as jts
    from repro_torch.configs.registry import get_smoke_config as tget
    from repro_torch.core import timeline as ttl
    from repro_torch.train import train_step as tts

    f32 = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(jget("qwen2-0.5b"), **f32)
    tcfg = dataclasses.replace(tget("qwen2-0.5b"), **f32)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 8, 17)).astype(np.int32)

    def jloss(p, b):
        t = b["tokens"]
        return jts.loss_fn(p, {"tokens": t[:, :-1], "labels": t[:, 1:]},
                           jcfg, impl="xla")[0]

    def tloss(p, b):
        t = b["tokens"]
        return tts.loss_fn(p, {"tokens": t[:, :-1], "labels": t[:, 1:]},
                           tcfg, impl="plain")[0]
    net_args = ("ring", [2, 2], 2, 2)
    rates = dict(worker_rates=[1.0, 0.8, 1.0, 0.6])
    cfg = dict(eta=0.05, batch_size=2, eval_every=4, mixing="two_stage",
               kernel="pallas")
    jnet, jsched = jbase.mll_sgd(*net_args, **rates)
    tnet, tsched = tbase.mll_sgd(*net_args, **rates)
    ev = tokens[0, :2]
    jr = jtl.run_timeline(jloss, jloss, jparams,
                          {"tokens": jnp.asarray(tokens)},
                          {"tokens": jnp.asarray(ev)},
                          {"tokens": jnp.asarray(ev)}, jnet, jsched, slots=4,
                          policy="deadline", cfg=jsim.SimConfig(**cfg),
                          seed=0)
    tr = ttl.run_timeline(tloss, tloss, tparams,
                          {"tokens": torch.from_numpy(tokens)},
                          {"tokens": torch.from_numpy(ev)},
                          {"tokens": torch.from_numpy(ev)}, tnet, tsched,
                          slots=4, policy="deadline",
                          cfg=tsim.SimConfig(**cfg), seed=0, device="cpu")
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, rtol=1e-6)
    got = interop.params_to_numpy(tr.final_avg_params)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jr.final_avg_params))):
        np.testing.assert_allclose(a, b, atol=1e-5)
