"""The port's xLSTM (mLSTM and sLSTM blocks, the xlstm-smoke model, its
training through the harness) against the JAX package's, on the CPU.

The model is xlstm-125m's smoke config (2 layers as one (mLSTM, sLSTM)
super-block, d_model 256, projection 512, 4 heads of 128, vocab 50304) in
float32, so the comparison is about the algorithm, not bf16 rounding.
Params come from the JAX initialisers and cross over through
`repro_torch.interop`; inputs are made from a seed with numpy.  The
port's ``impl="flash"`` runs the sLSTM scan's autograd Function, whose
plain versions run on CPU tensors; ``impl="plain"`` runs the cell loop;
both are held to the JAX ``"xla"`` scan.

Tolerances (`_close`): rtol 1e-4 and atol 1e-5 times the output's scale
(max |want|, at least 1) -- the two frameworks sum in other orders, through
up to 16 recurrent steps, and the mLSTM divides by its normaliser, so an
output of magnitude ~10 carries float32 rounding of ~1e-5:
* block outputs, states and their gradients;
* the whole model's loss and gradients, and `run_plan` over 4 slots
  (losses, u_k, fleet), as tests/test_torch_train.py holds qwen3;
* within the port (kill + resume, interop and checkpoint round trips of
  the mixed bf16 / float32 tree): bit for bit, each leaf in its dtype.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import mllsgd as jmll
from repro.core import protocol as jp
from repro.core import timeline as jtl
from repro.data import pipeline as jpipe
from repro.launch import harness as jharness
from repro.models import model as jmodel
from repro.models import xlstm as jx
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.core import mllsgd as tmll
from repro_torch.core import protocol as tp
from repro_torch.core import timeline as ttl
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.launch import harness as tharness
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as tx
from repro_torch.serve import engine as tengine
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map

F32 = dict(param_dtype="float32", compute_dtype="float32")
JCFG = dataclasses.replace(jax_smoke("xlstm-125m"), **F32)
TCFG = dataclasses.replace(torch_smoke("xlstm-125m"), **F32)
ATOL, RTOL = 1e-5, 1e-4
MLL = dict(tau=2, q=2, eta=0.05, hub_topology="ring",
           worker_rates=(1.0, 0.8, 1.0, 0.6), mixing="two_stage")
QUIET = dict(log=lambda *a, **k: None)
MIXED = ("w_if", "b_if", "w_gates", "r_gates", "b_gates")   # float32 leaves


def _close(got, want, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=RTOL,
                               err_msg=msg)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_model(jax.random.PRNGKey(0), JCFG)


def _port(tree):
    return interop.tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _block_params(init, seed):
    """One block's params from the JAX initialiser, b_* made non-zero so
    that their gradients carry the recurrence's."""
    p = init(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    for k in ("b_gates", "b_if"):
        if k in p:
            p[k] = p[k] + jnp.asarray(0.1 * rng.standard_normal(p[k].shape),
                                      jnp.float32)
    return p, _port(p)


def _x(b, l, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, l, JCFG.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x)


def _grads_pair(jfn, tfn, jp_, tp_, jx_, tx_):
    """(value, grads wrt params and x) of sum(out * w) on both sides."""
    w = np.random.default_rng(9).standard_normal(
        np.asarray(jfn(jp_, jx_)).shape).astype(np.float32)
    jval, jgrads = jax.value_and_grad(
        lambda p, x: (jfn(p, x) * jnp.asarray(w)).sum(), argnums=(0, 1))(
            jp_, jx_)
    leaves = {k: v.clone().requires_grad_() for k, v in tp_.items()}
    xx = tx_.clone().requires_grad_()
    tval = (tfn(leaves, xx) * torch.tensor(w)).sum()
    tgrads = torch.autograd.grad(tval, [*leaves.values(), xx])
    _close(float(tval.detach()), float(jval))
    for k, g in zip(leaves, tgrads):
        _close(g.numpy(), np.asarray(jgrads[0][k]), k)
    _close(tgrads[-1].numpy(), np.asarray(jgrads[1]), "x")


def test_mlstm_train_and_grads_match_jax():
    jp_, tp_ = _block_params(jx.init_mlstm, 3)
    jx_, tx_ = _x(2, 16)
    _close(tx.mlstm_train(tp_, tx_, TCFG).numpy(),
           np.asarray(jx.mlstm_train(jp_, jx_, JCFG)))
    _grads_pair(lambda p, x: jx.mlstm_train(p, x, JCFG),
                lambda p, x: tx.mlstm_train(p, x, TCFG), jp_, tp_, jx_, tx_)


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_slstm_train_and_grads_match_jax(impl):
    """Through the scan's autograd Function (flash) and the cell loop
    (plain), against the JAX lax.scan."""
    jp_, tp_ = _block_params(jx.init_slstm, 4)
    jx_, tx_ = _x(2, 13)
    tops.reset_launches()
    _close(tx.slstm_train(tp_, tx_, TCFG, impl=impl).numpy(),
           np.asarray(jx.slstm_train(jp_, jx_, JCFG, impl="xla")))
    _grads_pair(lambda p, x: jx.slstm_train(p, x, JCFG, impl="xla"),
                lambda p, x: tx.slstm_train(p, x, TCFG, impl=impl),
                jp_, tp_, jx_, tx_)
    assert tops.slstm_scan.launches == tops.slstm_scan_bwd.launches == 0


def test_slstm_train_rejects_unknown_impl():
    _, tp_ = _block_params(jx.init_slstm, 4)
    with pytest.raises(ValueError, match="unknown impl"):
        tx.slstm_train(tp_, _x(1, 2)[1], TCFG, impl="xla")


def _decode_pair(jinit, jstate, jdec, tinit, tstate, tdec):
    """Three decode steps from the initial state: outputs, states and the
    gradients of the summed outputs wrt the params."""
    jp_, tp_ = _block_params(jinit, 5)
    xs = [_x(2, 1, seed=10 + i) for i in range(3)]

    def jrun(p):
        st, outs = jstate(JCFG, 2), []
        for jx_, _ in xs:
            y, st = jdec(p, jx_, JCFG, st)
            outs.append(y)
        return jnp.stack(outs), st

    def trun(p):
        st, outs = tstate(TCFG, 2, torch.device("cpu")), []
        for _, tx_ in xs:
            y, st = tdec(p, tx_, TCFG, st)
            outs.append(y)
        return torch.stack(outs), st
    jy, jst = jrun(jp_)
    ty, tst = trun(tp_)
    _close(ty.numpy(), np.asarray(jy))
    for k in jst:
        _close(tst[k].numpy(), np.asarray(jst[k]), k)
    jg = jax.grad(lambda p: jrun(p)[0].sum())(jp_)
    leaves = {k: v.clone().requires_grad_() for k, v in tp_.items()}
    tg = torch.autograd.grad(trun(leaves)[0].sum(), list(leaves.values()))
    for k, g in zip(leaves, tg):
        _close(g.numpy(), np.asarray(jg[k]), k)


def test_mlstm_decode_matches_jax():
    _decode_pair(jx.init_mlstm, jx.init_mlstm_state, jx.mlstm_decode,
                 jx.init_mlstm, tx.init_mlstm_state, tx.mlstm_decode)


def test_slstm_decode_matches_jax():
    _decode_pair(jx.init_slstm, jx.init_slstm_state, jx.slstm_decode,
                 jx.init_slstm, tx.init_slstm_state, tx.slstm_decode)


def _batch(seed=0, b=2, s=16):
    tok = np.random.default_rng(seed).integers(1, 500, (b, s + 1)) \
        .astype(np.int32)
    jb = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
    return jb, {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_model_loss_and_grads_match_jax(jparams, impl):
    """The whole xlstm-smoke model (embedding, (mLSTM, sLSTM) with
    layernorms, untied LM head): loss and every gradient."""
    jb, tb = _batch()
    (jl, _), jg = jax.value_and_grad(
        lambda p: jts.loss_fn(p, jb, JCFG, impl="xla"), has_aux=True)(jparams)
    wp = tree_map(lambda x: x.requires_grad_(), _port(jparams))
    tl, _ = tts.loss_fn(wp, tb, TCFG, impl=impl)
    tg = torch.autograd.grad(tl, tree_leaves(wp))
    it = iter(tg)
    got = interop.flatten(tree_map(lambda x: next(it), wp))
    want = jckpt._flatten(jg)
    _close(float(tl.detach()), float(jl))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


def test_run_plan_matches_jax_over_4_slots(jparams):
    """4 slots of W = 2 x 2, two_stage mixing on a ring, tau = q = 2, the
    deadline policy: u_k and worker losses, the final u_k and fleet."""
    kw = dict(MLL)
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jnet, tnet = jmll.build_network(jcfg, 2, 2), tmll.build_network(tcfg, 2, 2)
    jst_ = jmll.build_state(jcfg, jnet)
    tst_ = tmll.build_state(tcfg, tnet, device="cpu")
    jplan = jtl.get_policy("deadline").plan(jnet, jcfg.schedule, 4,
                                            np.random.default_rng(0))
    tplan = ttl.get_policy("deadline").plan(tnet, tcfg.schedule, 4,
                                            np.random.default_rng(0))
    stream = jpipe.make_token_stream(4, 300, vocab_size=512, seed=0)
    jstk = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (4,) + x.shape),
                        jparams)
    tstk = interop.tree_from_numpy(jax.tree.map(np.asarray, jstk), "cpu",
                                   worker_axis=True)
    jrun = jharness.run_plan(
        JCFG, jcfg, jnet, jst_, jplan, jpipe.LMBatcher(stream, 12, 2),
        np.random.default_rng(0), jp.init_train_state(jstk, cfg=jcfg),
        eval_every=2, policy="deadline", rate_model="bernoulli", impl="xla",
        **QUIET)
    trun = tharness.run_plan(
        TCFG, tcfg, tnet, tst_, tplan, tpipe.LMBatcher(stream, 12, 2),
        np.random.default_rng(0), tp.init_train_state(tstk, cfg=tcfg),
        eval_every=2, policy="deadline", rate_model="bernoulli",
        impl="flash", **QUIET)
    assert trun.history["step"] == jrun.history["step"] == [2, 4]
    for k in ("loss", "avg_loss"):
        _close(trun.history[k], jrun.history[k])
    got = interop.flatten(trun.avg_params)
    want = jckpt._flatten(jrun.avg_params)
    for k in want:
        _close(got[k], want[k], k)
    got = interop.flatten(trun.train_state.params, worker_axis=True)
    want = jckpt._flatten(jrun.train_state.params)
    for k in want:
        _close(got[k], want[k], k)


def _loop(tmp_path, **kw):
    base = dict(steps=8, eval_every=4, seq_len=12, batch_per_worker=2,
                tokens_per_worker=400, checkpoint_dir=str(tmp_path / "ck"),
                checkpoint_every=4, policy="barrier",
                rate_model="deterministic", device="cpu")
    return ttrain.TrainLoopConfig(**dict(base, **kw))


def _assert_equal(a, b, worker_axis=True):
    fa = interop.flatten(a, worker_axis=worker_axis)
    fb = interop.flatten(b, worker_axis=worker_axis)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], k)


def test_kill_resume_bit_identical_xlstm(tmp_path):
    """xlstm-smoke (bf16 params beside float32 gate leaves), killed at slot
    4 and resumed = the uninterrupted run, bit for bit; every leaf keeps
    its dtype through the momentum updates, the mixing and the
    checkpoint."""
    cfg = torch_smoke("xlstm-125m")
    mll = tmll.MLLConfig(**dict(MLL, inner_opt="momentum"))
    full = ttrain.run_training(cfg, mll, _loop(tmp_path / "a"), **QUIET)
    ttrain.run_training(cfg, mll, _loop(tmp_path / "b", stop_slot=4), **QUIET)
    resumed = ttrain.run_training(cfg, mll, _loop(tmp_path / "b",
                                                  resume=True), **QUIET)
    assert resumed["history"]["avg_loss"] == full["history"]["avg_loss"][-1:]
    assert np.isfinite(full["history"]["avg_loss"]).all()
    _assert_equal(resumed["train_state"], full["train_state"])
    _assert_equal(resumed["avg_params"], full["avg_params"],
                  worker_axis=False)
    spec = interop.leaf_spec(full["train_state"].params, worker_axis=True)
    for key, (_, dtype) in spec.items():
        want = "float32" if key.split("::")[-1] in MIXED else "bfloat16"
        assert dtype == want, key
    inner = interop.leaf_spec(full["train_state"].opt_state["inner"],
                              worker_axis=True)
    assert {k.split("::")[-1]: d for k, (_, d) in inner.items()
            if k.split("::")[-1] in MIXED} == {k: "float32" for k in MIXED}


def test_interop_round_trip_of_a_mixed_dtype_tree(tmp_path):
    """A bf16 xlstm-smoke tree with float32 gate leaves: numpy -> port ->
    numpy bit for bit in each leaf's dtype, stacked and train-state
    variants included; a port checkpoint restores in the JAX package."""
    jcfg = jax_smoke("xlstm-125m")
    jp_ = jmodel.init_model(jax.random.PRNGKey(1), jcfg)
    npp = jax.tree.map(np.asarray, jp_)
    tpp = interop.params_from_numpy(npp, torch_smoke("xlstm-125m"),
                                    device="cpu")
    assert tpp["blocks"][0]["pos1"]["mixer"]["r_gates"].dtype == torch.float32
    assert tpp["blocks"][0]["pos1"]["mixer"]["w_up"].dtype == torch.bfloat16
    back = interop.params_to_numpy(tpp)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(npp)[0],
                               jax.tree_util.tree_flatten_with_path(back)[0]):
        assert a.dtype == b.dtype, kp
        np.testing.assert_array_equal(a, b, err_msg=str(kp))
    jstk = jax.tree.map(lambda x: jnp.stack([x, x + 1]), jp_)
    mcfg = jmll.MLLConfig(**dict(MLL, inner_opt="momentum"))
    js_ = jp.init_train_state(jstk, cfg=mcfg)
    ts = interop.train_state_from_numpy(jax.tree.map(np.asarray, js_), "cpu")
    tdir = str(tmp_path / "port")
    tckpt.save_state(tdir, ts, slot=3)
    back, slot, _ = jckpt.restore_state(tdir, js_)
    assert slot == 3
    for a, b in zip(jax.tree.leaves(js_), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serving_takes_attention_only_patterns():
    """Prefill and paged decode keep the JAX package's attention-only rule,
    for xLSTM and for jamba's mamba positions, which now initialise."""
    cfg = torch_smoke("xlstm-125m")
    params = tmodel.init_model(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="attention-only"):
        ttf.stack_prefill(params["blocks"], x, cfg, torch.zeros(1, 4))
    with pytest.raises(NotImplementedError, match="attention-only"):
        tmodel.init_paged_state(cfg, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        tengine.ServeEngine(params, cfg, tengine.EngineConfig(), device="cpu")
    jamba = torch_smoke("jamba-v0.1-52b")
    tmodel.init_model(torch.Generator(), jamba, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        tmodel.init_paged_state(jamba, 4, 4, device="cpu")
    skeleton = tmodel.param_skeleton(cfg)
    assert interop.leaf_spec(skeleton) == interop.leaf_spec(params)


def test_per_worker_grads_match_jax_vmap(jparams):
    """The port's worker loop (impl="flash": the scan's autograd Function,
    plain versions on the CPU) against JAX's vmap(value_and_grad)."""
    rng = np.random.default_rng(1)
    jst = jax.tree.map(lambda x: jnp.stack(
        [x, x + jnp.asarray(0.02 * rng.standard_normal(x.shape), x.dtype)]),
        jparams)
    tst = interop.tree_from_numpy(jax.tree.map(np.asarray, jst), "cpu",
                                  worker_axis=True)
    stream = jpipe.make_token_stream(2, 200, vocab_size=512, seed=0)
    jbatch = jpipe.LMBatcher(stream, 12, 2).sample(np.random.default_rng(0))
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    jgrads, jm = jax.jit(functools.partial(
        jts.per_worker_grads, cfg=JCFG, impl="xla"))(jst, jbatch)
    tgrads, tm = tts.per_worker_grads(tst, tbatch, TCFG, impl="flash")
    _close(tm["loss"].numpy(), np.asarray(jm["loss"]))
    got = interop.flatten(tgrads, worker_axis=True)
    want = jckpt._flatten(jgrads)
    for k in want:
        _close(got[k], want[k], k)
