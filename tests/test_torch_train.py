"""The port's production trainer against the JAX package's, on the CPU:
data, per-worker gradients, the plan-driven harness over 8 slots,
checkpoints in both directions, kill + resume, serving u_k, the CLI.

The model is qwen3-1.7b's smoke config (2 layers, d_model 256, 4 / 2
heads, head_dim 64) in float32, so the comparison is about the algorithm,
not bf16 rounding.  Params come from the JAX `init_model` and cross over
through `repro_torch.interop`; tokens come from the same numpy stream and
Generator on both sides; the Bernoulli gate is drawn bit for bit alike, so
no θ is injected.

Tolerances:
* per-worker gradients and losses, one step: atol 1e-5, rtol 1e-4 -- the
  frameworks sum in other orders through two layers and their backward;
* `run_plan` over 8 slots (losses, u_k): atol 1e-5, rtol 1e-4 -- those
  rounding differences pass through 8 SGD steps of eta 0.05, which do not
  amplify them at this size;
* within the port (kill + resume, checkpoint round trips): bit for bit.
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
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.core import mllsgd as tmll
from repro_torch.core import protocol as tp
from repro_torch.core import simulator as tsim
from repro_torch.core import timeline as ttl
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.launch import harness as tharness
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as tengine
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map

F32 = dict(param_dtype="float32", compute_dtype="float32")
JCFG = dataclasses.replace(jax_smoke("qwen3-1.7b"), **F32)
TCFG = dataclasses.replace(torch_smoke("qwen3-1.7b"), **F32)
TOL = dict(atol=1e-5, rtol=1e-4)
RATES = (1.0, 0.8, 1.0, 0.6)
MLL = dict(tau=2, q=2, eta=0.05, hub_topology="ring", worker_rates=RATES,
           mixing="two_stage")
QUIET = dict(log=lambda *a, **k: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_model(jax.random.PRNGKey(0), JCFG)


def _stacked(jparams, w=4, noise=0.0):
    """Both packages' (W, ...) fleets from the same JAX params; ``noise``
    makes the workers differ."""
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (w,) + x.shape),
                       jparams)
    if noise:
        leaves, tdef = jax.tree.flatten(jst)
        rng = np.random.default_rng(1)
        leaves = [x + noise * jnp.asarray(rng.standard_normal(x.shape),
                                          x.dtype) for x in leaves]
        jst = jax.tree.unflatten(tdef, leaves)
    return jst, interop.tree_from_numpy(jax.tree.map(np.asarray, jst), "cpu",
                                        worker_axis=True)


def _assert_close(port_tree, jax_tree, tol=TOL, worker_axis=True):
    got = interop.flatten(port_tree, worker_axis=worker_axis)
    want = jckpt._flatten(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _assert_equal(a, b, worker_axis=True):
    fa = interop.flatten(a, worker_axis=worker_axis)
    fb = interop.flatten(b, worker_axis=worker_axis)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_token_stream_and_batches_match_jax():
    """Same stream, same batches, same cursor after skip, same rng state."""
    stream = tpipe.make_token_stream(4, 300, vocab_size=512, seed=3)
    np.testing.assert_array_equal(
        stream, jpipe.make_token_stream(4, 300, vocab_size=512, seed=3))
    tb, jb = tpipe.LMBatcher(stream, 16, 2), jpipe.LMBatcher(stream, 16, 2)
    trng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        got, want = tb.sample(trng), jb.sample(jrng)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    tb.skip(trng, 2)
    jb.skip(jrng, 2)
    assert tpipe.rng_state(trng) == jpipe.rng_state(jrng)
    again = tpipe.rng_from_state(tpipe.rng_state(trng))
    np.testing.assert_array_equal(tb.sample(again)["tokens"].numpy(),
                                  np.asarray(jb.sample(jrng)["tokens"]))


def test_replicate_params_matches_jax_and_copies(jparams):
    """`launch.train.replicate_params`: the JAX function's stacked values
    (W = 3), as real copies: writing one worker leaves the others and the
    source untouched."""
    from repro.launch import train as jtrain
    tparams = interop.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    stacked = ttrain.replicate_params(tparams, 3)
    _assert_equal(stacked, interop.tree_from_numpy(jax.tree.map(
        np.asarray, jtrain.replicate_params(jparams, 3)), "cpu",
        worker_axis=True))
    leaf, src = tree_leaves(stacked)[0], tree_leaves(tparams)[0]
    leaf[0] += 1.0
    assert torch.equal(leaf[1], src) and not torch.equal(leaf[0], src)


def test_per_worker_grads_match_jax_vmap(jparams):
    """The port's worker loop through the flash-attention autograd Function
    (plain versions on CPU) against JAX's vmap(value_and_grad); the kernels'
    own gradients are held to JAX's Pallas backward in
    tests/test_torch_kernels.py."""
    jst, tst = _stacked(jparams, w=2, noise=0.02)
    stream = jpipe.make_token_stream(2, 200, vocab_size=512, seed=0)
    jbatch = jpipe.LMBatcher(stream, 16, 2).sample(np.random.default_rng(0))
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    jgrads, jm = jax.jit(functools.partial(
        jts.per_worker_grads, cfg=JCFG, impl="xla"))(jst, jbatch)
    tops.reset_launches()
    tgrads, tm = tts.per_worker_grads(tst, tbatch, TCFG, impl="flash")
    assert tops.flash_attention_bwd.launches == 0      # CPU: plain versions
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **TOL)
    _assert_close(tgrads, jgrads)


def _loss_grads(params, batch, remat):
    """loss_fn's value and gradients in the port (one worker, flash path:
    the plain versions on the CPU) under ``remat``."""
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    it = iter(leaves)
    wp = tree_map(lambda _: next(it), params)
    loss, _ = tts.loss_fn(wp, batch, TCFG, impl="flash", remat=remat)
    return loss.detach(), wp, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_bit_equal_and_match_jax(jparams, remat):
    """loss_fn under each remat: the port's value and gradients equal its
    own un-rematerialised ones bit for bit (the recomputation repeats the
    same CPU arithmetic), and JAX's under the same remat within TOL."""
    stream = jpipe.make_token_stream(1, 200, vocab_size=512, seed=4)
    jbatch = {k: v[0] for k, v in jpipe.LMBatcher(stream, 16, 2).sample(
        np.random.default_rng(0)).items()}
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    tparams = interop.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    base_loss, _, base = _loss_grads(tparams, tbatch, "none")
    loss, wp, grads = _loss_grads(tparams, tbatch, remat)
    assert torch.equal(loss, base_loss)
    for a, b in zip(grads, base, strict=True):
        assert torch.equal(a, b)
    jloss, jgrads = jax.value_and_grad(lambda p: jts.loss_fn(
        p, jbatch, JCFG, impl="xla", remat=remat)[0])(jparams)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    it = iter(grads)
    _assert_close(tree_map(lambda _: next(it), wp), jgrads,
                  worker_axis=False)


def test_remat_dots_saves_the_products_jax_saves():
    """``remat="dots"``: the selective policy saves the outputs of the
    products without batch dimensions -- the attention projections (an
    einsum's bmm over a batch of one) and the MLP's mm -- and recomputes
    the attention scores (a bmm over B x H x G); every product output
    JAX's ``checkpoint_dots_with_no_batch_dims`` keeps is among them."""
    from jax._src.ad_checkpoint import saved_residuals
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    b, s = 2, 16
    saved, recomputed = [], []

    def spy(ctx, op, *args, **kw):
        out = ttf._no_batch_dots(ctx, op, *args, **kw)
        if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default) and not ctx.is_recompute:
            a, w = args[-2], args[-1]
            n = a.shape[-2] * w.shape[-1] * (a.shape[0] if a.dim() == 3
                                            else 1)
            (saved if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
             else recomputed).append((op.__name__, n))
        return out

    tparams = tmodel.init_model(torch.Generator().manual_seed(0), TCFG,
                                device="cpu")
    blk = tparams["blocks"][0]
    x = torch.randn(b, s, TCFG.d_model, requires_grad=True)
    pos = tmodel._positions({}, TCFG, b, s, x.device)
    body = functools.partial(
        torch.utils.checkpoint.checkpoint, ttf.super_block_train,
        use_reentrant=False, context_fn=functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts, spy))
    y, _ = body(blk, x, TCFG, pos, "plain")
    y.sum().backward()
    h, hkv, hd = TCFG.n_heads, TCFG.n_kv_heads, TCFG.resolved_head_dim
    scores = b * h * s * s
    assert ("bmm.default", scores) in recomputed
    assert all(n != scores for _, n in saved)
    # q, k, v, o (einsum -> bmm over one), gate, up, down (mm)
    assert sorted(n for _, n in saved) == sorted(
        [b * s * h * hd, b * s * hkv * hd, b * s * hkv * hd,
         b * s * TCFG.d_model, b * s * TCFG.d_ff, b * s * TCFG.d_ff,
         b * s * TCFG.d_model])

    jblk = jax.tree.map(lambda a: a[0], jmodel.init_model(
        jax.random.PRNGKey(0), JCFG)["blocks"])
    jpos = jmodel.rope_mod.default_positions(JCFG, b, s)
    f = jax.checkpoint(lambda p, xx: jtf.super_block_train(
        p, xx, JCFG, jpos, "xla")[0].sum(),
        policy=jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims)
    kept = [int(np.prod(aval.shape)) for aval, why in
            saved_residuals(f, jblk, jnp.ones((b, s, JCFG.d_model)))
            if why.startswith("output of reduce_precision")]
    assert kept and all(n in [m for _, m in saved] for n in kept), kept


def _run_plan_pair(jparams, policy, rate_model, slots=8):
    kw = dict(MLL, mixing="two_stage")
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jnet, tnet = jmll.build_network(jcfg, 2, 2), tmll.build_network(tcfg, 2, 2)
    jst_, tst_ = (jmll.build_state(jcfg, jnet),
                  tmll.build_state(tcfg, tnet, device="cpu"))
    jplan = jtl.get_policy(policy).plan(jnet, jcfg.schedule, slots,
                                        np.random.default_rng(0),
                                        rate_model=rate_model)
    tplan = ttl.get_policy(policy).plan(tnet, tcfg.schedule, slots,
                                        np.random.default_rng(0),
                                        rate_model=rate_model)
    stream = jpipe.make_token_stream(4, 400, vocab_size=512, seed=0)
    jstk, tstk = _stacked(jparams)
    jrun = jharness.run_plan(
        JCFG, jcfg, jnet, jst_, jplan, jpipe.LMBatcher(stream, 16, 2),
        np.random.default_rng(0), jp.init_train_state(jstk, cfg=jcfg),
        eval_every=4, policy=policy, rate_model=rate_model, impl="xla",
        **QUIET)
    trun = tharness.run_plan(
        TCFG, tcfg, tnet, tst_, tplan, tpipe.LMBatcher(stream, 16, 2),
        np.random.default_rng(0), tp.init_train_state(tstk, cfg=tcfg),
        eval_every=4, policy=policy, rate_model=rate_model, impl="flash",
        **QUIET)
    return jrun, trun


@pytest.mark.parametrize("policy,rate_model", [
    ("deadline", "bernoulli"), ("barrier", "deterministic")])
def test_run_plan_matches_jax_over_8_slots(jparams, policy, rate_model):
    """8 slots of W = 2 x 2, two_stage mixing on a ring, tau = q = 2:
    the u_k and worker loss history and the final u_k and fleet agree."""
    jrun, trun = _run_plan_pair(jparams, policy, rate_model)
    assert trun.history["step"] == jrun.history["step"] == [4, 8]
    for k in ("loss", "avg_loss"):
        np.testing.assert_allclose(trun.history[k], jrun.history[k], **TOL)
    assert np.isfinite(trun.history["avg_loss"]).all()
    _assert_close(trun.avg_params, jrun.avg_params, worker_axis=False)
    _assert_close(trun.train_state.params, jrun.train_state.params)
    assert trun.train_state.opt_state["counts"].tolist() == \
        np.asarray(jrun.train_state.opt_state["counts"]).tolist()
    assert int(trun.train_state.step) == int(jrun.train_state.step) == 8


def _loop(tmp_path, **kw):
    base = dict(steps=8, eval_every=4, seq_len=16, batch_per_worker=2,
                tokens_per_worker=600, checkpoint_dir=str(tmp_path / "ck"),
                checkpoint_every=4, policy="barrier",
                rate_model="deterministic", device="cpu")
    return ttrain.TrainLoopConfig(**dict(base, **kw))


def test_kill_resume_bit_identical(tmp_path):
    """Killed at slot 4 (inside a straggler-padded barrier plan) and
    resumed = the uninterrupted run, bit for bit (bf16 smoke config)."""
    cfg = torch_smoke("qwen3-1.7b")
    mll = tmll.MLLConfig(**dict(MLL, inner_opt="momentum"))
    full = ttrain.run_training(cfg, mll, _loop(tmp_path / "a"), **QUIET)
    ttrain.run_training(cfg, mll, _loop(tmp_path / "b", stop_slot=4), **QUIET)
    resumed = ttrain.run_training(cfg, mll, _loop(tmp_path / "b",
                                                  resume=True), **QUIET)
    assert resumed["history"]["step"] == [8]
    assert resumed["history"]["avg_loss"] == full["history"]["avg_loss"][-1:]
    _assert_equal(resumed["train_state"], full["train_state"])
    _assert_equal(resumed["avg_params"], full["avg_params"],
                  worker_axis=False)
    assert full["avg_params"]["embed"]["table"].dtype == torch.float32
    with pytest.raises(ValueError, match="resume config mismatch"):
        ttrain.run_training(cfg, dataclasses.replace(mll, eta=0.1),
                            _loop(tmp_path / "b", resume=True), **QUIET)


def test_checkpoints_cross_restore_both_ways(jparams, tmp_path):
    """A JAX checkpoint (momentum state, bf16 and f32 leaves) restores in the
    port, and a port checkpoint restores in the JAX package, leaf for leaf;
    both packages' `load_u_k` read both."""
    kw = dict(MLL, inner_opt="momentum")
    jcfg = jmll.MLLConfig(**kw)
    jnet = jmll.build_network(jcfg, 2, 2)
    jstk, _ = _stacked(jparams, noise=0.01)
    jstk = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jstk)
    js = jp.init_train_state(jstk, cfg=jcfg)
    js = js._replace(step=jnp.int32(6), opt_state=dict(
        js.opt_state, counts=jnp.array([6, 4, 5, 3], jnp.int32)))
    plan = jtl.get_policy("deadline").plan(jnet, jcfg.schedule, 8,
                                           np.random.default_rng(0))
    extra = {"plan_config": jharness.plan_config(jcfg, jnet, plan,
                                                 "deadline", "bernoulli")}
    jdir = str(tmp_path / "jax")
    jckpt.save_state(jdir, js, slot=6, extra=extra)
    jckpt.save(jdir, jax.tree.map(lambda x: x[0], jstk), step=6)

    tcfg = dataclasses.replace(TCFG, param_dtype="bfloat16")
    skeleton = tmodel.init_model(torch.Generator().manual_seed(5), tcfg,
                                 device="cpu")
    like = tp.init_train_state(tsim.replicate(skeleton, 4),
                               cfg=tmll.MLLConfig(**kw))
    ts, slot, textra = tckpt.restore_state(jdir, like)
    assert slot == 6 and textra["plan_config"] == extra["plan_config"]
    _assert_equal(ts, interop.train_state_from_numpy(
        jax.tree.map(np.asarray, js), "cpu"))
    u_t = tengine.load_u_k(jdir, tcfg, device="cpu")
    u_j = jengine.load_u_k(jdir, dataclasses.replace(
        JCFG, param_dtype="bfloat16"))
    _assert_close(u_t, u_j, tol=dict(atol=0, rtol=0), worker_axis=False)

    # the port writes, the JAX package reads
    tdir = str(tmp_path / "port")
    tckpt.save_state(tdir, ts, slot=6, extra=extra)
    tckpt.save(tdir, u_t, step=6)
    back, jslot, _ = jckpt.restore_state(tdir, js)
    assert jslot == 6
    _assert_close(ts, back, tol=dict(atol=0, rtol=0))
    ju, _ = jckpt.restore(tdir, u_j)
    _assert_close(u_t, ju, tol=dict(atol=0, rtol=0), worker_axis=False)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tckpt.restore_state(tdir, like._replace(params=interop.tree_from_numpy(
            jax.tree.map(lambda x: np.asarray(x, np.float32), jstk), "cpu",
            worker_axis=True)))


def test_load_u_k_serves_the_trained_model(tmp_path):
    """`load_u_k` of a port run's checkpoint is the run's u_k, and
    `ServeEngine.from_checkpoint` answers requests from it."""
    loop = _loop(tmp_path, policy="deadline", rate_model="bernoulli",
                 checkpoint_every=0)
    out = ttrain.run_training(TCFG, tmll.MLLConfig(**MLL), loop, **QUIET)
    u = tengine.load_u_k(loop.checkpoint_dir, TCFG, device="cpu")
    _assert_equal(u, out["avg_params"], worker_axis=False)
    eng = tengine.ServeEngine.from_checkpoint(
        loop.checkpoint_dir, TCFG, tengine.EngineConfig(
            max_batch=2, block_size=4, num_blocks=16, max_len=32),
        device="cpu")
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(7, 10,
                                                          dtype=np.int32)]
    res = eng.run(tengine.poisson_arrivals(prompts, max_new=4, seed=0))
    assert sorted(res["outputs"]) == [0, 1]
    assert all(len(res["outputs"][i]) == len(p) + 4
               for i, p in enumerate(prompts))


def test_cli_main_runs(tmp_path, capsys):
    ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                 "--steps", "4", "--tau", "2", "--q", "2", "--topology",
                 "ring", "--mixing", "ppermute", "--rates", "1", "0.5", "1",
                 "0.5", "--seq-len", "16", "--batch", "2", "--eval-every",
                 "2", "--policy", "gossip", "--rate-model", "deterministic",
                 "--trace", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "final u_k loss" in out and "device=cpu" in out
    assert jtl.load_trace(str(tmp_path / "t.json"))["meta"]["policy"] == \
        "gossip"
    # the compression ladder trains through the CLI; 'list' describes it
    ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                 "--steps", "4", "--tau", "2", "--q", "2", "--topology",
                 "ring", "--mixing", "int8_ef", "--seq-len", "16",
                 "--batch", "2", "--eval-every", "4"])
    out = capsys.readouterr().out
    loss = float(out.split("final u_k loss: ")[1].split()[0])
    assert np.isfinite(loss)
    ttrain.main(["--mixing", "list"])
    assert capsys.readouterr().out.strip() == jp.describe_mixing()
    with pytest.raises(SystemExit):
        ttrain.main(["--mixing", "nope", "--device", "cpu"])


def test_cli_main_trains_xlstm(tmp_path, capsys):
    """The CLI trains xlstm-smoke (mLSTM + sLSTM, bf16 with float32 gate
    leaves) through the sLSTM scan's autograd Function (plain versions on
    the CPU), and resumes from its checkpoint."""
    args = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu", "--impl",
            "flash", "--steps", "4", "--tau", "2", "--q", "2", "--topology",
            "ring", "--mixing", "two_stage", "--rates", "1", "0.8", "1", "0.6",
            "--seq-len", "8", "--batch", "2", "--eval-every", "2",
            "--checkpoint-dir", str(tmp_path / "ck")]
    ttrain.main(args + ["--stop-slot", "2"])
    ttrain.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "arch=xlstm-smoke" in out and "resumed from slot 2" in out
    assert "final u_k loss" in out


def test_measure_worker_rates_shape_and_skew(monkeypatch):
    """Shape, max == 1 and skew scaling, on a fake clock that makes every
    measured step take exactly one second (no wall-clock ratios)."""
    _, tst = _stacked(jmodel.init_model(jax.random.PRNGKey(1), JCFG), w=4)
    batch = tpipe.LMBatcher(tpipe.make_token_stream(4, 200, vocab_size=512),
                            8, 1).sample(np.random.default_rng(0))
    ticks = iter(range(10**6))
    monkeypatch.setattr(tharness.time, "perf_counter",
                        lambda: float(next(ticks)))
    calib = tharness.measure_worker_rates(TCFG, tst, batch, reps=2,
                                          skew=(1.0, 2.0, 1.0, 4.0))
    assert calib.step_times == (1.0, 2.0, 1.0, 4.0)
    assert calib.rates.shape == (4,) and calib.rates.max() == 1.0
    np.testing.assert_array_equal(calib.rates, [1.0, 0.5, 1.0, 0.25])
    with pytest.raises(ValueError, match="skew"):
        tharness.measure_worker_rates(TCFG, tst, batch, skew=(1.0,))


def test_harness_guards():
    net = tmll.build_network(tmll.MLLConfig(), 2, 2)
    st = tmll.build_state(tmll.MLLConfig(), net, device="cpu")
    # a mesh must carry the axis the fleet is sharded on (JAX's message)
    with pytest.raises(ValueError, match="no 'workers' axis"):
        tharness.TrainHarness(TCFG, tmll.MLLConfig(), st,
                              gate_mode="bernoulli",
                              mesh=tmesh.Mesh((4, 1), ("model", "data")))
    # the chunked overlap's guards raise where the JAX package's raise
    with pytest.raises(ValueError, match="ONE device"):
        tharness.TrainHarness(TCFG, tmll.MLLConfig(), st,
                              gate_mode="bernoulli", mesh=object(),
                              overlap="chunked")
    with pytest.raises(ValueError, match="dense"):
        tharness.TrainHarness(TCFG, tmll.MLLConfig(mixing="int8_ef"), st,
                              gate_mode="bernoulli", overlap="chunked")
    with pytest.raises(ValueError, match="unknown impl"):
        tharness.TrainHarness(TCFG, tmll.MLLConfig(), st,
                              gate_mode="bernoulli", impl="xla")
    with pytest.raises(ValueError, match="not divisible by microbatch 2"):
        tts.per_worker_grads({}, {"labels": torch.zeros(4, 3, 8)}, TCFG,
                             microbatch=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.run_training(TCFG, tmll.MLLConfig(),
                                ttrain.TrainLoopConfig(steps=1), **QUIET)
