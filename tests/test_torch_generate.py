"""The port's offline generation (`serve.serve_step`), its rotating dense
decode cache, chunked attention and the Gumbel / categorical draws against
the JAX package's, on the CPU.

Params come from the JAX `init_model` and cross over through
`repro_torch.interop`; prompts come from a numpy seed.  The models run in
float32 (qwen2-0.5b-smoke unless a test says otherwise; the JAX side plain
XLA), so the comparison is about the algorithm, not bf16 rounding.

Tolerances:
* generated tokens, greedy and sampled: equal.  Sampling draws the same
  bits as `jax.random.categorical` (the Gumbel noise is held bit for bit
  below), so only a near-tie of two logits within their float32 rounding
  differences could change a token;
* batched against loop prefill inside the port: equal tokens;
* the decode state after the batched prefill, decode logits, chunked
  attention: atol = rtol = 1e-4 -- the frameworks sum in other orders
  through two layers (qwen2-0.5b-smoke's tied logits reach ~170, and differ
  by ~1e-4 absolute);
* decode against the train forward inside the port (the sliding-window
  cache): atol = rtol = 2e-3, the JAX package's own test's tolerance;
* `core.prng.gumbel` and `log_f32` against `jax.random.gumbel` /
  `jnp.log`: every bit.
"""
import dataclasses

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
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serve import serve_step as jss
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.core import mllsgd as tmll
from repro_torch.core import prng
from repro_torch.core import protocol as tp
from repro_torch.core import timeline as ttl
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import harness as tharness
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.serve import serve_step as tss

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)
SEEDS = [0, 1, 42, 2**31 - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, which would
    compete with the JAX tests the other test workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="qwen2-0.5b", **kw):
    return (dataclasses.replace(jax_smoke(arch), **F32, **kw),
            dataclasses.replace(torch_smoke(arch), **F32, **kw))


def _params(jcfg, tcfg, seed=0):
    jparams = jmodel.init_model(jax.random.PRNGKey(seed), jcfg)
    return jparams, interop.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


@pytest.fixture(scope="module")
def qwen2():
    jcfg, tcfg = _cfgs()
    return (jcfg, tcfg) + _params(jcfg, tcfg)


def _prompt(cfg, b, n, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, n)).astype(np.int32)


# ------------------------------------------------------------- generation
# temperature 30 flattens the smoke model's logits (tied, up to ~170) so
# that the draws pick other tokens than greedy decoding would
@pytest.mark.parametrize("prefill", ["loop", "batched"])
@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3), (30.0, 5)])
def test_generate_matches_jax(qwen2, prefill, temperature, seed):
    jcfg, tcfg, jparams, tparams = qwen2
    pr = _prompt(jcfg, 2, 7)
    want = np.asarray(jss.generate(jparams, jnp.asarray(pr), jcfg, max_new=8,
                                   temperature=temperature, seed=seed,
                                   prefill=prefill))
    got = tss.generate(tparams, pr, tcfg, max_new=8, temperature=temperature,
                       seed=seed, prefill=prefill)
    assert got.dtype == torch.int64 and got.shape == (2, 15)
    np.testing.assert_array_equal(got.numpy(), want)
    if temperature == 30.0:
        greedy = tss.generate(tparams, pr, tcfg, max_new=8, prefill=prefill)
        assert not torch.equal(got, greedy), "the draws picked the argmax"


@pytest.mark.parametrize("temperature", [0.0, 30.0])
def test_batched_prefill_equals_loop_in_the_port(qwen2, temperature):
    """One batched forward fills the caches where the per-token loop would
    have, and burns the same key splits: the same tokens."""
    _, tcfg, _, tparams = qwen2
    for seed in (2, 4, 6):
        pr = _prompt(tcfg, 1, 5 + seed, seed=seed)
        kw = dict(max_new=8, temperature=temperature, seed=seed)
        loop = tss.generate(tparams, pr, tcfg, prefill="loop", **kw)
        batched = tss.generate(tparams, pr, tcfg, prefill="batched", **kw)
        assert torch.equal(loop, batched)


def test_generate_on_qwen3_with_qk_norm_matches_jax():
    """qwen3's qk-norm and untied head, sampled at a temperature that
    leaves its logits (~3) spread out."""
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    pr = _prompt(jcfg, 3, 6, seed=3)
    for kw in (dict(), dict(temperature=1.0, seed=9)):
        want = jss.generate(jparams, jnp.asarray(pr), jcfg, max_new=6, **kw)
        got = tss.generate(tparams, torch.from_numpy(pr), tcfg, max_new=6,
                           **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_prefill_state_matches_jax(qwen2):
    """`_batched_prefill`'s caches (k, v, positions, with max_len slots)
    and its advanced key against the JAX package's."""
    jcfg, tcfg, jparams, tparams = qwen2
    pr = _prompt(jcfg, 2, 9, seed=5)
    jstate, jkey = jss._batched_prefill(jparams, jnp.asarray(pr), jcfg, 16,
                                        jax.random.PRNGKey(7))
    tstate, tkey = tss._batched_prefill(
        tparams, torch.from_numpy(pr).long(), tcfg, 16, prng.prng_key(7))
    assert tkey == tuple(int(x) for x in np.asarray(jkey))
    got = interop.decode_state_to_numpy(tstate)
    assert jax.tree.structure(got) == jax.tree.structure(jstate)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert (got["pos0"]["pos"][:, :, :8] == np.arange(8)).all()
    assert (got["pos0"]["pos"][:, :, 8:] == -1).all()


def test_decode_state_round_trips_through_numpy(qwen2):
    jcfg, tcfg, jparams, _ = qwen2
    jstate = jmodel.init_decode_state(jcfg, 2, 12)
    jstate = jax.tree.map(
        lambda x: jnp.asarray(np.random.default_rng(0).standard_normal(
            x.shape)).astype(x.dtype), jstate)
    tstate = interop.decode_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    assert len(tstate) == tcfg.num_super_blocks
    back = interop.decode_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_sliding_window_cache_rotates():
    """window 6 over 16 positions: the buffer keeps 6 slots, decode equals
    the windowed train forward (and the JAX decode), and a batched prefill
    past the window leaves only the last 6 positions."""
    jcfg, tcfg = _cfgs("qwen3-1.7b", sliding_window=6)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    toks = _prompt(tcfg, 1, 16, seed=3)
    want, _ = tmodel.forward_train(tparams, {"tokens": torch.from_numpy(
        toks).long()}, tcfg, impl="plain")
    state = tmodel.init_decode_state(tcfg, 1, 16, device="cpu")
    assert state[0]["pos0"]["k"].shape[1] == 6
    jstate = jmodel.init_decode_state(jcfg, 1, 16)
    outs = []
    for t in range(16):
        lg, state = tmodel.decode_step(
            tparams, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])
                             .long()}, t, tcfg)
        jlg, jstate = jmodel.decode_step(
            jparams, jstate, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            jnp.asarray(t, jnp.int32), jcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want.numpy(),
                               atol=2e-3, rtol=2e-3)
    assert sorted(state[0]["pos0"]["pos"][0].tolist()) == list(range(10, 16))
    filled, _ = tss._batched_prefill(tparams, torch.from_numpy(toks).long(),
                                     tcfg, 16, prng.prng_key(0))
    assert sorted(filled[0]["pos0"]["pos"][0].tolist()) == list(range(9, 15))


# ------------------------------------------------------------------ raises
def test_serve_step_temperature_without_rng_raises(qwen2):
    _, tcfg, _, tparams = qwen2
    state = tmodel.init_decode_state(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="temperature.*rng"):
        tss.serve_step(tparams, state, {"tokens": torch.zeros(
            (1, 1), dtype=torch.long)}, 0, tcfg, temperature=0.7, rng=None)


def test_generate_guards(qwen2):
    _, tcfg, _, tparams = qwen2
    pr = np.ones((1, 6), np.int32)
    with pytest.raises(ValueError, match="max_len=9 cannot hold"):
        tss.generate(tparams, pr, tcfg, max_new=4, max_len=9)
    with pytest.raises(ValueError, match="unknown prefill"):
        tss.generate(tparams, pr, tcfg, max_new=2, prefill="eager")


def test_batched_prefill_rejected_for_recurrent_patterns():
    """jamba's mamba blocks cannot be prefilled in one forward: "batched"
    raises, "auto" falls back to the loop (and equals JAX's)."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jparams, tparams = _params(jcfg, tcfg)
    pr = np.ones((1, 6), np.int32)
    with pytest.raises(NotImplementedError, match="attention-only"):
        tss.generate(tparams, pr, tcfg, max_new=2, prefill="batched")
    out = tss.generate(tparams, pr, tcfg, max_new=2, prefill="auto")
    assert out.shape == (1, 8)
    want = jss.generate(jparams, jnp.asarray(pr), jcfg, max_new=2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# --------------------------------------------------------- gumbel, log
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_is_jax_random_gumbel_bit_for_bit(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape in ((1,), (7,), (3, 1000), (2, 5, 33), (70000,)):
        want = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
        got = prng.gumbel(tkey, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_is_jax_random_categorical(seed):
    """The argmax of noise plus logits, over rows of (B, V) logits at
    scales from flat to peaked, and a row with ties."""
    rng = np.random.default_rng(seed % 1000)
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for b, v, scale in ((1, 2, 1.0), (4, 512, 0.1), (4, 512, 3.0),
                        (3, 50000, 1.0), (2, 151936, 0.3)):
        logits = (scale * rng.standard_normal((b, v))).astype(np.float32)
        logits[0, : v // 2] = logits[0, 0]                  # ties
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits),
                                                 axis=-1))
        got = prng.categorical(tkey, torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        key, _ = jax.random.split(key)
        tkey, _ = prng.split(tkey)


def test_log_f32_is_xla_log_bit_for_bit():
    """XLA's float32 log on the CPU over (0, 1) (the Gumbel draw's two
    logs see u in [tiny, 1) and -log(u) in (0, 88]), wide exponents, and
    the neighbourhood of 1."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(200000, np.float32),
        np.float32(2.0) ** rng.uniform(-126, 127, 100000).astype(np.float32),
        np.float32(1.0) + rng.uniform(-1e-3, 1e-3, 50000).astype(np.float32),
        np.array([np.finfo(np.float32).tiny, 1.0, 2.0, 0.5, 88.0],
                 np.float32)]).astype(np.float32)
    x = x[x > 0]
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    got = prng.log_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------- chunked attention
def _qkv(b, t, h, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in
            ((b, t, h, hd), (b, t, hkv, hd), (b, t, hkv, hd))]


@pytest.mark.parametrize("t,block_q,window", [(21, 8, 0), (21, 8, 5),
                                              (24, 8, 0), (5, 8, 0),
                                              (40, 16, 7)])
def test_sdpa_chunked_matches_jax_and_plain(t, block_q, window):
    """T not a multiple of block_q (the last chunk padded), a window, and
    one chunk shorter than block_q."""
    jcfg, tcfg = _cfgs("qwen3-1.7b", sliding_window=window)
    q, k, v = _qkv(2, t, 4, 2, 16)
    want = np.asarray(jattn._sdpa_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
        block_q=block_q))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn._sdpa_chunked(tq, tk, tv, tcfg, block_q=block_q)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    mask = tattn.causal_mask(t, t, window)[None]
    plain = tattn._sdpa(tq, tk, tv, tcfg, mask)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["chunked", "auto"])
def test_attention_prefill_impl_choice(impl):
    """"chunked" runs `_sdpa_chunked`; "auto" runs it from 2,048 tokens on
    and the plain path below; both give JAX's output and k / v."""
    jcfg, tcfg = _cfgs("qwen2-0.5b")
    jparams, tparams = _params(jcfg, tcfg)
    jblk = jax.tree.map(lambda x: x[0], jparams["blocks"]["pos0"]["mixer"])
    tblk = tparams["blocks"][0]["pos0"]["mixer"]
    x = np.random.default_rng(0).standard_normal((1, 2050, jcfg.d_model),
                                                 np.float32) * 0.1
    for s in (2050, 100):
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (1, 1, s))
        want = jattn.attention_prefill(jblk, jnp.asarray(x[:, :s]), jcfg,
                                       jnp.asarray(pos), impl)
        got = tattn.attention_prefill(tblk, torch.from_numpy(x[:, :s]), tcfg,
                                      torch.from_numpy(pos.copy()), impl)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError, match="unknown impl"):
        tattn.check_impl("xla")
    with pytest.raises(ValueError, match="unknown impl"):
        tattn.check_impl("chunked", tattn.KERNEL_IMPLS)


@pytest.mark.parametrize("impl", ["chunked", "auto"])
def test_harness_trains_with_chunked_and_auto(impl):
    """4 slots of W = 2 x 2 through both harnesses with the chunked and
    auto attention choices (the JAX harness accepts them): the same u_k
    loss history at the run_plan tolerance of tests/test_torch_train.py."""
    jcfg_m, tcfg_m = _cfgs("qwen3-1.7b")
    jparams, _ = _params(jcfg_m, tcfg_m)
    kw = dict(tau=2, q=2, eta=0.05, hub_topology="ring",
              worker_rates=(1.0, 0.8, 1.0, 0.6), mixing="two_stage")
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jnet, tnet = jmll.build_network(jcfg, 2, 2), tmll.build_network(tcfg, 2, 2)
    jst, tst = (jmll.build_state(jcfg, jnet),
                tmll.build_state(tcfg, tnet, device="cpu"))
    jplan = jtl.get_policy("deadline").plan(jnet, jcfg.schedule, 4,
                                            np.random.default_rng(0))
    tplan = ttl.get_policy("deadline").plan(tnet, tcfg.schedule, 4,
                                            np.random.default_rng(0))
    stream = jpipe.make_token_stream(4, 400, vocab_size=512, seed=0)
    jstk = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (4,) + x.shape),
                        jparams)
    tstk = interop.tree_from_numpy(jax.tree.map(np.asarray, jstk), "cpu",
                                   worker_axis=True)
    quiet = dict(log=lambda *a, **k: None)
    jrun = jharness.run_plan(
        jcfg_m, jcfg, jnet, jst, jplan, jpipe.LMBatcher(stream, 16, 2),
        np.random.default_rng(0), jp.init_train_state(jstk, cfg=jcfg),
        eval_every=2, impl=impl, **quiet)
    trun = tharness.run_plan(
        tcfg_m, tcfg, tnet, tst, tplan, tpipe.LMBatcher(stream, 16, 2),
        np.random.default_rng(0), tp.init_train_state(tstk, cfg=tcfg),
        eval_every=2, impl=impl, **quiet)
    assert trun.history["step"] == jrun.history["step"] == [2, 4]
    assert np.isfinite(trun.history["avg_loss"]).all()
    for k in ("loss", "avg_loss"):
        np.testing.assert_allclose(trun.history[k], jrun.history[k],
                                   atol=1e-5, rtol=1e-4)
