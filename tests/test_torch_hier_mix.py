"""The fused gated-SGD + averaging kernels' plain versions (K1 dense, K2
grouped, K5 chunked; `repro_torch.kernels.ref` behind
`repro_torch.kernels.ops`) against the JAX package's Pallas kernels
(`repro.kernels.hier_mix`) in interpret mode, on the CPU.

Tolerances: float32 outputs within atol = rtol = 1e-6 (the Pallas kernel
contracts with one XLA dot, the port adds its products in index order);
bf16 leaves within one bf16 rounding of each other (rtol 2^-7: both sides
accumulate in float32 and round once, so the two may land on neighbouring
bf16 values).  Inside the port: chunked = single call, identity operator =
plain gated SGD, and the launch counters stay at 0 on the CPU, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jprotocol
from repro.core.hierarchy import MultiLevelNetwork as JNet
from repro.kernels import hier_mix as jhm
from repro_torch.core import protocol as tprotocol
from repro_torch.core.hierarchy import MultiLevelNetwork as TNet
from repro_torch.kernels import hier_mix as thm
from repro_torch.kernels import ops, ref
from repro_torch.tree import tree_leaves

F32 = dict(atol=1e-6, rtol=1e-6)
BF16 = dict(atol=1e-6, rtol=2.0 ** -7)


def _inputs(seed, w, c):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((w, c)).astype(np.float32)
    g = rng.standard_normal((w, c)).astype(np.float32)
    t = rng.random((w, w)).astype(np.float32)
    t /= t.sum(0, keepdims=True)
    theta = (rng.random(w) > 0.3).astype(np.float32)
    return x, g, t, theta


def _cast(a, dtype):
    return (torch.from_numpy(a).to(dtype),
            jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16
                        else jnp.float32))


@pytest.mark.parametrize("w", [3, 4, 8, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_per_leaf_matches_pallas_interpret(w, dtype):
    x, g, t, theta = _inputs(w, w, 301)
    (tx, jx), (tg, jg) = _cast(x, dtype), _cast(g, dtype)
    got = ops.hier_mix(tx, tg, torch.from_numpy(t), torch.from_numpy(theta),
                       0.1)
    want = jhm.hier_mix_chunks(jx, jg, jnp.asarray(t), jnp.asarray(theta),
                               0.1, interpret=True)
    assert got.dtype == dtype and got.shape == (w, 301)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == torch.float32 else BF16))


def _grouped(w, d, hub):
    net_args = ("ring", [w // d] * d)
    jn, tn = JNet.build(*net_args), TNet.build(*net_args)
    h = tn.hub_net.h if hub else None
    return (thm.make_grouped_operator(tn.subnet_of, tn.v, h),
            jhm.make_grouped_operator(jn.subnet_of, jn.v,
                                      jn.hub_net.h if hub else None))


@pytest.mark.parametrize("w,d", [(4, 2), (8, 4), (12, 3)])
@pytest.mark.parametrize("hub", [False, True])
def test_k2_grouped_packed_matches_pallas_interpret(w, d, hub):
    rng = np.random.default_rng(w + d)
    tree = {"a": rng.standard_normal((w, 7, 5)).astype(np.float32),
            "b": rng.standard_normal((w,)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in tree.items()}
    theta = (rng.random(w) > 0.3).astype(np.float32)
    top, jop = _grouped(w, d, hub)
    for a, b in zip((top.scatter, top.broadcast, top.hub),
                    (jop.scatter, jop.broadcast, jop.hub)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = ops.hier_mix_packed({k: torch.from_numpy(v) for k, v in
                               tree.items()},
                              {k: torch.from_numpy(v) for k, v in
                               grads.items()},
                              top, torch.from_numpy(theta), 0.05)
    want = jhm.hier_mix_packed(jax.tree.map(jnp.asarray, tree),
                               jax.tree.map(jnp.asarray, grads), jop,
                               jnp.asarray(theta), 0.05, interpret=True)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **F32)


@pytest.mark.parametrize("w", [3, 8])
def test_k1_packed_matches_pallas_interpret_with_bf16_leaves(w):
    x, g, t, theta = _inputs(10 + w, w, 64)
    tree = {"f": torch.from_numpy(x.reshape(w, 8, 8)),
            "h": torch.from_numpy(x[:, :5]).to(torch.bfloat16)}
    grads = {"f": torch.from_numpy(g.reshape(w, 8, 8)),
             "h": torch.from_numpy(g[:, :5]).to(torch.bfloat16)}
    jtree = {"f": jnp.asarray(x.reshape(w, 8, 8)),
             "h": jnp.asarray(x[:, :5], jnp.bfloat16)}
    jgrads = {"f": jnp.asarray(g.reshape(w, 8, 8)),
              "h": jnp.asarray(g[:, :5], jnp.bfloat16)}
    got = ops.hier_mix_packed(tree, grads, torch.from_numpy(t),
                              torch.from_numpy(theta), 0.1)
    want = jhm.hier_mix_packed(jtree, jgrads, jnp.asarray(t),
                               jnp.asarray(theta), 0.1, interpret=True)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["f"].numpy(), np.asarray(want["f"]), **F32)
    np.testing.assert_allclose(got["h"].float().numpy(),
                               np.asarray(want["h"], np.float32), **BF16)


@pytest.mark.parametrize("num_chunks", [1, 2, 3, 8])
@pytest.mark.parametrize("grouped", [False, True])
def test_chunked_equals_single_call_bit_for_bit(num_chunks, grouped):
    rng = np.random.default_rng(num_chunks)
    w = 8
    tree = {"a": torch.from_numpy(rng.standard_normal((w, 300)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.standard_normal((w, 9, 31)).astype(
                np.float32)).to(torch.bfloat16)}
    grads = {k: torch.randn(v.shape, generator=torch.Generator()
                            .manual_seed(1)).to(v.dtype)
             for k, v in tree.items()}
    theta = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.float32)
    op = (_grouped(w, 2, True)[0] if grouped else
          torch.from_numpy(_inputs(0, w, 1)[2]))
    single = ops.hier_mix_packed(tree, grads, op, theta, 0.1)
    chunked = ops.hier_mix_packed_chunked(tree, grads, op, theta, 0.1,
                                          num_chunks=num_chunks)
    for a, b in zip(tree_leaves(single), tree_leaves(chunked)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jwant = jhm.hier_mix_packed_chunked(
        {"a": jnp.asarray(tree["a"].numpy()),
         "b": jnp.asarray(tree["b"].float().numpy(), jnp.bfloat16)},
        {"a": jnp.asarray(grads["a"].numpy()),
         "b": jnp.asarray(grads["b"].float().numpy(), jnp.bfloat16)},
        _grouped(w, 2, True)[1] if grouped else jnp.asarray(op.numpy()),
        jnp.asarray(theta.numpy()), 0.1, num_chunks=num_chunks,
        interpret=True)
    np.testing.assert_allclose(chunked["a"].numpy(), np.asarray(jwant["a"]),
                               **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_operator_is_plain_gated_sgd_bit_for_bit(dtype):
    """T = I leaves u = x - (eta * theta) * g in float32, rounded once: the
    event executor's local-slot update, which the full scan runs through
    the kernel with the identity."""
    x, g, _, theta = _inputs(5, 5, 97)
    tx, tg = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    th = torch.from_numpy(theta)
    got = ops.hier_mix(tx, tg, torch.eye(5), th, 0.05)
    a = th * float(np.float32(0.05))
    want = (tx.float() - a[:, None] * tg.float()).to(dtype)
    assert torch.equal(got, want)


def test_grouped_equals_two_stage_strategies():
    """The fused grouped operator computes the two_stage subnet / hub
    rounds of the protocol engine (dense operator form, same sums in
    another order: float32 tolerance)."""
    tn = TNet.build("ring", [3, 3, 3], worker_rates=None)
    st = tprotocol.state_from_network(tn, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((9, 11)).astype(np.float32))
    zero = torch.zeros_like(x)
    theta = torch.ones(9)
    for hub, strat in ((None, tprotocol.subnet_average_two_stage),
                       (tn.hub_net.h, tprotocol.hub_average_two_stage)):
        op = thm.make_grouped_operator(tn.subnet_of, tn.v, hub)
        got = ops.hier_mix(x, zero, op, theta, 0.1)
        want = strat({"x": x.clone()}, st)["x"]
        torch.testing.assert_close(got, want, **F32)
    # the reference's grouped strategy on the same network agrees too
    jn = JNet.build("ring", [3, 3, 3])
    jst = jprotocol.state_from_network(jn)
    jwant = jprotocol.hub_average_two_stage({"x": jnp.asarray(x.numpy())},
                                            jst)["x"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32)


def test_cpu_calls_launch_nothing_and_tiles_fit_hopper():
    ops.reset_launches()
    x, g, t, theta = _inputs(1, 4, 33)
    ops.hier_mix(torch.from_numpy(x), torch.from_numpy(g),
                 torch.from_numpy(t), torch.from_numpy(theta), 0.1)
    ops.hier_mix_packed({"x": torch.from_numpy(x)}, {"x": torch.from_numpy(g)},
                        torch.from_numpy(t), torch.from_numpy(theta), 0.1)
    for fn in (ops.hier_mix, ops.hier_mix_pytree, ops.hier_mix_packed,
               ops.hier_mix_packed_chunked):
        assert fn.launches == 0 and fn.grouped_launches == 0
    # the paper's W = 100 (10 sub-networks) fits a block; W = 226 does not
    assert thm.pick_tile(4, 0, False, False) == 256
    assert thm.pick_tile(100, 0, False, False) == 256
    assert thm.pick_tile(100, 10, True, True) == 256
    assert thm.pick_tile(225, 0, False, False) == 32
    assert thm.smem_bytes(225, 0, False, False, 32) <= thm.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        thm.pick_tile(226, 0, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        thm.hier_mix_chunks(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(t), torch.from_numpy(theta), 0.1)
