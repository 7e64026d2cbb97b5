"""The port's timeline executors (`repro_torch.core.timeline`:
`EventExecutor`, `make_timeline_step_fn`, `run_timeline`) against the JAX
package's, on the CPU.

Against the reference: `run_timeline` for barrier / deadline / gossip x
kernel in {xla, pallas} from the same numpy data and policy Generator,
u_k losses and final u within atol 1e-5 (no injected draws).  Inside the
port, bit for bit: event-sparse = full scan (kernel packed and per leaf),
``overlap="chunked"`` = ``"none"`` on the kernel path; the torch chunked
path agrees to reduction order (atol = rtol = 1e-6).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import timeline as jtl
from repro.core.hierarchy import MLLSchedule as JSched
from repro.core.simulator import SimConfig as JCfg
from repro_torch.core import baselines as tbase
from repro_torch.core import packing
from repro_torch.core import timeline as ttl
from repro_torch.core.hierarchy import MLLSchedule as TSched
from repro_torch.core.simulator import SimConfig as TCfg
from repro_torch.core.simulator import init_sim_carry, replicate
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves

from test_torch_simulator import jax_task, torch_task

RATES = [1.0, 0.9, 0.8, 0.5, 0.7, 1.0, 0.6, 0.9]


def _nets(topology="ring", wps=(4, 4), rates=RATES):
    return (jbase.mll_sgd(topology, list(wps), 4, 2, worker_rates=rates)[0],
            tbase.mll_sgd(topology, list(wps), 4, 2, worker_rates=rates)[0])


def _run_port(net, policy, slots=32, seed=2, rng_seed=11, **kw):
    data, loss_fn, acc_fn, init = torch_task(net.num_workers, per_worker=128,
                                             seed=1)
    exec_mode = kw.pop("exec_mode", "event")
    return ttl.run_timeline(
        loss_fn, acc_fn, init, data.worker_data(), data.full, data.test, net,
        TSched(4, 2), slots=slots, policy=policy,
        cfg=TCfg(eta=0.1, batch_size=8, eval_every=16, **kw), seed=seed,
        policy_rng=np.random.default_rng(rng_seed), exec_mode=exec_mode,
        device="cpu")


@pytest.mark.parametrize("policy,mixing", [
    ("barrier", "dense"), ("deadline", "two_stage"), ("gossip", "dense")])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_run_timeline_matches_reference(policy, mixing, kernel):
    jnet, tnet = _nets()
    data, loss_fn, acc_fn, init = jax_task(8, per_worker=128, seed=1)
    kw = dict(eta=0.1, batch_size=8, eval_every=16, kernel=kernel,
              mixing=mixing)
    jr = jtl.run_timeline(loss_fn, acc_fn, init, data.worker_data(),
                          data.full, data.test, jnet, JSched(4, 2), slots=32,
                          policy=policy, cfg=JCfg(**kw), seed=2,
                          policy_rng=np.random.default_rng(11))
    kw.pop("eta"), kw.pop("batch_size"), kw.pop("eval_every")
    tr = _run_port(tnet, policy, **kw)
    np.testing.assert_array_equal(tr.slots, jr.slots)
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, atol=1e-5)
    np.testing.assert_allclose(tr.test_acc, jr.test_acc, atol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tr.final_avg_params[k].numpy(),
                                   np.asarray(jr.final_avg_params[k]),
                                   atol=1e-5)
    assert ttl.plan_trace(tr.plan) == jtl.plan_trace(jr.plan)


def _equal(a, b):
    for x, y in zip(tree_leaves(a.final_avg_params),
                    tree_leaves(b.final_avg_params)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.train_loss, b.train_loss)
    np.testing.assert_array_equal(a.test_acc, b.test_acc)


@pytest.mark.parametrize("kernel,packed", [("xla", None), ("pallas", True),
                                           ("pallas", False)])
@pytest.mark.parametrize("policy", ["barrier", "deadline"])
def test_event_sparse_equals_full_scan_bit_for_bit(kernel, packed, policy):
    """The event executor skips the identity contractions of local slots;
    the full scan runs them (with the kernel: K1 over the packed buffer or
    per leaf, with T = I).  Same draws, same bits."""
    _, tnet = _nets()
    try:
        packing.set_flat_paths(packed)
        runs = {m: _run_port(tnet, policy, kernel=kernel, exec_mode=m)
                for m in ("full", "event")}
    finally:
        packing.set_flat_paths(None)
    _equal(runs["full"], runs["event"])


@pytest.mark.parametrize("policy,mixing", [
    ("barrier", "dense"), ("deadline", "two_stage"), ("deadline", "ppermute"),
    ("gossip", "dense")])
def test_overlap_chunked_equals_none(policy, mixing):
    """Kernel path: one launch per column chunk = one launch, bit for bit.
    Torch path: packed per-chunk products (dense operators for the
    structured strategies) = per-leaf mixing to reduction order."""
    _, tnet = _nets()
    for kernel in ("pallas", "xla"):
        none = _run_port(tnet, policy, kernel=kernel, mixing=mixing)
        chunked = _run_port(tnet, policy, kernel=kernel, mixing=mixing,
                            overlap="chunked", overlap_chunks=3)
        if kernel == "pallas":
            _equal(none, chunked)
        else:
            for x, y in zip(tree_leaves(none.final_avg_params),
                            tree_leaves(chunked.final_avg_params)):
                torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-6)


def test_chunked_torch_paths_match_unfused():
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((4, 300)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(
            (4, 7)).astype(np.float32))}
    grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in tree.items()}
    t = torch.from_numpy(rng.random((4, 4)).astype(np.float32))
    theta = torch.tensor([1.0, 0.0, 1.0, 1.0])
    got = ttl.chunked_update_mix(tree, grads, t, theta, 0.1, 3)
    want = ops.hier_mix_packed(tree, grads, t, theta, 0.1)
    mixed = ttl.chunked_apply_operator(tree, t, 2)
    for k in tree:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(
            mixed[k], torch.einsum("ij,i...->j...", t, tree[k]),
            atol=1e-6, rtol=1e-6)


def test_dense_event_step_preserves_leaf_dtypes():
    """A per-event dense mix keeps non-f32 leaves in their own dtype."""
    _, tnet = _nets("complete", (2, 2), None)
    cfg = TCfg(eta=0.1, batch_size=2)

    def loss_fn(p, batch):
        return sum((x.float() ** 2).sum() for x in tree_leaves(p))

    ex = ttl.EventExecutor(loss_fn, tnet, cfg, gate_mode="forced",
                           device="cpu")
    init = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "b": torch.ones(4)}
    carry = init_sim_carry(replicate(init, 4), cfg, seed=0)
    dtypes = [x.dtype for x in tree_leaves(carry[0])]
    out = ex.step_dense(carry, {"x": torch.zeros(4, 2, 1)},
                        np.ones(4, np.float32), torch.eye(4))
    assert [x.dtype for x in tree_leaves(out[0])] == dtypes
    # all-f32 trees take the flat path where it is on: same values
    f32 = {"w": torch.randn(4, 3, 2), "b": torch.randn(4, 5)}
    t = torch.softmax(torch.randn(4, 4), 0)
    want = ttl.apply_event_operator(f32, t)
    try:
        packing.set_flat_paths(True)
        got = ttl.apply_event_operator(f32, t)
    finally:
        packing.set_flat_paths(None)
    for k in f32:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-6)


def test_exec_mode_and_gate_mode_errors():
    _, tnet = _nets()
    with pytest.raises(ValueError, match="exec_mode='full'"):
        _run_port(tnet, "gossip", slots=8, exec_mode="full")
    with pytest.raises(ValueError, match="unknown exec_mode"):
        _run_port(tnet, "barrier", slots=8, exec_mode="warp")
    with pytest.raises(ValueError, match="overlap='chunked'"):
        ttl.make_timeline_step_fn(lambda p, b: 0, tnet,
                                  TCfg(overlap="chunked"),
                                  gate_mode="forced", device="cpu")
    with pytest.raises(ValueError, match="gate_mode"):
        ttl.EventExecutor(lambda p, b: 0, tnet, TCfg(), gate_mode="late",
                          device="cpu")


def test_kernel_path_counts_updates_like_the_protocol():
    """The fused path owns the update but advances the per-worker step
    counts as `protocol.gated_inner_update` does."""
    _, tnet = _nets()
    data, loss_fn, _, init = torch_task(8, per_worker=128, seed=1)
    counts = {}
    for kernel in ("xla", "pallas"):
        cfg = TCfg(eta=0.1, batch_size=8, kernel=kernel)
        ex = ttl.EventExecutor(loss_fn, tnet, cfg, gate_mode="bernoulli",
                               device="cpu")
        plan = ttl.get_policy("deadline").plan(tnet, TSched(4, 2), 12,
                                               np.random.default_rng(0))
        carry = init_sim_carry(replicate(init, 8), cfg, seed=4)
        carry = ex.run(carry, data.worker_data(), plan, 0, 12)
        counts[kernel] = carry[1]["counts"].tolist()
    assert counts["xla"] == counts["pallas"]
    assert 0 < min(counts["xla"]) and max(counts["xla"]) == 12


def test_paper_claim_straggler_race_through_the_port():
    """tests/test_convergence_paper.py `test_straggler_race_mll_wins_per_
    slot` on the port's policies: with 10% slow workers the barrier
    policy's rounds cost > 1.3x the deadline policy's."""
    rates = [0.9] * 90 + [0.6] * 10
    net, _ = tbase.mll_sgd("complete", [100], tau=32, q=1, worker_rates=rates)
    sched = TSched(tau=32, q=1)
    barrier = ttl.get_policy("barrier").plan(net, sched, 3072,
                                             np.random.default_rng(0))
    mll = ttl.get_policy("deadline").plan(net, sched, 3072,
                                          np.random.default_rng(0))
    assert (mll.round_costs == 32).all()
    assert (barrier.round_costs > 32).all()
    assert mll.rounds_completed > 1.3 * barrier.rounds_completed
    assert barrier.round_costs.mean() / mll.round_costs.mean() > 1.3
    assert barrier.idle_slots[:90].min() > 0
    assert mll.idle_slots.sum() == 0
