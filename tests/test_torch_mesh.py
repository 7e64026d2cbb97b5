"""The port's mesh path on the CPU: the worker fleet sharded over
`torch.distributed` ranks (gloo), one rank where the JAX package's mesh
tests put one forced host device (tests/test_spmd_subproc.py).

Every group of ranks is started by `repro_torch.launch.mesh.spawn`, which
stops them and fails after its ``timeout`` (below) if one hangs; the ranks'
store is a file in a fresh temporary directory, never a fixed port.  The
model is qwen2-0.5b's smoke config (2 layers, d_model 224, 14 / 2 heads):
in bf16 for the bit-identity cases, in float32 for the comparisons with
the JAX package and at three ranks per sub-network.

Tolerances:
* a mesh run against the port's single-process run of the same settings:
  bit for bit (state, every u_k, every loss) wherever each sub-network's
  workers lie on at most two ranks;
* three ranks per sub-network (W = 6 as 2 x 3 on six ranks, float32, 8
  slots): atol 1e-6, rtol 1e-5.  The library's all-reduce sums the three
  per-worker products in its own order, which differs from the serial sum
  by an ulp or two of the mean per round (~1e-7 of a parameter of size
  1); eight SGD steps of eta 0.05 carry that to at most 5.4e-7 on this
  config (gloo on the CPU is deterministic, so the run always lands
  there);
* against the JAX package's single-device `run_training`: atol 1e-5,
  rtol 1e-4 (`tests/test_torch_train.py`'s TOL: the frameworks round in
  other orders).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import mllsgd as jmll
from repro.core import protocol as jp
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.core import collectives, protocol
from repro_torch.core import mllsgd as tmll
from repro_torch.launch import harness as tharness
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as tengine
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[1]
CFG = torch_smoke("qwen2-0.5b")                     # bf16
F32 = dict(param_dtype="float32", compute_dtype="float32")
CFG32 = dataclasses.replace(CFG, **F32)
JCFG32 = dataclasses.replace(jax_smoke("qwen2-0.5b"), **F32)
TOL = dict(atol=1e-5, rtol=1e-4)
WIDE_TOL = dict(atol=1e-6, rtol=1e-5)
RATES = (1.0, 0.8, 1.0, 0.6)
QUIET = dict(log=lambda *a, **k: None)
COMBOS = [("deadline", "two_stage"), ("gossip", "dense"),
          ("deadline", "bf16"), ("deadline", "ppermute"),
          ("barrier", "two_stage")]
TIMEOUT = 240.0                     # seconds a group of ranks may take


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mll(mixing="two_stage", rates=RATES, **kw):
    return tmll.MLLConfig(tau=2, q=2, eta=0.05, hub_topology="ring",
                          mixing=mixing, worker_rates=rates, **kw)


def _loop(policy="deadline", mesh=None, **kw):
    base = dict(steps=8, eval_every=4, seq_len=32, batch_per_worker=2,
                tokens_per_worker=4096, policy=policy, device="cpu")
    return ttrain.TrainLoopConfig(**dict(base, mesh=mesh, **kw))


def _run(mll, loop, cfg=CFG, **kw):
    return ttrain.run_training(cfg, mll, loop, **dict(QUIET, **kw))


def _spawn(world, runs, cfg=CFG, **kw):
    return tmesh.spawn(ttrain.train_rank, world, cfg, runs, backend="gloo",
                       device="cpu", timeout=TIMEOUT, **kw)


def _joined(ranks: list, k: int):
    """Run k's full-width train state from every rank's rows (data
    replicas hold the same rows: one of each)."""
    by_row = {}
    for r in ranks:
        by_row.setdefault(r[k]["rows"][0], r[k]["state"])
    parts = [by_row[lo] for lo in sorted(by_row)]

    def cat(name):
        return tree_map(lambda *xs: torch.cat(xs),
                        *(getattr(p, name) for p in parts))
    return parts[0]._replace(params=cat("params"),
                             opt_state=cat("opt_state"),
                             mix_state=cat("mix_state"))


def _assert_same(mesh_ranks: list, k: int, ref: dict):
    """Bit for bit: the whole state trajectory's end, u_k, the history."""
    got = _joined(mesh_ranks, k)
    want = ref["train_state"]
    for name in ("params", "opt_state", "mix_state"):
        for a, b in zip(tree_leaves(getattr(got, name)),
                        tree_leaves(getattr(want, name)), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got.step) == int(want.step)
    for a, b in zip(tree_leaves(mesh_ranks[0][k]["u"]),
                    tree_leaves(ref["avg_params"]), strict=True):
        assert torch.equal(a, b)
    for r in mesh_ranks:                 # the same history on every rank
        h = r[k]["history"]
        assert h["step"] == ref["history"]["step"]
        assert h["avg_loss"] == ref["history"]["avg_loss"]
        np.testing.assert_allclose(h["loss"], ref["history"]["loss"],
                                   rtol=1e-5)


# ------------------------------------------------------ the runs, once
@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-process runs every mesh run is held to, and a
    single-process checkpoint at slot 4 (for the mesh to resume)."""
    ck = str(tmp_path_factory.mktemp("single-ck"))
    out = {c: _run(_mll(c[1]), _loop(c[0])) for c in COMBOS}
    out["deadline-dense"] = _run(_mll("dense"), _loop())
    _run(_mll("dense"), _loop("gossip", checkpoint_dir=ck,
                              checkpoint_every=4, stop_slot=4))
    out["ck"] = ck
    return out


@pytest.fixture(scope="module")
def mesh41(single, tmp_path_factory):
    """One world of four ranks on mesh (4, 1): the five combinations, a
    deadline x dense run, the (4, 1)-written checkpoint, a resume of the
    single-process checkpoint, and the collective counts (every run
    records its slots), all in one world."""
    ck = str(tmp_path_factory.mktemp("mesh-ck"))
    runs = [dict(mll=_mll(m), loop=_loop(p, (4, 1), profile_slots=True))
            for p, m in COMBOS]
    runs.append(dict(mll=_mll("dense"),
                     loop=_loop("deadline", (4, 1), profile_slots=True)))
    runs.append(dict(mll=_mll("dense"), loop=_loop(
        "gossip", (4, 1), checkpoint_dir=ck, checkpoint_every=4,
        stop_slot=4)))
    runs.append(dict(mll=_mll("dense"), loop=_loop(
        "gossip", (4, 1), checkpoint_dir=single["ck"], checkpoint_every=4,
        resume=True)))
    # 4 sub-networks of 1 on a ring: the circulant H has a zero at o = 2
    for m in ("two_stage", "ppermute"):
        runs.append(dict(mll=_mll(m), loop=_loop(
            "deadline", (4, 1), profile_slots=True, steps=4),
            num_subnets=4, workers_per_subnet=1))
    # a two_stage run (no all-gather in its events) checkpointing at slot 4
    runs.append(dict(mll=_mll("two_stage", inner_opt="momentum"),
                     loop=_loop("deadline", (4, 1), checkpoint_dir=str(
                         tmp_path_factory.mktemp("mesh-ck-ts")),
                         checkpoint_every=4, stop_slot=4)))
    return dict(ranks=_spawn(4, runs), ck=ck)


@pytest.fixture(scope="module")
def mesh22(single):
    runs = [dict(mll=_mll(m), loop=_loop(p, (2, 2))) for p, m in COMBOS]
    return _spawn(4, runs)


# ------------------------------------------------------ (a) bit identity
@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_mesh_4x1_equals_single_process_bit_for_bit(mesh41, single, combo):
    _assert_same(mesh41["ranks"], COMBOS.index(combo), single[combo])


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_mesh_2x2_equals_single_process_bit_for_bit(mesh22, single, combo):
    """Workers axis 2, data axis 2: two workers per rank (each sub-network
    on one rank), the data replicas computing the same rows."""
    _assert_same(mesh22, COMBOS.index(combo), single[combo])


def test_mesh_deadline_dense_bit_for_bit(mesh41, single):
    _assert_same(mesh41["ranks"], len(COMBOS), single["deadline-dense"])


# ------------------------------------------------------ (c) collectives
def _events(mesh41, k) -> dict:
    """{event: [collective counts of each slot of that event]}, rank 0."""
    out: dict = {}
    for s in mesh41["ranks"][0][k]["slot_stats"]:
        out.setdefault(s["event"], []).append(s["collectives"])
    return out


LEAVES = len(tree_leaves(tmodel.param_skeleton(CFG)))


def test_collectives_of_each_event(mesh41):
    """two_stage: a subnet event is all-reduces only (one per leaf), a hub
    event all-reduces plus one send / recv roll per leaf (D = 2), no
    all-gather (the fallback the grouped lowering rules out); a local slot
    makes none.  Dense events, gossip's composed operators included, are
    all-gathers only."""
    ev = _events(mesh41, COMBOS.index(("deadline", "two_stage")))
    assert all(c == {} for c in ev["local"])
    assert all(c == {"all_reduce": LEAVES} for c in ev["subnet"])
    assert all(c == {"all_reduce": LEAVES, "sendrecv": LEAVES}
               for c in ev["hub"])
    for k in (COMBOS.index(("gossip", "dense")), len(COMBOS)):
        for name, counts in _events(mesh41, k).items():
            want = {} if name == "local" else {"all_gather": LEAVES}
            assert all(c == want for c in counts), (name, counts)


def test_ppermute_rolls_only_nonzero_coefficients(mesh41):
    """4 sub-networks of one worker on a ring: H's circulant coefficient
    at o = 2 is zero.  two_stage rolls o = 1, 2, 3; ppermute skips o = 2;
    with one worker per sub-network the subnet mean needs no all-reduce."""
    k = len(COMBOS) + 3
    two, pp = _events(mesh41, k)["hub"], _events(mesh41, k + 1)["hub"]
    assert two == [{"sendrecv": 3 * LEAVES}] * len(two)
    assert pp == [{"sendrecv": 2 * LEAVES}] * len(pp)


def test_collective_helpers_count_and_move_on_one_rank():
    """The transport helpers on a world of one (gloo): a sum and a gather
    return the tensor, and each call is counted (gloo has no send to
    oneself; the mesh runs above count the rolls)."""
    store = torch.distributed.HashStore()
    torch.distributed.init_process_group("gloo", store=store, rank=0,
                                         world_size=1)
    try:
        collectives.reset()
        g = torch.distributed.new_group([0])
        x = torch.arange(6.0).reshape(2, 3).to(torch.bfloat16)
        assert torch.equal(collectives.all_reduce_sum(x, g), x)
        assert torch.equal(collectives.all_gather_rows(x, g), x)
        assert dict(collectives.COUNTS) == {"all_reduce": 1, "all_gather": 1}
    finally:
        torch.distributed.destroy_process_group()
        collectives.reset()


def test_collective_gather_to_host_on_one_rank():
    """`gather_rows_to_host` on a world of one (gloo): the rows in host
    memory on the receiving rank, counted with the bytes it received."""
    store = torch.distributed.HashStore()
    torch.distributed.init_process_group("gloo", store=store, rank=0,
                                         world_size=1)
    try:
        collectives.reset()
        g = torch.distributed.new_group([0])
        x = torch.arange(6.0).reshape(2, 3)
        got = collectives.gather_rows_to_host(x, 0, g)
        assert got.device.type == "cpu" and torch.equal(got, x)
        assert dict(collectives.COUNTS) == {"gather": 1}
        assert dict(collectives.BYTES) == {"gather": 24}
    finally:
        torch.distributed.destroy_process_group()
        collectives.reset()


def test_boundary_gathers_hold_no_fleet_on_non_writers(mesh41):
    """A boundary with an evaluation and a checkpoint on (4, 1): the full
    train state goes to the writer (rank 0) only, gathered into its host
    memory; the other ranks receive none of it.  Every rank's all-gathers
    bring in u_k's leaves once (one leaf at a time) and the per-worker
    losses twice, never the optimizer or the mixing state (two_stage's
    events make no all-gather); the run's end reuses the boundary's u_k."""
    k = len(COMBOS) + 5
    ranks = mesh41["ranks"]
    state = _joined(ranks, k)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    assert nbytes(state.opt_state) > 0          # momentum buffers
    full = nbytes((state.params, state.opt_state, state.mix_state))
    for rank, r in enumerate(ranks):
        got = r[k]["collective_bytes"]
        assert got.get("gather", 0) == (full if rank == 0 else 0), rank
        assert got["all_gather"] == nbytes(state.params) + 2 * 4 * 4, rank
        assert r[k]["collectives"]["gather"] == len(tree_leaves(
            (state.params, state.opt_state, state.mix_state)))
    assert ranks[0][k]["history"]["step"] == [4]


# ------------------------------------------------------ (d) checkpoints
def test_checkpoint_mesh_to_single_process(mesh41, single):
    """Saved at slot 4 on (4, 1) by rank 0, resumed in one process: the
    uninterrupted single-process trajectory bit for bit; the mesh is
    recorded outside the resume guard; the JAX package's `load_u_k` reads
    the directory."""
    ck = mesh41["ck"]
    rec = json.loads((Path(ck) / "state" / "manifest.json").read_text())
    assert rec["extra"]["mesh"] == {"workers": 4, "data": 1}
    assert rec["step"] == 4
    got = _run(_mll("dense"), _loop("gossip", checkpoint_dir=ck,
                                    checkpoint_every=4, resume=True))
    want = single[("gossip", "dense")]
    assert got["history"]["step"] == [8]
    assert got["history"]["avg_loss"] == want["history"]["avg_loss"][-1:]
    for a, b in zip(tree_leaves(got["train_state"]),
                    tree_leaves(want["train_state"]), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got["avg_params"]),
                    tree_leaves(want["avg_params"]), strict=True):
        assert torch.equal(a, b)
    # u_k of the slot-8 state the resume wrote, by both packages
    u_j = jengine.load_u_k(ck, jax_smoke("qwen2-0.5b"))
    _close(tengine.load_u_k(ck, CFG, device="cpu"), u_j, worker_axis=False,
           tol=dict(atol=0, rtol=0))


def test_checkpoint_single_process_to_mesh(mesh41, single):
    """Saved at slot 4 in one process, resumed on (4, 1): the uninterrupted
    run's end bit for bit."""
    k = len(COMBOS) + 2
    want = single[("gossip", "dense")]
    hist = mesh41["ranks"][0][k]["history"]
    assert hist["step"] == [8]
    assert hist["avg_loss"] == want["history"]["avg_loss"][-1:]
    got = _joined(mesh41["ranks"], k)
    for a, b in zip(tree_leaves(got), tree_leaves(want["train_state"]),
                    strict=True):
        assert torch.equal(a, b)


# ------------------------------------------------------ (b) against JAX
def test_mesh_run_matches_jax_run_training(monkeypatch):
    """A (4, 1) run of the port (float32) against the JAX package's
    single-device `run_training` from the same u_0 (the port's draw, handed
    to JAX's `init_model`), deadline x two_stage, 8 slots."""
    u0 = tmodel.init_model(torch.Generator().manual_seed(0), CFG32,
                           device="cpu")
    ju0 = jax.tree.map(jnp.asarray, interop.params_to_numpy(u0))
    monkeypatch.setattr(jtrain.model_mod, "init_model", lambda key, cfg: ju0)
    kw = dict(tau=2, q=2, eta=0.05, hub_topology="ring", mixing="two_stage",
              worker_rates=RATES)
    want = jtrain.run_training(
        JCFG32, jmll.MLLConfig(**kw), jtrain.TrainLoopConfig(
            steps=8, eval_every=4, seq_len=32, batch_per_worker=2,
            tokens_per_worker=4096, impl="xla"), **QUIET)
    got = _spawn(4, [dict(mll=_mll(), loop=_loop(mesh=(4, 1)))],
                 cfg=CFG32)[0][0]
    assert got["history"]["step"] == want["history"]["step"] == [4, 8]
    for k in ("loss", "avg_loss"):
        np.testing.assert_allclose(got["history"][k], want["history"][k],
                                   **TOL)
    _close(got["u"], want["avg_params"], worker_axis=False)


# ------------------------------------------------------ (f) 3 ranks / subnet
def test_three_ranks_per_subnet_within_stated_tolerance():
    """W = 6 as 2 x 3 on mesh (6, 1): the subnet mean is an all-reduce over
    three ranks, whose add order the library picks -- within WIDE_TOL of
    the single-process run (float32, 8 slots, two_stage)."""
    mll = _mll(rates=(1.0, 0.8, 1.0, 0.6, 0.9, 1.0))
    want = _run(mll, _loop(), cfg=CFG32, num_subnets=2,
                workers_per_subnet=3)
    ranks = _spawn(6, [dict(mll=mll, loop=_loop(mesh=(6, 1)),
                            num_subnets=2, workers_per_subnet=3)],
                   cfg=CFG32)
    got = _joined(ranks, 0)
    for a, b in zip(tree_leaves(got.params),
                    tree_leaves(want["train_state"].params), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **WIDE_TOL)
    np.testing.assert_allclose(ranks[0][0]["history"]["avg_loss"],
                               want["history"]["avg_loss"], **WIDE_TOL)


# ------------------------------------------------------ (e) guards
def test_mesh_guards():
    """Construction-time failures, with the JAX package's messages: no
    `workers` axis, a workers axis that does not divide W (harness and
    launcher), grouped mixing on shards that straddle sub-networks, the
    chunked overlap with a mesh, a strategy with no collective lowering,
    and a world too small for the mesh."""
    net = tmll.build_network(_mll(), 2, 2)
    st = tmll.build_state(_mll(), net, device="cpu")
    with pytest.raises(ValueError, match="no 'workers' axis"):
        tharness.TrainHarness(CFG, _mll(), st, gate_mode="bernoulli",
                              mesh=tmesh.Mesh((4, 2), ("model", "data")))
    with pytest.raises(ValueError, match="must divide the fleet W=4"):
        tharness.TrainHarness(CFG, _mll(), st, gate_mode="bernoulli",
                              mesh=tmesh.Mesh((3, 2), ("workers", "data")))
    with pytest.raises(ValueError, match="fix --mesh"):
        _run(_mll(), _loop(mesh=(3, 2)))
    six = _mll(rates=(1.0,) * 6)
    st6 = tmll.build_state(six, tmll.build_network(six, 2, 3), device="cpu")
    with pytest.raises(ValueError, match="subnet-aligned"):
        tharness.TrainHarness(CFG, six, st6, gate_mode="bernoulli",
                              mesh=tmesh.Mesh((3, 2), ("workers", "data")))
    with pytest.raises(ValueError, match="ONE device"):
        tharness.TrainHarness(CFG, _mll(), st, gate_mode="bernoulli",
                              mesh=tmesh.Mesh((4, 1), ("workers", "data")),
                              overlap="chunked")
    i8 = _mll("int8")
    with pytest.raises(ValueError) as e:
        tharness.TrainHarness(CFG, i8, st, gate_mode="bernoulli",
                              mesh=tmesh.Mesh((4, 1), ("workers", "data")))
    for name in protocol.spmd_capable_mixing():
        assert name in str(e.value)
    assert protocol.spmd_capable_mixing() == ("bf16", "dense", "ppermute",
                                              "two_stage")
    with pytest.raises(NotImplementedError, match="typed collectives"):
        protocol.get_mixing("int8").hub_spmd({}, st, None)
    with pytest.raises(RuntimeError, match="need 16 ranks"):
        tmesh.make_mesh((16, 1), ("workers", "data"))
    with pytest.raises(ValueError):
        tmesh.make_mesh((4, 2), ("workers",))
    with pytest.raises(ValueError):
        tmesh.make_mesh((0, 2), ("workers", "data"))
    with pytest.raises(ValueError, match="backend"):
        tmesh.spawn(ttrain.train_rank, 2, backend="mpi")


def test_mesh_layout_from_shape_alone():
    """Row-major ranks, lines along each axis, the presets' axis sizes --
    read without a world (a 512-rank one cannot be started here)."""
    m = tmesh.Mesh((4, 2), ("workers", "data"), rank=5)
    assert m.coordinate == (2, 1)
    assert m.line("workers") == (1, 3, 5, 7)
    assert m.line("data") == (4, 5)
    assert tmesh.mesh_axis_sizes(tmesh.Mesh(*tmesh.PRODUCTION[True])) == {
        "pod": 2, "data": 16, "model": 16}
    assert tmesh.mesh_axis_sizes(tmesh.Mesh(*tmesh.PRODUCTION[False])) == {
        "data": 16, "model": 16}
    one = tmesh.make_mesh((1, 1), ("workers", "data"))   # no world needed
    assert one.rank == 0 and one.blocks == {}
    ax = protocol.SpmdAxis("workers", 4, 8, index=3)
    assert (ax.per_shard, ax.offset()) == (2, 6)
    with pytest.raises(ValueError, match="must divide"):
        protocol.SpmdAxis("workers", 3, 8)


# ------------------------------------------------------ (g) microbatch
@pytest.fixture(scope="module")
def fleet():
    """Both packages' (4, ...) float32 fleets of u_0 plus per-worker noise,
    and one batch of 4 sequences per worker."""
    u0 = tmodel.init_model(torch.Generator().manual_seed(1), CFG32,
                           device="cpu")
    ju0 = interop.params_to_numpy(u0)
    rng = np.random.default_rng(2)
    jst = jax.tree.map(lambda x: jnp.asarray(
        np.broadcast_to(x[None], (4,) + x.shape)
        + 0.01 * rng.standard_normal((4,) + x.shape).astype(np.float32)),
        ju0)
    tst = interop.tree_from_numpy(jax.tree.map(np.asarray, jst), "cpu",
                                  worker_axis=True)
    stream = rng.integers(0, CFG32.vocab_size, (4, 400), dtype=np.int32)
    jbatch = jpipe.LMBatcher(stream, 16, 4).sample(np.random.default_rng(0))
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    return jst, tst, jbatch, tbatch


def _close(port_tree, jax_tree, worker_axis=True, tol=TOL):
    got = interop.flatten(port_tree, worker_axis=worker_axis)
    want = jckpt._flatten(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_microbatch_grads_match_jax(fleet):
    """microbatch = 2 over a batch of 4: the port's accumulation (float32
    accumulator) against JAX's scan, grads and loss / ce / aux."""
    jst, tst, jbatch, tbatch = fleet
    jg, jm = jax.jit(functools.partial(
        jts.per_worker_grads, cfg=JCFG32, impl="xla", microbatch=2))(
            jst, jbatch)
    tg, tm = tts.per_worker_grads(tst, tbatch, CFG32, microbatch=2)
    assert all(x.dtype == torch.float32 for x in tree_leaves(tg))
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **TOL)
    _close(tg, jg)
    # the whole batch at once is the same gradient to float32 rounding
    g1, m1 = tts.per_worker_grads(tst, tbatch, CFG32)
    np.testing.assert_allclose(m1["loss"].numpy(), tm["loss"].numpy(),
                               **TOL)
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        tts.per_worker_grads(tst, tbatch, CFG32, microbatch=3)


@pytest.mark.parametrize("step,microbatch", [(2, 1), (4, 2)])
def test_transformer_steps_match_jax(fleet, step, microbatch):
    """`mll_transformer_step` (stateless) and `mll_transformer_state_step`
    (momentum state carried) at a subnet tick (2) and a hub tick (4)."""
    jst, tst, jbatch, tbatch = fleet
    kw = dict(tau=2, q=2, eta=0.05, hub_topology="ring", mixing="two_stage",
              worker_rates=RATES)
    jcfg, tcfg = jmll.MLLConfig(**kw), tmll.MLLConfig(**kw)
    jnet, tnet = jmll.build_network(jcfg, 2, 2), tmll.build_network(tcfg, 2, 2)
    jst_, tst_ = jmll.build_state(jcfg, jnet), tmll.build_state(
        tcfg, tnet, device="cpu")
    jout, jm = jts.mll_transformer_step(jst, jbatch, jnp.int32(step), JCFG32,
                                        jcfg, jst_, impl="xla",
                                        microbatch=microbatch)
    tout, tm = tts.mll_transformer_step(tree_map(torch.clone, tst), tbatch,
                                        step, CFG32, tcfg, tst_,
                                        microbatch=microbatch)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               **TOL)
    _close(tout, jout)

    mom = dict(kw, inner_opt="momentum")
    jcfg, tcfg = jmll.MLLConfig(**mom), tmll.MLLConfig(**mom)
    js = jp.init_train_state(jst, cfg=jcfg)._replace(
        step=jnp.int32(step - 1))
    ts = protocol.init_train_state(tree_map(torch.clone, tst), cfg=tcfg)
    ts = ts._replace(step=torch.tensor(step - 1, dtype=torch.int32))
    jnew, _ = jts.mll_transformer_state_step(js, jbatch, JCFG32, jcfg, jst_,
                                             impl="xla",
                                             microbatch=microbatch)
    tnew, _ = tts.mll_transformer_state_step(ts, tbatch, CFG32, tcfg, tst_,
                                             microbatch=microbatch)
    assert int(tnew.step) == int(jnew.step) == step
    _close(tnew.params, jnew.params)
    _close(tnew.opt_state["inner"], jnew.opt_state["inner"])
    assert tnew.opt_state["counts"].tolist() == np.asarray(
        jnew.opt_state["counts"]).tolist()


# ------------------------------------------------------ (h) the CLI
def test_cli_mesh_trains_on_two_ranks():
    """``--mesh 2,1 --device cpu`` starts two gloo ranks, logs the mesh
    line and trains to a finite u_k loss."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--device", "cpu", "--mesh", "2,1",
         "--steps", "4", "--tau", "2", "--q", "2", "--topology", "ring",
         "--mixing", "two_stage", "--seq-len", "16", "--batch", "2",
         "--eval-every", "2"], env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh: workers=2 data=1 over 2 ranks (backend gloo, rank 0)" \
        in res.stdout
    last = [ln for ln in res.stdout.splitlines() if "final u_k loss" in ln]
    assert last and np.isfinite(float(last[0].split()[3]))
