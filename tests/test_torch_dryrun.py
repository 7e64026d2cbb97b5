"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU: one cheap
combination per kind -- training under each ``--phase``, prefill, decode --
on smoke configs with a small `ShapeSpec`, on the production meshes.  The
records carry the JAX dry run's JSON keys (``lower_s`` renamed ``run_s``);
the ``--all`` sweep at full width is a CLI run, not a test."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.mllsgd import MLLConfig, build_network, build_state
from repro_torch.core.simulator import replicate
from repro_torch.launch import dryrun
from repro_torch.launch import harness as tharness
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.input_specs import ShapeSpec
from repro_torch.models import model as tmodel
from repro_torch.train.train_step import mll_transformer_step
from repro_torch.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[1]
# the keys of the JAX module's record (repro/launch/dryrun.py: meta,
# _summarize and run_one's tail), with lower_s as run_s
JAX_KEYS = {"arch", "shape", "mesh", "kind", "phase", "mixing", "mix_dtype",
            "remat", "tau", "q", "granularity", "num_workers", "params_total",
            "params_active", "microbatch", "chips", "memory_analysis",
            "hlo_costs", "roofline", "raw_cost_analysis", "model_flops",
            "useful_fraction", "run_s", "compile_s"}
TRAIN = ShapeSpec("tiny_train", "train", 32, 64)
PREFILL = ShapeSpec("tiny_prefill", "prefill", 64, 32)
DECODE = ShapeSpec("tiny_decode", "decode", 64, 32)


def _run(arch, shape, **kw):
    return dryrun.run_one(arch, shape.name, cfg=get_smoke_config(arch),
                          shape=shape, **kw)


def _check(r):
    assert JAX_KEYS <= set(r), JAX_KEYS - set(r)
    json.dumps(r)
    assert r["hlo_costs"]["flops"] > 0 and r["roofline"]["flops"] > 0
    assert r["memory_analysis"]["argument_size_in_bytes"] > 0
    assert r["memory_analysis"]["output_size_in_bytes"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert 0 < r["useful_fraction"]


@pytest.mark.parametrize("phase", ["local", "subnet", "hub", "dynamic"])
def test_train_each_phase(phase):
    """qwen3 smoke on 2 x 16 x 16 (W = 32, a worker per (pod, data)):
    dense mixing all-gathers the leaves over the pods for subnet and hub;
    dynamic runs the hub step's phase."""
    r = _run("qwen3-1.7b", TRAIN, multi_pod=True, phase=phase)
    _check(r)
    assert r["num_workers"] == 32 and r["chips"] == 512
    assert r["phase_run"] == ("hub" if phase == "dynamic" else phase)
    coll = r["hlo_costs"]["collective_bytes"]
    if r["phase_run"] == "local":
        assert coll == 0
    else:
        assert coll > 0 and r["hlo_costs"]["dcn_bytes"] > 0
        assert r["rank_costs"]["collective_counts"]["all_gather"] > 0
    assert r["rank_costs"]["kernels"]["flash_attention"]["calls"] == \
        2 * get_smoke_config("qwen3-1.7b").num_layers      # remat "full"


def test_train_two_stage_subnet_and_hub():
    """two_stage on 16 x 16: a subnet round is one all-reduce per leaf
    among the pod's workers (no cross-pod bytes on one pod), a hub round
    adds nothing with one sub-network."""
    sub = _run("qwen3-1.7b", TRAIN, phase="subnet", mixing="two_stage")
    _check(sub)
    counts = sub["rank_costs"]["collective_counts"]
    assert set(counts) == {"all_reduce"} and counts["all_reduce"] > 0
    assert sub["hlo_costs"]["dcn_bytes"] == 0
    mp = _run("qwen3-1.7b", TRAIN, multi_pod=True, phase="hub",
              mixing="two_stage")
    assert mp["rank_costs"]["collective_counts"]["sendrecv"] > 0
    assert mp["hlo_costs"]["dcn_bytes"] > 0


def test_prefill_and_decode():
    for arch in ("qwen3-1.7b", "xlstm-125m", "jamba-v0.1-52b"):
        p = _run(arch, PREFILL)
        _check(p)
        assert p["kind"] == "prefill" and p["hlo_costs"][
            "collective_bytes"] == 0
        d = _run(arch, DECODE)
        _check(d)
        assert d["kind"] == "decode"
        assert d["model_flops"] == 2.0 * get_smoke_config(
            arch).active_param_count() * DECODE.global_batch


def test_xlstm_train_runs_the_scan_kernels_meta_branch():
    r = _run("xlstm-125m", TRAIN, phase="local", remat="none")
    _check(r)
    k = r["rank_costs"]["kernels"]
    assert set(k) == {"slstm_scan", "slstm_scan_bwd"}
    assert k["slstm_scan"]["calls"] == k["slstm_scan_bwd"]["calls"] > 0


def test_main_in_a_subprocess_loads_no_jax(tmp_path):
    """``main`` writes its records and imports neither JAX nor the JAX
    package, and sets no XLA_FLAGS."""
    out = tmp_path / "r.json"
    code = (
        "import os, sys\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.main(['--arch', 'xlstm-125m', '--shape', 'long_500k', "
        f"'--out', {str(out)!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad, 'XLA_FLAGS' in os.environ)\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO / "src")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD [] False" in res.stdout
    assert res.stdout.startswith("OK  xlstm-125m")
    (rec,) = json.loads(out.read_text())
    assert JAX_KEYS <= set(rec)


MLL = dict(tau=2, q=2, eta=0.05, hub_topology="ring",
           worker_rates=(1.0, 0.8, 1.0, 0.6))
TICKS = [("two_stage", 2), ("two_stage", 4), ("dense", 2), ("dense", 4)]


def _tick_inputs(cfg):
    """A fleet of 4 (2 sub-networks of 2) and one batch of 2 x 16 tokens a
    worker, from seeds."""
    params = replicate(tmodel.init_model(torch.Generator().manual_seed(0),
                                         cfg, device="cpu"), 4)
    toks = torch.randint(1, cfg.vocab_size, (4, 2, 17),
                         generator=torch.Generator().manual_seed(1))
    return params, {"tokens": toks[..., :-1].contiguous(),
                    "labels": toks[..., 1:].contiguous()}


def _tick(cfg, mixing, step, spmd=None, rows=slice(None)):
    mll = MLLConfig(mixing=mixing, **MLL)
    st = build_state(mll, build_network(mll, 2, 2), device="cpu")
    params, batch = _tick_inputs(cfg)
    take = (lambda x: x[rows].clone())
    out, _ = mll_transformer_step(tree_map(take, params),
                                  {k: take(v) for k, v in batch.items()},
                                  step, cfg, mll, st, impl="plain",
                                  spmd=spmd)
    return out


def _rank_ticks(cfg):
    """One rank of a (2, 1) mesh: each tick of `TICKS` over its rows."""
    mesh = tmesh.make_mesh((2, 1), ("workers", "data"))
    spmd = tharness.spmd_axis(mesh, 4)
    lo = spmd.offset()
    return [_tick(cfg, m, s, spmd, slice(lo, lo + spmd.per_shard))
            for m, s in TICKS]


def test_transformer_step_spmd_lowering_equals_one_process():
    """`mll_transformer_step(spmd=...)` -- the dry run's train program --
    on two gloo ranks (a sub-network each) equals the one-process tick bit
    for bit: subnet (step 2) and hub (step 4) rounds of two_stage and
    dense."""
    cfg = get_smoke_config("qwen2-0.5b")
    ranks = tmesh.spawn(_rank_ticks, 2, cfg, backend="gloo", device="cpu",
                        timeout=240)
    for k, (mixing, step) in enumerate(TICKS):
        want = tree_leaves(_tick(cfg, mixing, step))
        got = [torch.cat(xs) for xs in zip(*(tree_leaves(r[k])
                                             for r in ranks))]
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
