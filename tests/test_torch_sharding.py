"""The port's sharding plans (`repro_torch.launch.sharding`) and the dry
run's spec builders against the JAX package's, with no devices: the JAX
`ShardingPlan` reads only ``mesh.axis_names`` and ``mesh.devices.shape``
outside ``named()``, so a stand-in mesh (a namespace holding an empty
object array of the production shape) serves it, and the port's plan reads
a `launch.mesh.Mesh` built from its shape alone.  Every architecture of
the registry at full width, on the (16, 16) and (2, 16, 16) presets.
Exact: every partition spec equals the JAX ``PartitionSpec`` entry for
entry."""
import os
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.launch import input_specs as jspecs
from repro.launch import sharding as jsharding
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import input_specs as tspecs
from repro_torch.launch import sharding as tsharding
from repro_torch.launch.mesh import PRODUCTION, Mesh
from repro_torch.models import pjit_utils
from repro_torch.tree import map_with_path

PRESETS = {"16x16": False, "pod2x16x16": True}


def _jmesh(multi_pod):
    shape, axes = PRODUCTION[multi_pod]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, object))


def _plans(arch, multi_pod):
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    return (jsharding.make_plan(_jmesh(multi_pod), jcfg),
            tsharding.make_plan(Mesh(*PRODUCTION[multi_pod]), tcfg))


def _jax_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _is_spec(_, x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


@pytest.fixture(scope="module")
def jax_dryrun():
    """The JAX dry-run module, imported with the environment restored: it
    sets XLA_FLAGS at import, which must not reach this process' JAX (its
    backend is made first, so the flag would only be read by a later
    one)."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    return jd


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, preset):
    jplan, tplan = _plans(arch, PRESETS[preset])
    assert (tplan.granularity, tplan.num_workers, tplan.worker_axes,
            tplan.fsdp) == (jplan.granularity, jplan.num_workers,
                            jplan.worker_axes, jplan.fsdp)
    w = jplan.num_workers
    jshapes = jax.eval_shape(lambda: jmodel.init_model(
        jax.random.PRNGKey(0), jax_config(arch)))
    jshapes = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct((w,) + s.shape, s.dtype), jshapes)
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, s: want.__setitem__(_jax_path(path), tuple(s)),
        jplan.param_specs(jshapes, with_worker_axis=True),
        is_leaf=lambda x: isinstance(x, P))
    tshapes = tdry.stack_worker_axis(tdry.params_shape(torch_config(arch)),
                                     w)
    got = {}
    map_with_path(lambda path, s: got.setdefault(
        tsharding.leaf_path(path), []).append(s),
        tplan.param_specs(tshapes, with_worker_axis=True), is_leaf=_is_spec)
    assert sorted(got) == sorted(want)
    for k, specs in got.items():
        assert all(s == want[k] for s in specs), (k, specs[0], want[k])


@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_dims_divide_their_axes(preset):
    """`tests/test_mesh_subproc.py::test_sharding_plan_all_archs` without
    a subprocess: every sharded dim of every leaf divides the product of
    its mesh axes."""
    mesh = Mesh(*PRODUCTION[PRESETS[preset]])
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for arch in ARCH_IDS:
        plan = tsharding.make_plan(mesh, torch_config(arch))
        shapes = tdry.stack_worker_axis(
            tdry.params_shape(torch_config(arch)), plan.num_workers)
        specs = plan.param_specs(shapes, with_worker_axis=True)

        def check(path, leaf, spec):
            dims = tsharding.leaf_dims(path, spec, with_worker_axis=True)
            assert len(dims) == leaf.dim(), (arch, path)
            for d, ax in zip(leaf.shape, dims):
                if ax is None:
                    continue
                n = int(np.prod([sizes[a] for a in
                                 (ax if isinstance(ax, tuple) else (ax,))]))
                assert d % n == 0, (arch, path, tuple(leaf.shape), spec)
        map_with_path(check, shapes, specs)


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_logical_rules_equal_jax(preset, serving):
    for arch in ARCH_IDS:
        jplan, tplan = _plans(arch, PRESETS[preset])
        assert tplan.logical_rules(serving=serving) == \
            jplan.logical_rules(serving=serving), arch


def test_pjit_utils_rules_and_constraint():
    """`spec_for` resolves names under the installed rules (unknown names
    replicate); `constraint` is an identity that checks the rank while a
    mesh is installed, as the JAX package's does."""
    mesh = Mesh(*PRODUCTION[False])
    x = torch.empty(2, 3, device="meta")
    assert pjit_utils.constraint(x, "act_batch") is x     # no mesh: no check
    with pjit_utils.logical_sharding(mesh, {"heads": "model",
                                            "act_batch": ("pod", "data")}):
        assert pjit_utils.spec_for(["act_batch", None, "heads", "mlp"]) == \
            (("pod", "data"), None, "model", None)
        assert pjit_utils.constraint(x, "act_batch", None) is x
        with pytest.raises(ValueError, match="rank mismatch"):
            pjit_utils.constraint(x, "act_batch")
    assert pjit_utils.spec_for(["heads"]) == (None,)


@pytest.mark.parametrize("preset", PRESETS)
def test_decode_state_and_batch_specs_equal_jax(jax_dryrun, monkeypatch,
                                                preset):
    """The dry run's decode-state specs equal the JAX module's with its
    leading super-block dim dropped (the port's state is a list per
    super-block), and so do the serving and training batch specs."""
    monkeypatch.setattr(jax_dryrun, "NamedSharding", lambda mesh, spec: spec)
    for arch in ARCH_IDS:
        jplan, tplan = _plans(arch, PRESETS[preset])
        for shape in ("decode_32k", "long_500k"):
            js, ts = jspecs.SHAPES[shape], tspecs.SHAPES[shape]
            jcfg = jspecs.adapt_config(jax_config(arch), js)
            tcfg = tspecs.adapt_config(torch_config(arch), ts)
            jstate = jax.eval_shape(lambda: jmodel.init_decode_state(
                jcfg, js.global_batch, js.seq_len))
            want = {}
            jax.tree_util.tree_map_with_path(
                lambda path, s: want.__setitem__(_jax_path(path), tuple(s)),
                jax_dryrun.decode_state_specs(jstate, jplan),
                is_leaf=lambda x: isinstance(x, P))
            wshape = {}
            jax.tree_util.tree_map_with_path(
                lambda path, s: wshape.__setitem__(_jax_path(path), s.shape),
                jstate)
            tstate = tdry.model_mod.init_decode_state(
                tcfg, ts.global_batch, ts.seq_len, device="meta")
            tspec = tdry.decode_state_specs(tstate, tplan)
            assert len(tstate) == tcfg.num_super_blocks
            for blk, specs in zip(tstate, tspec):
                def check(path, leaf, spec):
                    key = "/".join(path)
                    assert tuple(leaf.shape) == wshape[key][1:], (arch, key)
                    assert want[key][0] is None
                    assert spec == want[key][1:], (arch, shape, key)
                map_with_path(check, blk, specs)
            jb = jspecs.decode_input_specs(jcfg, js)["batch"]
            tb = tspecs.decode_input_specs(tcfg, ts)["batch"]
            assert tdry.serve_batch_specs(tb, tplan) == {
                k: tuple(v) for k, v in
                jax_dryrun.serve_batch_specs(jb, jplan).items()}
        for shape in ("prefill_32k",):
            jb = jspecs.prefill_input_specs(jax_config(arch),
                                            jspecs.SHAPES[shape])
            tb = tspecs.prefill_input_specs(torch_config(arch),
                                            tspecs.SHAPES[shape])
            assert tdry.serve_batch_specs(tb, tplan) == {
                k: tuple(v) for k, v in
                jax_dryrun.serve_batch_specs(jb, jplan).items()}
        w = jplan.num_workers
        jb = jspecs.train_input_specs(jax_config(arch),
                                      jspecs.SHAPES["train_4k"], w)
        tb = tspecs.train_input_specs(torch_config(arch),
                                      tspecs.SHAPES["train_4k"], w)
        assert tdry.train_batch_specs(tb, tplan) == {
            k: tuple(v) for k, v in
            jax_dryrun.train_batch_specs(jb, jplan).items()}
