"""The port's packing contract (`repro_torch.core.packing`) against the JAX
package's (`repro.core.packing`).

Trees of the same structure pack into the same columns: the specs' slots,
the packed buffers and the chunk views are equal exactly (packing is a
copy; the buffers compare bit for bit).  Inside the port the packed fused
update + mix equals the per-leaf one bit for bit on the plain versions
(CPU), bf16 and one-column leaves included.  The flat torch paths agree
with per-leaf products to reduction order (atol = rtol = 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpk
from repro_torch.core import packing as tpk
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

W = 6


def _tree(seed, w=W, awkward=True, bf16=True, scalar=True):
    """Stacked numpy tree with the awkward cases: a (W,) leaf, a bf16 leaf
    (kept as float32 here, cast by `_t` / `_j`), a non-aligned leaf."""
    rng = np.random.default_rng(seed)
    tree = {"w1": rng.standard_normal((w, 20, 37) if awkward
                                      else (w, 16, 128)).astype(np.float32),
            "small": rng.standard_normal((w, 5)).astype(np.float32),
            "nested": {"z": rng.standard_normal((w, 3, 3)).astype(np.float32)}}
    if scalar:
        tree["b"] = rng.standard_normal((w,)).astype(np.float32)
    if bf16:
        tree["h"] = rng.standard_normal((w, 33, 8)).astype(np.float32)
    return tree


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else (
        torch.from_numpy(v).to(torch.bfloat16) if k == "h"
        else torch.from_numpy(v)) for k, v in tree.items()}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else (
        jnp.asarray(v, jnp.bfloat16) if k == "h" else jnp.asarray(v))
        for k, v in tree.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kwargs", [
    dict(), dict(awkward=False), dict(bf16=False, scalar=False)])
def test_pack_unpack_round_trip_and_layout_equal_the_reference(seed, kwargs):
    tree = _tree(seed, **kwargs)
    tt, jt = _t(tree), _j(tree)
    spec, jspec = tpk.pack_spec(tt), jpk.pack_spec(jt)
    assert spec.total_cols == jspec.total_cols
    assert [(s.offset, s.size, s.shape) for s in spec.slots] == \
        [(s.offset, s.size, s.shape) for s in jspec.slots]
    buf = tpk.pack(tt, spec)
    assert buf.dtype == torch.float32 and buf.shape == (W, spec.total_cols)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jpk.pack(jt)))
    back = tpk.unpack(buf, spec)
    assert list(back) == list(tt)
    for a, b in zip(tree_leaves(tt), tree_leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    row = tpk.unpack_row(buf[2], spec)
    for a, b in zip(tree_leaves(tt), tree_leaves(row)):
        assert torch.equal(a[2], b)
    # cached per (structure, shapes, dtypes)
    assert tpk.pack_spec(_t(_tree(seed + 5, **kwargs))) is spec


def test_unpack_keeps_float32_leaves_as_views_of_the_buffer():
    tt = _t(_tree(3))
    spec = tpk.pack_spec(tt)
    buf = tpk.pack(tt, spec)
    out = tpk.unpack(buf, spec)
    assert out["w1"].data_ptr() == buf.data_ptr() + 4 * spec.slots[
        [s.shape for s in spec.slots].index((W, 20, 37))].offset
    assert out["h"].dtype == torch.bfloat16


def test_tree_structure_round_trip_keeps_key_order_and_containers():
    tree = {"z": [torch.ones(2), (torch.zeros(1), torch.ones(3))],
            "a": {"y": torch.ones(4), "b": ()}}
    leaves = tree_leaves(tree)
    back = tree_unflatten(tree_structure(tree), leaves)
    assert list(back) == ["z", "a"] and list(back["a"]) == ["y", "b"]
    assert isinstance(back["z"], list) and isinstance(back["z"][1], tuple)
    assert back["a"]["b"] == ()
    assert all(x is y for x, y in zip(tree_leaves(back), leaves))
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree_structure(tree), leaves + [torch.ones(1)])


def test_pack_spec_rejects_empty_and_mismatched_worker_axes():
    with pytest.raises(ValueError, match="empty"):
        tpk.pack_spec({})
    with pytest.raises(ValueError, match="worker axis"):
        tpk.pack_spec({"a": torch.zeros(4, 3), "b": torch.zeros(5, 3)})
    with pytest.raises(ValueError, match="worker axis"):
        tpk.pack_spec({"a": torch.zeros(()), "b": torch.zeros(4, 3)})


def test_shard_spec_matches_local_pack_spec_and_the_reference():
    tt = _t(_tree(0))
    spec = tpk.pack_spec(tt)
    jspec = jpk.pack_spec(_j(_tree(0)))
    for n in (1, 2, 3, 6):
        w = W // n
        sub = {k: (v[:w] if not isinstance(v, dict)
                   else {kk: vv[:w] for kk, vv in v.items()})
               for k, v in tt.items()}
        local = tpk.shard_spec(spec, n)
        assert local == tpk.pack_spec(sub)
        assert [s.shape for s in local.slots] == \
            [s.shape for s in jpk.shard_spec(jspec, n).slots]
        assert torch.equal(tpk.pack(sub, local), tpk.pack(tt, spec)[:w])
    for bad in (4, 0):
        with pytest.raises(ValueError, match="must divide"):
            tpk.shard_spec(spec, bad)


@pytest.mark.parametrize("total", [1, 127, 128, 129, 1000, 4096, 5000])
@pytest.mark.parametrize("num_chunks", [1, 2, 3, 4, 7])
def test_chunk_views_equal_the_reference(total, num_chunks):
    tree = {"x": np.zeros((2, total), np.float32)}
    got = tpk.chunk_views(tpk.pack_spec({"x": torch.zeros(2, total)}),
                          num_chunks)
    want = jpk.chunk_views(jpk.pack_spec({"x": jnp.asarray(tree["x"])}),
                           num_chunks)
    assert [(c.lo, c.hi, c.size) for c in got] == \
        [(c.lo, c.hi, c.size) for c in want]
    assert got[0].lo == 0 and got[-1].hi == total
    assert all(c.lo % 128 == 0 for c in got)
    with pytest.raises(ValueError, match="num_chunks"):
        tpk.chunk_views(tpk.pack_spec({"x": torch.zeros(2, 3)}), 0)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_packed_equals_per_leaf_bit_for_bit(seed):
    """ONE packed call reproduces the per-leaf loop bit for bit (float32
    arithmetic, one rounding to the leaf dtype on both paths), on the
    plain versions the CPU runs."""
    rng = np.random.default_rng(seed)
    tree, grads = _t(_tree(seed)), _t(_tree(seed + 100))
    t_op = torch.from_numpy(rng.random((W, W)).astype(np.float32))
    t_op = t_op / t_op.sum(0, keepdim=True)
    theta = torch.from_numpy((rng.random(W) > 0.4).astype(np.float32))
    packed = ops.hier_mix_packed(tree, grads, t_op, theta, 0.1)
    perleaf = ops.hier_mix_pytree(tree, grads, t_op, theta, 0.1)
    for a, b, x in zip(tree_leaves(packed), tree_leaves(perleaf),
                       tree_leaves(tree)):
        assert a.dtype == b.dtype == x.dtype and a.shape == x.shape
        assert torch.equal(a, b)


def test_flat_paths_match_per_leaf_and_identity_is_exact():
    tree = _t(_tree(4, bf16=False))
    assert tpk.all_f32(tree) and not tpk.all_f32(_t(_tree(4)))
    rng = np.random.default_rng(1)
    t_op = torch.from_numpy(rng.random((W, W)).astype(np.float32))
    got = tpk.apply_operator_packed(tree, t_op)
    for a, x in zip(tree_leaves(got), tree_leaves(tree)):
        want = torch.einsum("ij,i...->j...", t_op, x)
        torch.testing.assert_close(a, want, atol=1e-6, rtol=1e-6)
    eye = tpk.apply_operator_packed(tree, torch.eye(W))
    for a, x in zip(tree_leaves(eye), tree_leaves(tree)):
        assert torch.equal(a, x)
    a = torch.from_numpy(rng.random(W).astype(np.float32))
    avg = tpk.weighted_average_packed(tree, a)
    for u, x in zip(tree_leaves(avg), tree_leaves(tree)):
        torch.testing.assert_close(u, torch.tensordot(a, x, dims=1),
                                   atol=1e-6, rtol=1e-6)


def test_flat_path_switch():
    """Auto mode: off on the CPU, on for any other device; the override
    forces either way and None restores auto."""
    try:
        tpk.set_flat_paths(None)
        assert not tpk.flat_paths_enabled("cpu")
        assert not tpk.flat_paths_enabled(None)
        assert tpk.flat_paths_enabled("cuda")
        tpk.set_flat_paths(True)
        assert tpk.flat_paths_enabled("cpu")
        tpk.set_flat_paths(False)
        assert not tpk.flat_paths_enabled("cuda")
    finally:
        tpk.set_flat_paths(None)
