"""Weights and states carried between the JAX package and the port, as
numpy arrays.

The JAX params tree and the port's params share every key and every leaf
layout (``wq (d, H, hd)``, ``wk``/``wv (d, Hkv, hd)``, ``wo (H, hd, d)``,
``bq (H, hd)``, ``w_gate``/``w_up (d, f)``, ``w_down (f, d)``,
``table (V, d)``, ``lm_head (d, V)``, norm ``scale``/``bias (d,)``), so a
leaf converts by copying.  The one structural difference is depth: the JAX
tree stacks all super-blocks on an axis of every ``blocks`` leaf,

    jax:  params["blocks"]["pos0"]["mixer"]["wq"]     (n_sb, d, H, hd)
    port: params["blocks"][i]["pos0"]["mixer"]["wq"]  (d, H, hd), i < n_sb

`tree_from_numpy` unstacks that axis into a list wherever a ``blocks`` dict
appears, and `tree_to_numpy` stacks it back.  In a worker-stacked tree
(every leaf with a leading worker axis W) the super-block axis is the
second one, ``(W, n_sb, ...)``: pass ``worker_axis=True``.
`train_state_from_numpy` carries a whole `MLLTrainState` (stacked params,
``{"inner", "counts"}``, mixing state, step).

`map_with_keys` walks a port tree in the JAX package's checkpoint key
scheme (``::``-joined paths, NamedTuple fields spelled ``.params``), which
`repro_torch.train.checkpoint` uses to read and write the JAX on-disk
format.

Only numpy crosses the boundary: the caller turns a JAX tree into numpy
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.  bfloat16
leaves (numpy dtype ``bfloat16`` from ``ml_dtypes``) are carried bit for
bit.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.tree import map_with_path, tree_leaves, tree_map

SEP = "::"


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")          # (ascontiguousarray makes 0-d 1-d)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy (never a view of the tensor's memory, which the port may
    update in place)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                # numpy's bfloat16, used only here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _block_axis(worker_axis: bool) -> int:
    return 1 if worker_axis else 0


def _is_blocks(path: tuple, node: Any) -> bool:
    """The port's list of super-blocks (a ``blocks`` key's list)."""
    return path[-1:] == ("blocks",) and isinstance(node, list)


def _is_stacked_blocks(path: tuple, node: Any) -> bool:
    """The JAX layout's stacked super-blocks (a ``blocks`` key's dict)."""
    return path[-1:] == ("blocks",) and isinstance(node, dict)


def _first_leaf(tree):
    return np.asarray(tree_leaves(tree)[0])


# ------------------------------------------------- nested trees <-> numpy
def tree_to_numpy(tree: Any, *, worker_axis: bool = False) -> Any:
    """A port tree -> the same tree in the JAX layout as numpy (each
    ``blocks`` list stacked into one dict; NamedTuples keep their type)."""
    ax = _block_axis(worker_axis)

    def conv(path, x):
        if _is_blocks(path, x):
            return tree_map(lambda *bs: np.stack([_to_numpy(b) for b in bs],
                                                 axis=ax), *x)
        return _to_numpy(x)
    return map_with_path(conv, tree, is_leaf=_is_blocks)


def tree_from_numpy(tree: Any, device: str | torch.device | None = None, *,
                    worker_axis: bool = False) -> Any:
    """Inverse of `tree_to_numpy` (each ``blocks`` dict unstacked into a
    list) on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    ax = _block_axis(worker_axis)

    def conv(path, x):
        if _is_stacked_blocks(path, x):
            return [tree_map(lambda a, i=i: _to_tensor(
                        np.take(np.asarray(a), i, ax), device), x)
                    for i in range(_first_leaf(x).shape[ax])]
        return _to_tensor(np.asarray(x), device)
    return map_with_path(conv, tree, is_leaf=_is_stacked_blocks)


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device | None = None) -> dict:
    """The JAX package's params as numpy -> the port's params on ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    n = _first_leaf(tree["blocks"]).shape[0]
    if n != cfg.num_super_blocks:
        raise ValueError(f"blocks leaves stack {n} super-blocks, "
                         f"{cfg.name} has {cfg.num_super_blocks}")
    return tree_from_numpy(tree, device)


def params_to_numpy(params: dict) -> dict:
    """Inverse of `params_from_numpy`: the JAX tree layout, as numpy."""
    return tree_to_numpy(params)


def train_state_from_numpy(state, device: str | torch.device | None = None):
    """Any (params, opt_state, mix_state, step) NamedTuple of JAX-layout
    numpy -- the JAX package's `MLLTrainState` after ``jax.tree.map(
    np.asarray, ...)`` -- -> the port's `MLLTrainState` on ``device``."""
    from repro_torch.core.protocol import MLLTrainState

    def conv(t):
        return tree_from_numpy(t, device, worker_axis=True)
    return MLLTrainState(conv(state.params), conv(state.opt_state),
                         conv(state.mix_state),
                         torch.tensor(int(np.asarray(state.step)),
                                      dtype=torch.int32))


# ------------------------------------------- flat, in checkpoint key scheme
def map_with_keys(fn: Callable[[str, int | None, Any], Any], tree: Any
                  ) -> Any:
    """``fn(key, block, leaf)`` over a port tree, rebuilding its structure.
    ``key`` is the leaf's JAX checkpoint key (``"blocks::pos0::mixer::wq"``,
    ``".params::embed::table"``); ``block`` is the super-block index of a
    leaf under a ``blocks`` list (the stacked axis of the JAX layout), else
    None."""
    def key(path):
        return SEP.join(str(p) for p in path)

    def visit(path, x):
        if _is_blocks(path, x):
            return [map_with_path(lambda p, y, i=i: fn(key(p), i, y), b,
                                  path=path) for i, b in enumerate(x)]
        return fn(key(path), None, x)
    return map_with_path(visit, tree, is_leaf=_is_blocks)


def _groups(tree: Any) -> dict[str, list]:
    """{key: [(block, leaf), ...]} of a port tree."""
    groups: dict[str, list] = {}
    map_with_keys(lambda k, b, x: groups.setdefault(k, []).append((b, x)),
                  tree)
    return groups


def leaf_spec(tree: Any, *, worker_axis: bool = False
              ) -> dict[str, tuple[tuple[int, ...], str]]:
    """{JAX key: (JAX-layout shape, numpy dtype name)} of a port tree,
    without copying any data."""
    ax = _block_axis(worker_axis)
    spec = {}
    for key, items in _groups(tree).items():
        x = items[0][1]
        shape = tuple(x.shape)
        if items[0][0] is not None:
            shape = shape[:ax] + (len(items),) + shape[ax:]
        spec[key] = (shape, str(x.dtype).replace("torch.", ""))
    return spec


def flatten(tree: Any, *, worker_axis: bool = False,
            convert: Callable[[torch.Tensor], np.ndarray] = _to_numpy
            ) -> dict[str, np.ndarray]:
    """{JAX key: numpy leaf in the JAX layout} of a port tree (super-blocks
    stacked on axis 0, or axis 1 under ``worker_axis``)."""
    ax = _block_axis(worker_axis)
    out = {}
    for key, items in _groups(tree).items():
        if items[0][0] is None:
            out[key] = convert(items[0][1])
        else:
            out[key] = np.stack([convert(x) for _, x in
                                 sorted(items, key=lambda bx: bx[0])], axis=ax)
    return out


def unflatten(flat, like: Any, *, worker_axis: bool = False,
              device: torch.device | None = None) -> Any:
    """A port tree shaped like ``like`` from {JAX key: JAX-layout numpy}
    (a dict or an open ``.npz``): each leaf takes its key's array, or its
    super-block's slice of it, in the array's own dtype, on ``device``
    (default: the ``like`` leaf's device)."""
    ax = _block_axis(worker_axis)
    cache: dict[str, np.ndarray] = {}

    def leaf(key, block, x):
        if key not in cache:
            cache[key] = np.asarray(flat[key])
        a = cache[key] if block is None else np.take(cache[key], block, ax)
        return _to_tensor(a, x.device if device is None else device)
    return map_with_keys(leaf, like)
