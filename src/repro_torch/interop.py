"""Weights and states carried between the JAX package and the port, as
numpy arrays.

The JAX params tree and the port's params share every key and every leaf
layout (``wq (d, H, hd)``, ``wk``/``wv (d, Hkv, hd)``, ``wo (H, hd, d)``,
``bq (H, hd)``, ``w_gate``/``w_up (d, f)``, ``w_down (f, d)``,
``table (V, d)``, ``lm_head (d, V)``, norm ``scale``/``bias (d,)``; mamba's
``in_proj (d, 2 di)``, ``conv_w (K, di)``, ``a_log (di, N)``, ``dt_bias`` /
``d_skip (di,)``; MoE's ``router (d, E)``, ``w_gate`` / ``w_up (E, d, f)``,
``w_down (E, f, d)``), so a leaf converts by copying.  The one structural difference is depth: the JAX
tree stacks all super-blocks on an axis of every ``blocks`` leaf,

    jax:  params["blocks"]["pos0"]["mixer"]["wq"]     (n_sb, d, H, hd)
    port: params["blocks"][i]["pos0"]["mixer"]["wq"]  (d, H, hd), i < n_sb

`tree_from_numpy` unstacks that axis into a list wherever a ``blocks`` dict
appears, and `tree_to_numpy` stacks it back.  In a worker-stacked tree
(every leaf with a leading worker axis W) the super-block axis is the
second one, ``(W, n_sb, ...)``: pass ``worker_axis=True``.
`train_state_from_numpy` carries a whole `MLLTrainState` (stacked params,
``{"inner", "counts"}``, mixing state, step; PowerSGD's factors keep the
JAX layout, `mix_state_from_numpy`); `sim_carry_from_numpy` /
`sim_carry_to_numpy` carry a simulator carry (stacked params, opt state,
mixing state, PRNG key) both ways, the JAX key array becoming the
`core.prng` key pair.

`decode_state_from_numpy` / `decode_state_to_numpy` carry a dense decode
state (`models.model.init_decode_state`), whose JAX leaves stack the
super-blocks on axis 0 where the port keeps a list.

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


def decode_state_from_numpy(state: dict,
                            device: str | torch.device | None = None
                            ) -> list[dict]:
    """The JAX package's dense decode state as numpy (``{"pos{i}": leaves
    stacked on axis 0 over the super-blocks}``) -> the port's list of one
    state dict per super-block on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    return [tree_map(lambda a, i=i: _to_tensor(np.take(np.asarray(a), i, 0),
                                               device), state)
            for i in range(_first_leaf(state).shape[0])]


def decode_state_to_numpy(states: list[dict]) -> dict:
    """Inverse of `decode_state_from_numpy`: the JAX layout, as numpy."""
    return tree_map(lambda *xs: np.stack([_to_numpy(x) for x in xs]),
                    *states)


def mix_state_from_numpy(mix_state: Any,
                         device: str | torch.device | None = None) -> Any:
    """A worker-stacked mixing state of JAX-layout numpy -> the port's.
    PowerSGD's factor tree ``q`` keeps the JAX layout (one factor per JAX
    leaf, spanning all its super-blocks); everything else is unstacked as
    by `tree_from_numpy`."""
    if isinstance(mix_state, dict) and "q" in mix_state:
        dev = resolve_device(device)
        return {"ef": tree_from_numpy(mix_state["ef"], device,
                                      worker_axis=True),
                "q": tree_map(lambda a: _to_tensor(np.asarray(a), dev),
                              mix_state["q"])}
    return tree_from_numpy(mix_state, device, worker_axis=True)


def train_state_from_numpy(state, device: str | torch.device | None = None):
    """Any (params, opt_state, mix_state, step) NamedTuple of JAX-layout
    numpy -- the JAX package's `MLLTrainState` after ``jax.tree.map(
    np.asarray, ...)`` -- -> the port's `MLLTrainState` on ``device``."""
    from repro_torch.core.protocol import MLLTrainState

    def conv(t):
        return tree_from_numpy(t, device, worker_axis=True)
    return MLLTrainState(conv(state.params), conv(state.opt_state),
                         mix_state_from_numpy(state.mix_state, device),
                         torch.tensor(int(np.asarray(state.step)),
                                      dtype=torch.int32))


def sim_carry_from_numpy(carry, device: str | torch.device | None = None):
    """The JAX package's simulator carry ``(stacked, opt_state, mix_state,
    key)`` as numpy -> the port's carry on ``device`` (default ``cuda``);
    the (2,) uint32 key becomes `core.prng`'s ``(k0, k1)`` pair."""
    stacked, opt_state, mix_state, key = carry

    def conv(t):
        return tree_from_numpy(t, device, worker_axis=True)
    k = np.asarray(key, np.uint32).reshape(2)
    return (conv(stacked), conv(opt_state),
            mix_state_from_numpy(mix_state, device), (int(k[0]), int(k[1])))


def sim_carry_to_numpy(carry) -> tuple:
    """Inverse of `sim_carry_from_numpy`: the JAX layout, as numpy."""
    stacked, opt_state, mix_state, key = carry
    return (tree_to_numpy(stacked, worker_axis=True),
            tree_to_numpy(opt_state, worker_axis=True),
            tree_to_numpy(mix_state, worker_axis=True),
            np.asarray(key, np.uint32))


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


def map_groups(fn: Callable[[str, list, bool], Any], tree: Any) -> Any:
    """``fn(key, leaves, blocks)`` once per leaf of the JAX layout, in
    ``jax.tree.leaves`` order, -> the results as a tree in the JAX layout.
    ``leaves`` is the port's leaf, or under a ``blocks`` list the
    super-blocks' leaves in order (``blocks`` True: the JAX leaf stacks
    them on axis 1 of a worker-stacked tree)."""
    def key(path):
        return SEP.join(str(p) for p in path)

    def visit(path, x):
        if _is_blocks(path, x):
            return map_with_path(lambda p, *bs: fn(key(p), list(bs), True),
                                 x[0], *x[1:], path=path)
        return fn(key(path), [x], False)
    return map_with_path(visit, tree, is_leaf=_is_blocks)


def leaf_groups(tree: Any) -> list[tuple[str, list, bool]]:
    """`map_groups`' arguments as a list, in JAX leaf order."""
    out: list = []
    map_groups(lambda *args: out.append(args), tree)
    return out


def _groups(tree: Any) -> dict[str, list]:
    """{key: [(block, leaf), ...]} of a port tree."""
    return {k: [(i if blocks else None, x) for i, x in enumerate(leaves)]
            for k, leaves, blocks in leaf_groups(tree)}


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
