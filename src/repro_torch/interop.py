"""Weights carried between the JAX package and the port, as numpy arrays.

The JAX params tree and the port's params share every key and every leaf
layout (``wq (d, H, hd)``, ``wk``/``wv (d, Hkv, hd)``, ``wo (H, hd, d)``,
``bq (H, hd)``, ``w_gate``/``w_up (d, f)``, ``w_down (f, d)``,
``table (V, d)``, ``lm_head (d, V)``, norm ``scale``/``bias (d,)``), so a
leaf converts by copying.  The one structural difference is depth: the JAX
tree stacks all super-blocks on a leading axis of every ``blocks`` leaf,

    jax:  params["blocks"]["pos0"]["mixer"]["wq"]     (n_sb, d, H, hd)
    port: params["blocks"][i]["pos0"]["mixer"]["wq"]  (d, H, hd), i < n_sb

and `params_from_numpy` unstacks that axis into a list while
`params_to_numpy` stacks it back.  Only numpy crosses the boundary: the
caller turns a JAX tree into numpy (``jax.tree.map(np.asarray, params)``);
nothing here imports JAX.  bfloat16 leaves (numpy dtype ``bfloat16`` from
``ml_dtypes``) are carried bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                # numpy's bfloat16, used only here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: list):
    """Per-super-block dicts of tensors -> one dict of stacked numpy."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([_to_numpy(t) for t in trees])


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device | None = None) -> dict:
    """The JAX package's params as numpy -> the port's params on ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    n = cfg.num_super_blocks

    def block(i):
        def take(a):
            if a.shape[0] != n:
                raise ValueError(f"blocks leaf of shape {a.shape} does not "
                                 f"stack {n} super-blocks ({cfg.name})")
            return _to_tensor(a[i], device)
        return _map(tree["blocks"], take)

    conv = functools.partial(_to_tensor, device=device)
    return {"embed": _map(tree["embed"], conv),
            "blocks": [block(i) for i in range(n)],
            "final_norm": _map(tree["final_norm"], conv)}


def params_to_numpy(params: dict) -> dict:
    """Inverse of `params_from_numpy`: the JAX tree layout, as numpy."""
    return {"embed": _map(params["embed"], _to_numpy),
            "blocks": _stack(params["blocks"]),
            "final_norm": _map(params["final_norm"], _to_numpy)}
