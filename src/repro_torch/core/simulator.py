"""Stacked-worker helpers of the simulator (counterpart of the first part of
`repro/core/simulator.py`): replicate a model over the worker axis, take
the weighted average u = X a, apply a dense operator X <- X T.

The simulator itself (`simulate`, `SimConfig`) is not ported yet
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_map

Tree = Any


def replicate(params: Tree, num_workers: int) -> Tree:
    """Stack identical replicas along a new leading worker axis.  Unlike
    JAX's ``broadcast_to`` these are real copies: the port updates the
    workers in place."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((num_workers,) + tuple(x.shape))
        .contiguous(), params)


def weighted_average(stacked: Tree, a: torch.Tensor) -> Tree:
    """u = X a (Eq. 8).  As in JAX, ``tensordot(a f32, x)`` promotes: u of
    a bf16 fleet is float32."""
    def avg(x):
        dt = torch.promote_types(a.dtype, x.dtype)
        return torch.tensordot(a.to(x.device, dt), x.to(dt), dims=1)
    return tree_map(avg, stacked)


def apply_operator(stacked: Tree, t: torch.Tensor) -> Tree:
    """X <- X T for stacked leaves: new[j] = sum_i T[i, j] x_i (a new tree,
    promoted like JAX's einsum)."""
    def mix(x):
        dt = torch.promote_types(t.dtype, x.dtype)
        return torch.einsum("ij,i...->j...", t.to(x.device, dt), x.to(dt))
    return tree_map(mix, stacked)
