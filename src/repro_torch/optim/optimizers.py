"""Tree optimizers (counterpart of `repro/optim/optimizers.py`).

``sgd`` is the paper's optimizer (Algorithm 1 line 7 is a plain gradient
step).  ``momentum`` and ``adamw`` are substrate options; MLL-SGD averaging
applies to the parameters only.

Same contract as the JAX package: ``update(grads, state, params, step) ->
(new_params, new_state)``, functional, where ``step`` is a scalar or a
vector aligned with every leaf's leading axis (the protocol engine passes
per-worker update counts).  The arithmetic and its rounding order follow
the JAX versions: the learning rate is rounded to the parameter dtype
before the product, moments are float32.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Any], tuple[Tree, Tree]]


def _lr(lr: float, p: torch.Tensor) -> float:
    """``lr`` rounded to the parameter dtype (JAX's ``jnp.asarray(lr,
    p.dtype)``), as a Python scalar: the product then runs in float32 and
    rounds once, as the JAX product of two values of that dtype does, and
    no scalar is copied to the device per leaf."""
    return torch.tensor(lr, dtype=p.dtype).item()


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        new = tree_map(lambda p, g: p - _lr(lr, p) * g.to(p.dtype),
                       params, grads)
        return new, state
    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(_zeros_f32, params)

    def update(grads, state, params, step):
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        eff = (tree_map(lambda m, g: beta * m + g.float(), new_m, grads)
               if nesterov else new_m)
        new_p = tree_map(lambda p, m: p - _lr(lr, p) * m.to(p.dtype),
                         params, eff)
        return new_p, new_m
    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        # `step` is a scalar or a per-worker vector of ACTUAL update counts;
        # count 0 would give c = 0, and the guard keeps the math finite (the
        # engine discards that worker's update anyway)
        t = torch.as_tensor(step).to(torch.float32)
        c1 = torch.clamp(1.0 - torch.pow(b1, t), min=1e-12)
        c2 = torch.clamp(1.0 - torch.pow(b2, t), min=1e-12)
        new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                         state["m"], grads)
        new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                         state["v"], grads)

        def step_fn(p, m, v):
            c1l = c1.to(m.device).reshape(c1.shape + (1,) * (m.dim() - c1.dim()))
            c2l = c2.to(v.device).reshape(c2.shape + (1,) * (v.dim() - c2.dim()))
            upd = (m / c1l) / (torch.sqrt(v / c2l) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return p - _lr(lr, p) * upd.to(p.dtype)

        new_p = tree_map(step_fn, params, new_m, new_v)
        return new_p, {"m": new_m, "v": new_v}
    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adamw": adamw}


def get(name: str, lr: float, **kw) -> Optimizer:
    try:
        factory = OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{tuple(sorted(OPTIMIZERS))}") from None
    return factory(lr, **kw)
