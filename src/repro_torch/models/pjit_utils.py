"""Logical-axis sharding annotations (counterpart of
`repro/models/pjit_utils.py`).

Model code may name a tensor's dims by *logical* axis ("heads", "mlp",
"act_batch", ...); `logical_sharding` installs a mapping from those names
to mesh axes, and `spec_for` resolves names to the port's partition spec:
a tuple holding, per dim, a mesh-axis name, a tuple of them, or ``None``
(replicated) -- what the JAX package's ``PartitionSpec`` holds.

The port never shards inside a worker at runtime (a rank holds whole
workers, `launch.harness`), so `constraint` places nothing: it checks the
names against the tensor's rank under an installed mesh, as the JAX
package's does, and returns the tensor.  The rules and specs feed the
dry run's per-chip byte counts (`launch.dryrun`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

_STATE = threading.local()

PartitionSpec = tuple


def _rules() -> dict | None:
    return getattr(_STATE, "rules", None)


def _mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def logical_sharding(mesh, rules: dict[str, str | tuple[str, ...] | None]):
    """Install ``logical name -> mesh axis (or None)`` rules for
    `spec_for` and `constraint` over ``mesh`` (a `launch.mesh.Mesh`)."""
    prev_rules, prev_mesh = _rules(), _mesh()
    _STATE.rules, _STATE.mesh = dict(rules), mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh = prev_rules, prev_mesh


def spec_for(names: Sequence[str | None]) -> PartitionSpec:
    """Translate logical axis names to a partition spec under the current
    rules (an unknown name replicates)."""
    rules = _rules() or {}
    return tuple(None if n is None else rules.get(n) for n in names)


def constraint(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """The JAX package's ``with_sharding_constraint`` by logical names: an
    identity here (nothing is placed), which still checks the names
    against ``x``'s rank when a mesh is installed."""
    if _mesh() is None:
        return x
    if len(names) != x.dim():
        raise ValueError(f"constraint rank mismatch: {names} vs shape "
                         f"{tuple(x.shape)}")
    return x
