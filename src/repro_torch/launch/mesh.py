"""Process meshes over `torch.distributed` (counterpart of
`repro/launch/mesh.py`): one rank stands where one JAX device stands.

`make_mesh(shape, axes)` lays the ranks of an initialised world out
row-major (rank = the flat index of its coordinate, the order
`mesh_utils.create_device_mesh` gives JAX devices), and makes and joins
every process group the mesh path uses, once.  ``new_group`` is itself
collective -- every rank must create every group, in the same order -- so
no group is made later.  For each axis of size n > 1 and each line along
it (the ranks that differ only in that coordinate), there is one group for
each contiguous block of b ranks, for every b > 1 that divides n: b = n is
the whole line (dense mixing's all-gather, the hub rolls, the boundaries'
gathers), b = the shards of one sub-network is the replica group of the
subnet mean (the JAX package's ``protocol._subnet_groups``).  The `data`
axis gets its groups the same way; the mesh path replicates compute over
it and sends nothing along it.

`spawn(fn, world, *args, backend=, device=, **kwargs)` starts a local
world: one process per rank, each joining the world and running
``fn(*args, **kwargs)``.  The backend is always the caller's choice, never
switched here: ``"gloo"`` on the CPU and for several ranks that share one
card (NCCL refuses two ranks on one GPU), ``"nccl"`` when each rank has a
card of its own.  Under ``torchrun`` the world already exists and
`make_mesh` joins it.

The presets (`make_production_mesh`) are the JAX package's: a 256-rank
(data 16, model 16) mesh and a 512-rank one with a leading pod axis.
`mesh_axis_sizes` reads a `Mesh` built from its shape alone, with no
world behind it.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# every wait of a rank on another: a rank that never reaches a collective
# fails its peers after this long instead of hanging them
TIMEOUT = datetime.timedelta(seconds=60)

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (shape, axis names) layout of ranks and this rank's place in it.
    ``blocks[(axis, b)]`` is the process group of this rank's contiguous
    block of b ranks along ``axis`` (`make_mesh` fills it; a `Mesh` built
    from its shape alone has none and can only be read)."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int = 0
    blocks: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def coordinate(self) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def line(self, axis: str) -> tuple[int, ...]:
        """The global ranks along ``axis`` through this rank, by
        coordinate."""
        i = self.axis_names.index(axis)
        coord = list(self.coordinate)
        out = []
        for c in range(self.shape[i]):
            coord[i] = c
            out.append(int(np.ravel_multi_index(coord, self.shape)))
        return tuple(out)

    def axis_groups(self, axis: str) -> dict:
        """{b: group of this rank's block of b ranks along ``axis``}."""
        return {b: g for (a, b), g in self.blocks.items() if a == axis}


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def _divisors(n: int) -> list[int]:
    return [b for b in range(2, n + 1) if n % b == 0]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of the requested shape over ranks [0, prod(shape)) of the
    world, with every group it needs (see the module docstring).  Every
    rank of the world must call it, in the same order as its other
    groups.  Errors (rather than reshaping) when the world is too small."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} disagree on "
                         "rank")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} must be positive")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {dict(zip(axes, shape))}, found "
            f"{world} -- start them with repro_torch.launch.mesh.spawn, "
            f"or torchrun --nproc-per-node {n}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    blocks = {}
    for i, axis in enumerate(axes):
        others = [range(s) if j != i else range(1)
                  for j, s in enumerate(shape)]
        for start in np.ndindex(*(len(r) for r in others)):
            line = []
            for c in range(shape[i]):
                coord = list(start)
                coord[i] = c
                line.append(int(np.ravel_multi_index(coord, shape)))
            for b in _divisors(shape[i]):
                for lo in range(0, shape[i], b):
                    ranks = line[lo:lo + b]
                    group = dist.new_group(ranks, timeout=TIMEOUT)
                    if rank in ranks:
                        blocks[(axis, b)] = group
    if rank >= n:
        raise ValueError(f"rank {rank} lies outside the mesh of {n} ranks "
                         f"{dict(zip(axes, shape))}; start {n} ranks")
    # join every group now: NCCL builds a group's communicator at its first
    # collective, which would otherwise land in the first mixing event.
    # Each rank takes its groups in creation order, so the lowest group not
    # yet joined always has all its ranks waiting on it: no deadlock
    for group in blocks.values():
        on = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        dist.all_reduce(torch.zeros(1, device=on), group=group)
    return Mesh(shape, axes, rank, blocks)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return make_mesh(*PRODUCTION[multi_pod])


# ------------------------------------------------------------ local worlds
def _rank_main(rank: int, fn: Callable, world: int, tmp: str, backend: str,
               device: str, args: tuple, kwargs: dict) -> None:
    if torch.device(device).type == "cuda":
        # a rank that cannot reach its card fails; it never runs on the CPU
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.cuda.init()
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = fn(*args, **kwargs)
        torch.save(out, os.path.join(tmp, f"result-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args: Any, backend: str,
          device: str = "cpu", timeout: float = 600.0, **kwargs: Any
          ) -> list:
    """Run ``fn(*args, **kwargs)`` on ``world`` local ranks, one process
    each, and return their results in rank order.

    ``fn`` must be a module-level function (each process imports it anew)
    and return something `torch.save` can write; tensors come back on the
    CPU.  ``device="cuda"`` puts rank r on card r mod the card count;
    ``"cpu"`` runs each rank on one CPU thread.  The world's store is a
    file under a fresh temporary directory (no port to collide on).  A
    rank that raises stops the others and the error is raised here with
    its traceback; ranks still running after ``timeout`` seconds are
    stopped and `TimeoutError` is raised."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    with tempfile.TemporaryDirectory(prefix="repro-torch-mesh-") as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world, tmp, backend, str(device), args, kwargs),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"mesh ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()
        return [torch.load(os.path.join(tmp, f"result-{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
