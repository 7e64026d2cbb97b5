"""The transport under the mesh path's collectives (`torch.distributed`).

The JAX package lowers its averaging rounds to ``psum``, ``ppermute`` and
``all_gather`` inside ``shard_map``; the port's lowerings
(`core.protocol`'s ``*_spmd`` functions, `core.timeline`'s event operator)
call the three helpers below instead, one per collective:

* `all_reduce_sum` -- the sum over a group (the grouped subnet mean),
* `all_gather_rows` -- the rows of every rank of a group, in group order
  (dense mixing's contracted worker axis, the boundaries' u_k and
  checkpoints),
* `sendrecv` -- send a tensor to one rank and receive one of the same
  shape and dtype from another (one roll of the hub stage).

Each moves the tensor in its own dtype.  The transport follows the group's
backend and nothing else: under NCCL a CUDA tensor goes straight to the
collective; under gloo a CUDA tensor is copied to pinned host memory, moved
there, and copied back ("staging").  That is how several ranks share one
card (NCCL refuses two ranks on one GPU); the compute stays on the card,
and a failed collective raises.

Every call adds one to ``COUNTS[kind]`` (``"all_reduce"``,
``"all_gather"``, ``"sendrecv"``, ``"broadcast"``), so a run can show which
collectives its events made.  With `set_timing` on, ``SECONDS["stage"]``
and ``SECONDS["transfer"]`` add up the host time of the staging copies and
of the collectives themselves, each started after a device synchronise.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()
SECONDS = {"stage": 0.0, "transfer": 0.0}
_TIMING = False


def set_timing(on: bool) -> None:
    """Time the staging copies and the transfers (synchronises the card
    before each)."""
    global _TIMING
    _TIMING = on


def reset() -> None:
    """Zero ``COUNTS`` and ``SECONDS``."""
    COUNTS.clear()
    SECONDS.update(stage=0.0, transfer=0.0)


def _timed(key: str, like: torch.Tensor, fn: Callable[[], Any]) -> Any:
    if not _TIMING:
        return fn()
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
    t0 = time.perf_counter()
    out = fn()
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
    SECONDS[key] += time.perf_counter() - t0
    return out


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group, *, copy: bool) -> torch.Tensor:
    """``x`` as the collective takes it: a contiguous pinned host copy under
    gloo for a CUDA tensor, else ``x`` (contiguous; a copy if ``copy``,
    for collectives that write their input)."""
    if _staged(x, group):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return _timed("stage", x, lambda: host.copy_(x))
    if copy:
        return x.clone(memory_format=torch.contiguous_format)
    return x.contiguous()


def _empty_wire(x: torch.Tensor, group, shape: tuple) -> torch.Tensor:
    if _staged(x, group):
        return torch.empty(shape, dtype=x.dtype, pin_memory=True)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if buf.device == like.device:
        return buf
    return _timed("stage", like, lambda: buf.to(like.device))


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (a new tensor, on
    ``x``'s device, in ``x``'s dtype).  The library picks the add order:
    over two ranks the sum a + b is exact in any order, over three or more
    it may differ from a serial sum in the last bits."""
    COUNTS["all_reduce"] += 1
    buf = _wire(x, group, copy=True)
    _timed("transfer", x, lambda: dist.all_reduce(buf, group=group))
    return _back(buf, x)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n * rows, ...): the (rows, ...) tensors of the group's n ranks
    stacked in group rank order (the global ranks' order)."""
    COUNTS["all_gather"] += 1
    n = dist.get_world_size(group)
    buf = _wire(x, group, copy=False)
    out = _empty_wire(x, group, (n * x.shape[0],) + tuple(x.shape[1:]))
    _timed("transfer", x,
           lambda: dist.all_gather(list(out.chunk(n)), buf, group=group))
    return _back(out, x)


def sendrecv(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive a tensor of its shape
    and dtype from global rank ``src`` (both in ``group``)."""
    COUNTS["sendrecv"] += 1
    send = _wire(x, group, copy=False)
    recv = _empty_wire(x, group, tuple(x.shape))

    def move():
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]):
            work.wait()
    _timed("transfer", x, move)
    return _back(recv, x)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of global rank ``src`` on every rank of the world."""
    COUNTS["broadcast"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
