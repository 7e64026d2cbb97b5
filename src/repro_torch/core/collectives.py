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

A fourth, `gather_rows_to_host`, gathers the rows to ONE rank's host
memory (the boundaries' checkpoints: the JAX package's ``device_get``).

Every call adds one to ``COUNTS[kind]`` (``"all_reduce"``,
``"all_gather"``, ``"gather"``, ``"sendrecv"``, ``"broadcast"``) and the
bytes of the result this rank receives to ``BYTES[kind]``, so a run can
show which collectives its events made and what they brought in.  With
`set_timing` on, ``SECONDS["stage"]`` and ``SECONDS["transfer"]`` add up
the host time of the staging copies and of the collectives themselves,
each started after a device synchronise.

**Counting without a world.**  Handed a ``meta`` tensor, the three mixing
helpers move nothing and touch no ``torch.distributed`` state: they return
a ``meta`` result of the right shape, and the group may be a `StandInGroup`
(the ranks of a mesh built from its shape alone).  While a list is
installed with `record_into` (`launch.cost_analysis.CostCounter` installs
one), every helper, on any device, appends a `CollectiveRecord` -- kind,
result bytes, this rank and the ranks it exchanged with -- so a count does
not depend on where it ran.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
SECONDS = {"stage": 0.0, "transfer": 0.0}
_TIMING = False
_RECORDS: list | None = None


@dataclasses.dataclass(frozen=True)
class StandInGroup:
    """A process group with no world behind it: the global ``ranks`` of a
    group of a shape-only mesh, and the ``rank`` that holds it.  The
    helpers take it with ``meta`` tensors only."""
    ranks: tuple[int, ...]
    rank: int


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as this rank saw it: ``kind``, the ``bytes`` of the
    result it received (the JAX package's HLO count: result bytes),
    ``rank`` (this rank) and ``peers`` (the group's ranks; for a send /
    recv, the rank received from)."""
    kind: str
    bytes: int
    rank: int
    peers: tuple[int, ...]


@contextlib.contextmanager
def record_into(records: list):
    """Append a `CollectiveRecord` to ``records`` for every helper call
    inside the block."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, records
    try:
        yield records
    finally:
        _RECORDS = prev


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _ranks(group) -> tuple[tuple[int, ...], int]:
    """(the group's global ranks, this rank)."""
    if isinstance(group, StandInGroup):
        return group.ranks, group.rank
    return tuple(dist.get_process_group_ranks(group)), dist.get_rank()


def _count(kind: str, group, shape, dtype: torch.dtype,
           peers: tuple[int, ...] | None = None) -> None:
    COUNTS[kind] += 1
    nb = _nbytes(shape, dtype)
    BYTES[kind] += nb
    if _RECORDS is not None:
        ranks, me = _ranks(group)
        _RECORDS.append(CollectiveRecord(kind, nb, me,
                                         ranks if peers is None else peers))


def _meta(x: torch.Tensor, group) -> bool:
    if x.device.type == "meta":
        return True
    if isinstance(group, StandInGroup):
        raise ValueError("a stand-in group moves nothing: hand it meta "
                         "tensors")
    return False


def set_timing(on: bool) -> None:
    """Time the staging copies and the transfers (synchronises the card
    before each)."""
    global _TIMING
    _TIMING = on


def reset() -> None:
    """Zero ``COUNTS``, ``BYTES`` and ``SECONDS``."""
    COUNTS.clear()
    BYTES.clear()
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
    _count("all_reduce", group, x.shape, x.dtype)
    if _meta(x, group):
        return torch.empty_like(x)
    buf = _wire(x, group, copy=True)
    _timed("transfer", x, lambda: dist.all_reduce(buf, group=group))
    return _back(buf, x)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n * rows, ...): the (rows, ...) tensors of the group's n ranks
    stacked in group rank order (the global ranks' order)."""
    n = len(_ranks(group)[0])
    shape = (n * x.shape[0],) + tuple(x.shape[1:])
    _count("all_gather", group, shape, x.dtype)
    if _meta(x, group):
        return x.new_empty(shape)
    buf = _wire(x, group, copy=False)
    out = _empty_wire(x, group, shape)
    _timed("transfer", x,
           lambda: dist.all_gather(list(out.chunk(n)), buf, group=group))
    return _back(out, x)


def gather_rows_to_host(x: torch.Tensor, dst: int, group
                        ) -> torch.Tensor | None:
    """On global rank ``dst``: the (n * rows, ...) rows of the group's n
    ranks in group rank order, in host memory; on the others ``None``
    (they only send).  Only ``dst`` counts the received bytes."""
    ranks, me = _ranks(group)
    n = len(ranks)
    shape = (n * x.shape[0],) + tuple(x.shape[1:])
    COUNTS["gather"] += 1
    if me == dst:
        BYTES["gather"] += _nbytes(shape, x.dtype)
    buf = _wire(x, group, copy=False)
    out = (torch.empty(shape, dtype=x.dtype, device=buf.device)
           if me == dst else None)
    _timed("transfer", x, lambda: dist.gather(
        buf, list(out.chunk(n)) if out is not None else None, dst=dst,
        group=group))
    if out is None:
        return None
    return out if out.device.type == "cpu" else out.cpu()


def sendrecv(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive a tensor of its shape
    and dtype from global rank ``src`` (both in ``group``)."""
    _count("sendrecv", group, x.shape, x.dtype, peers=(src,))
    if _meta(x, group):
        return torch.empty_like(x)
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
