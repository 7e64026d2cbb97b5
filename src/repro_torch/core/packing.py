"""Flat packing of stacked (worker-leading) trees into one (W, C) buffer
(counterpart of `repro/core/packing.py`).

The protocol applies the same per-worker linear algebra to every leaf of a
stacked parameter tree: a (W, W) operator contraction, a weighted average,
a gated SGD update.  Dispatching those per leaf costs one kernel launch
per leaf and, for the fused update-mix kernel, one read of the (W, W)
operator per leaf.  This module defines the **packing contract** shared by
the flat torch paths (`apply_operator_packed`, `weighted_average_packed`,
used by `simulator.apply_operator` / `weighted_average`) and the fused
kernel over the packed buffer (`repro_torch.kernels.ops.hier_mix_packed`):

  * A `PackSpec` is cached per (tree structure, leaf shapes/dtypes): leaf
    i of the stacked tree owns columns ``[offset_i, offset_i + size_i)`` of
    a (W, total_cols) float32 buffer, in `repro_torch.tree.tree_leaves`
    order (dict entries by sorted key, as ``jax.tree.leaves``), so a tree
    of the same structure packs into the JAX package's column layout.
  * `pack` casts every leaf to float32 and concatenates the flattened
    per-worker rows into a new buffer (a tree of one float32 leaf packs
    into a view of it); `unpack` slices, reshapes and casts
    back to each leaf's dtype.  Round-tripping is exact for float32 leaves
    and one f32 -> leaf-dtype rounding for everything else -- the rounding
    the per-leaf f32-accumulating kernel performs too, so packed and
    per-leaf execution agree bit for bit.  A float32 leaf that `unpack`
    returns is a VIEW of the buffer (no copy).
  * Worker-axis contractions on the packed buffer (one (W, W) x (W, C)
    product) replace one dispatch per leaf.

The flat paths engage only when every leaf is float32 (`all_f32`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

Tree = Any


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Column range of one stacked leaf inside the packed buffer."""
    offset: int
    size: int                  # columns = prod(shape[1:]) (1 for (W,) leaves)
    shape: tuple[int, ...]     # full stacked shape, worker axis leading
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Cached layout of a stacked tree inside a (W, total_cols) buffer."""
    treedef: tuple             # `tree.tree_structure` of the stacked tree
    num_workers: int
    total_cols: int
    slots: tuple[LeafSlot, ...]


@functools.lru_cache(maxsize=256)
def _build_spec(treedef: tuple, meta: tuple) -> PackSpec:
    if any(not shape for shape, _ in meta) or \
            len({shape[0] for shape, _ in meta}) != 1:
        raise ValueError(
            f"every stacked leaf needs the same leading worker axis; "
            f"got shapes with first dims {[m[0][:1] for m in meta]}")
    slots, off = [], 0
    w = meta[0][0][0]
    for shape, dtype in meta:
        size = 1
        for d in shape[1:]:
            size *= d
        slots.append(LeafSlot(off, size, shape, dtype))
        off += size
    return PackSpec(treedef, w, off, tuple(slots))


def pack_spec(stacked: Tree) -> PackSpec:
    """Layout for a stacked tree (cached per structure + leaf shapes and
    dtypes)."""
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("cannot pack an empty tree")
    meta = tuple((tuple(x.shape), x.dtype) for x in leaves)
    return _build_spec(tree_structure(stacked), meta)


def shard_spec(spec: PackSpec, num_shards: int) -> PackSpec:
    """The per-shard layout of a worker-sharded packed buffer: each of
    ``num_shards`` shards packs its own (W/num_shards, sum C) block with
    UNCHANGED column slots, so ``shard_spec(pack_spec(full), n) ==
    pack_spec(local)`` and a dim-0 slice of the full buffer is the shard's
    packed buffer."""
    if num_shards < 1 or spec.num_workers % num_shards:
        raise ValueError(f"{num_shards} shards must divide the packed "
                         f"buffer's worker axis W={spec.num_workers}")
    w = spec.num_workers // num_shards
    slots = tuple(LeafSlot(s.offset, s.size, (w,) + s.shape[1:], s.dtype)
                  for s in spec.slots)
    return PackSpec(spec.treedef, w, spec.total_cols, slots)


@dataclasses.dataclass(frozen=True)
class PackChunk:
    """One contiguous column range [lo, hi) of the packed lane axis."""
    lo: int
    hi: int

    @property
    def size(self) -> int:
        return self.hi - self.lo


def chunk_views(spec: PackSpec, num_chunks: int) -> tuple[PackChunk, ...]:
    """Split the packed columns [0, total_cols) into at most ``num_chunks``
    contiguous `PackChunk` views for chunked mixing.  Boundaries land on
    multiples of 128 columns, as in the JAX package (there the TPU's lane
    tile; here they keep every chunk's start 16-byte aligned), so the
    chunks are the reference's; small buffers give fewer chunks.  Every
    packed-path contraction reduces over the WORKER axis only, so each
    column's arithmetic is independent of the chunking and chunked and
    single-launch execution agree bit for bit."""
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    c = spec.total_cols
    lanes = -(-c // 128)                 # 128-column groups in the buffer
    per = -(-lanes // num_chunks) * 128  # columns per chunk, 128-aligned
    chunks, lo = [], 0
    while lo < c:
        hi = min(lo + per, c)
        chunks.append(PackChunk(lo, hi))
        lo = hi
    return tuple(chunks)


def all_f32(stacked: Tree) -> bool:
    """True when every leaf is float32 -- the gating condition for the flat
    paths.  pack/unpack round-trips and the packed kernel are then exactly
    bit-compatible with their per-leaf equivalents; the flat torch products
    (`apply_operator_packed` / `weighted_average_packed`) keep float32 but
    may reduce in another order than per-leaf products, so those agree to
    reduction order (tested at 1e-6), not necessarily to the ulp."""
    return all(x.dtype == torch.float32 for x in tree_leaves(stacked))


# The flat paths trade one launch per leaf for two packed-buffer copies.
# The JAX package enables them on the TPU only (dispatch-bound); on the CPU
# copy bandwidth is the bottleneck and per-leaf wins.  The port's card is
# host-bound too: eager PyTorch pays ~30 us of host time per device
# operation (PERF.md section 5) against ~5 ms to copy a 494 M-parameter
# fleet of 4 workers at 3.35 TB/s, so auto mode is "not the CPU": packed
# on a CUDA device, per leaf on the CPU.
_FLAT_OVERRIDE: bool | None = None


def set_flat_paths(enabled: bool | None) -> None:
    """Force the flat mixing paths on/off (None = auto: off the CPU)."""
    global _FLAT_OVERRIDE
    _FLAT_OVERRIDE = enabled


def flat_paths_enabled(device: torch.device | str | None = None) -> bool:
    """Whether the flat paths run for tensors on ``device`` (auto: any
    device but the CPU; None counts as the CPU)."""
    if _FLAT_OVERRIDE is not None:
        return _FLAT_OVERRIDE
    return device is not None and torch.device(device).type != "cpu"


def pack(stacked: Tree, spec: PackSpec | None = None) -> torch.Tensor:
    """Stacked tree -> (W, total_cols) float32 buffer (leaf order): a new
    buffer, or for a tree of one contiguous float32 leaf that leaf itself
    reshaped (the packed paths only read it)."""
    spec = spec or pack_spec(stacked)
    leaves = tree_leaves(stacked)
    if len(leaves) == 1:
        return leaves[0].reshape(spec.num_workers, -1).float()
    return torch.cat([x.reshape(spec.num_workers, -1).float()
                      for x in leaves], dim=1)


def unpack(buf: torch.Tensor, spec: PackSpec) -> Tree:
    """(W, >= total_cols) buffer -> stacked tree (extra columns ignored).
    float32 leaves are views of ``buf``; others are cast copies."""
    leaves = [buf[:spec.num_workers, s.offset:s.offset + s.size]
              .reshape(s.shape).to(s.dtype) for s in spec.slots]
    return tree_unflatten(spec.treedef, leaves)


def unpack_row(row: torch.Tensor, spec: PackSpec) -> Tree:
    """(total_cols,) reduced buffer -> tree WITHOUT the worker axis (the
    `weighted_average` result layout)."""
    leaves = [row[s.offset:s.offset + s.size].reshape(s.shape[1:])
              .to(s.dtype) for s in spec.slots]
    return tree_unflatten(spec.treedef, leaves)


# ---------------------------------------------------------- flat torch paths
def apply_operator_packed(stacked: Tree, t: torch.Tensor) -> Tree:
    """X <- X T as ONE (W, W) x (W, C) product over the packed buffer
    instead of one per leaf (a new tree).  Caller guarantees
    `all_f32(stacked)`."""
    spec = pack_spec(stacked)
    buf = pack(stacked, spec)
    out = torch.einsum("ij,ic->jc", t.to(buf.device, torch.float32), buf)
    return unpack(out, spec)


def weighted_average_packed(stacked: Tree, a: torch.Tensor) -> Tree:
    """u = X a as one (W,) x (W, C) contraction over the packed buffer.
    Caller guarantees `all_f32(stacked)`."""
    spec = pack_spec(stacked)
    buf = pack(stacked, spec)
    return unpack_row(torch.einsum("i,ic->c", a.to(buf.device,
                                                     torch.float32), buf),
                      spec)
