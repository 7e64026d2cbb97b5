"""Paged/block KV cache for the batched serving engine (counterpart of
`repro/serve/kv_cache.py`).

Layout: one shared pool of ``num_blocks`` fixed-size blocks per attention
layer, shape (num_blocks, block_size, Hkv, head_dim).  A request's cache is
a row of the BLOCK TABLE -- (max_batch, max_blocks_per_seq) int32 physical
block ids.  Logical token position p of lane b lives at
``pool[table[b, p // block_size], p % block_size]``.

Unlike the JAX version, the writes update the pools IN PLACE (no copy of a
whole pool per token) and return them.  PyTorch has no drop mode for an
out-of-range scatter (on CUDA it is a device-side assert), so writes for
inactive lanes and prompt pads are filtered out with the mask before the
scatter instead of being routed to a one-past-the-end sentinel.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Geometry of the block pool (shared by every attention layer)."""
    block_size: int = 16          # tokens per block
    num_blocks: int = 128         # physical blocks in the pool
    max_len: int = 256            # max context (prompt + generated) per seq

    def __post_init__(self):
        if self.block_size <= 0 or self.num_blocks <= 0:
            raise ValueError("block_size and num_blocks must be positive")
        if self.max_len > self.block_size * self.num_blocks:
            raise ValueError(
                f"max_len={self.max_len} cannot fit in the pool "
                f"({self.num_blocks} x {self.block_size} tokens)")

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_size)

    def blocks_for(self, tokens: int) -> int:
        """Physical blocks a context of ``tokens`` tokens occupies."""
        return -(-tokens // self.block_size)


def init_layer_pools(pc: PagedCacheConfig, n_kv_heads: int, head_dim: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> dict[str, torch.Tensor]:
    """One attention layer's {k_pool, v_pool}, zero-filled."""
    shape = (pc.num_blocks, pc.block_size, n_kv_heads, head_dim)
    return {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device)}


def _flat_write(pool: torch.Tensor, flat_idx: torch.Tensor,
                values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Write rows ``values[keep]`` (N, Hkv, hd) at flat token slots
    ``flat_idx[keep]`` of the pool, in place.  The kept slots are distinct
    (lanes own disjoint blocks), so the scatter has no write race."""
    nb, bs = pool.shape[:2]
    flat = pool.view(nb * bs, *pool.shape[2:])
    flat.index_copy_(0, flat_idx[keep], values[keep].to(pool.dtype))
    return pool


def write_token_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   block_tables: torch.Tensor, positions: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-phase write: one new token per lane.

    k/v: (B, Hkv, hd); positions: (B,) absolute position of the new token,
    negative = inactive lane (not written)."""
    bs = k_pool.shape[1]
    positions = positions.long()
    safe = positions.clamp(min=0)
    blk = torch.gather(block_tables.long(), 1, (safe // bs)[:, None])[:, 0]
    flat = blk * bs + safe % bs
    keep = positions >= 0
    return (_flat_write(k_pool, flat, k, keep),
            _flat_write(v_pool, flat, v, keep))


def write_prefill_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor,
                     block_tables: torch.Tensor, plens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill-phase write: a whole (padded) prompt per lane in one scatter.

    k/v: (B, S, Hkv, hd) from the batched forward pass; plens: (B,) -- only
    positions < plens[b] are written (the pad tail is not)."""
    bs = k_pool.shape[1]
    b, s = k.shape[:2]
    pos = torch.arange(s, device=k.device).expand(b, s)
    blk = torch.gather(block_tables.long(), 1, pos // bs)          # (B, S)
    flat = (blk * bs + pos % bs).reshape(-1)
    keep = (pos < plens.long()[:, None]).reshape(-1)
    return (_flat_write(k_pool, flat, k.reshape(b * s, *k.shape[2:]), keep),
            _flat_write(v_pool, flat, v.reshape(b * s, *v.shape[2:]), keep))


def gather_kv(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Dense view of a paged pool: (B, max_blocks * block_size, Hkv, hd) in
    logical position order (the plain decode path's input)."""
    b, nmax = block_tables.shape
    bs = pool.shape[1]
    return pool[block_tables.long()].reshape(b, nmax * bs, *pool.shape[2:])


class BlockAllocator:
    """Host-side free list over the physical block ids.

    Allocation is all-or-nothing (a request either gets its full worst-case
    block budget at admission or stays queued), so decode can never run out
    of blocks mid-request.  Freed blocks go back LIFO -- a finished
    request's blocks are the next ones reassigned.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> block 0 first

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n physical blocks, or None (and no change) if not enough free."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for blk in blocks:
            if not 0 <= blk < self.num_blocks:
                raise ValueError(f"freeing unknown block {blk}")
            if blk in self._free:
                raise ValueError(f"double free of block {blk}")
            self._free.append(blk)
