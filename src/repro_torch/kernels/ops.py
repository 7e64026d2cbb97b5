"""Public wrappers of the attention kernels (counterpart of
`repro/kernels/ops.py`).

On a CUDA tensor each wrapper launches its hand-written kernel
(`flash_attention` -> ``csrc/flash_fwd.cu``, `flash_decode` ->
``csrc/flash_decode.cu``) or raises; it never gives way to the plain version.
On a CPU tensor it runs the plain PyTorch version in `ref`, and only then.

Each wrapper counts its kernel launches in a plain integer attribute,
``flash_attention.launches`` and ``flash_decode.launches``, raised by one
right after each successful launch and nowhere else, so a run can show that
its path went through the kernels.  Forward only: the flash-attention
backward (K4) is not ported, so a CUDA input that requires grad raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def flash_attention_fwd_res(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, T, H, hd), k/v: (B, S, Hkv, hd) -> (o (B, T, H, hd),
    lse (B, H, T) float32)."""
    if not q.is_cuda:
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention on CUDA is forward only: its backward kernel "
            "(K4, repro/kernels/flash_attention.py::flash_attention_bwd) is "
            "not ported yet; see ROADMAP.md Queue 2")
    out = fa.flash_attention_fwd_res(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Blocked online-softmax attention: causal, sliding window, logit
    softcap, GQA.  -> (B, T, H, hd)."""
    return flash_attention_fwd_res(q, k, v, causal=causal, window=window,
                                   softcap=softcap)[0]


def flash_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor, lengths: torch.Tensor, *,
                 window: int = 0, softcap: float = 0.0,
                 num_splits: int = 0) -> torch.Tensor:
    """Single-query attention over a paged KV cache: q (B, H, hd) against a
    (num_blocks, block_size, Hkv, hd) pool through a (B, max_blocks) block
    table; split-KV with an exact logsumexp combine.  -> (B, H, hd)."""
    if not q.is_cuda:
        return ref.flash_decode_ref(q, k_pool, v_pool, block_tables, lengths,
                                    window=window, softcap=softcap)
    out = fa.flash_decode_paged(q, k_pool, v_pool, block_tables, lengths,
                                window=window, softcap=softcap,
                                num_splits=num_splits)
    flash_decode.launches += 1
    return out


flash_attention.launches = 0
flash_decode.launches = 0


def reset_launches() -> None:
    flash_attention.launches = 0
    flash_decode.launches = 0
