"""Public wrappers of the attention kernels (counterpart of
`repro/kernels/ops.py`).

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
it never gives way to the plain version.  On a CPU tensor it runs the plain
PyTorch version in `ref`, and only then.

* `flash_attention` is differentiable end to end through the kernels, as
  the JAX package's `jax.custom_vjp` is: a `torch.autograd.Function` whose
  forward launches the flash-attention forward (``csrc/flash_fwd.cu``) and
  saves (q, k, v, o, lse), and whose backward launches the recomputation
  backward (``csrc/flash_bwd.cu``) from that lse -- the forward is never
  recomputed.
* `flash_attention_fwd_res` (o and lse) and `flash_attention_bwd` are the
  two halves, for callers that need them apart.
* `flash_decode` runs the paged flash-decode (``csrc/flash_decode.cu``);
  decode never differentiates.

Each kernel's launches are counted in a plain integer attribute --
``flash_attention.launches`` (forward), ``flash_attention_bwd.launches``
and ``flash_decode.launches`` -- raised by one right after each successful
launch and nowhere else, so a run can show that its path went through the
kernels.
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
    lse (B, H, T) float32).  Not differentiable itself (gradients go
    through `flash_attention`)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_attention_fwd_res records no gradient; call "
            "flash_attention to differentiate through the kernels")
    if not q.is_cuda:
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
    out = fa.flash_attention_fwd_res(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recomputation backward from the forward's (o, lse): -> (dq, dk, dv)
    in the primal shapes and dtypes."""
    if not q.is_cuda:
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                           window=window, softcap=softcap)
    out = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window, softcap=softcap)
    flash_attention_bwd.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward K3, backward K4 from the saved lse (`jax.custom_vjp` in the
    JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_fwd_res(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Blocked online-softmax attention: causal, sliding window, logit
    softcap, GQA.  -> (B, T, H, hd); differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
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
flash_attention_bwd.launches = 0
flash_decode.launches = 0


def reset_launches() -> None:
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    flash_decode.launches = 0
