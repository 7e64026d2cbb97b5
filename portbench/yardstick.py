"""The yardstick: the card's published peaks and the operations and bytes
that a kernel's call and a training step need, from their shapes.

The kernels' formulas are copied from the program's bounds
(`repro_torch.kernels.ops.attention_fwd_work`, ``attention_bwd_work``)
so that a later change of the program cannot move the yardstick.  Each input byte is read once and each output byte written
once; the FLOPs are those of the products the algorithm needs.
"""
from __future__ import annotations

import functools
import math

# NVIDIA H100 SXM, dense, at the 700 W power limit (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


@functools.lru_cache(maxsize=None)
def live_pairs(t: int, s: int, window: int, causal: bool) -> int:
    """(query, key) pairs left live by causal and window masking."""
    if not causal:
        return t * s
    total = 0
    for i in range(t):
        hi = min(i, s - 1) + 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def attention_fwd_work(q_shape, k_shape, dtype: str, causal: bool,
                       window: int) -> tuple[float, float]:
    """K3: q, k, v read and o written once, lse written; two products of
    hd per live pair."""
    b, t, h, hd = q_shape
    es = ITEMSIZE[dtype]
    nq, nk = math.prod(q_shape), math.prod(k_shape)
    nbytes = es * (2 * nq + 2 * nk) + 4 * b * h * t
    flops = 4 * hd * h * b * live_pairs(t, k_shape[1], window, causal)
    return float(flops), float(nbytes)


def attention_bwd_work(q_shape, k_shape, dtype: str, causal: bool,
                       window: int) -> tuple[float, float]:
    """K4: q, o, do, k, v and lse read once, dq, dk, dv written once; five
    products of hd per live pair."""
    b, t, h, hd = q_shape
    es = ITEMSIZE[dtype]
    nq, nk = math.prod(q_shape), math.prod(k_shape)
    nbytes = es * (4 * nq + 4 * nk) + 4 * b * h * t
    flops = 10 * hd * h * b * live_pairs(t, k_shape[1], window, causal)
    return float(flops), float(nbytes)


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The roofline: the larger of the operations over the peak rate of
    ``dtype`` and the bytes over the memory's peak bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)


def train_flops(params: int, tokens_per_seq: int, sequences: int,
                quadratic_width: int) -> float:
    """FLOPs of one forward and backward over ``sequences`` sequences:
    6 per parameter and token, plus 12 x width per causal (query, key)
    pair of the layers that mix positions quadratically (attention's
    two products, H hd wide; the mLSTM's, its projection wide)."""
    pairs = tokens_per_seq * (tokens_per_seq + 1) // 2
    return float(6 * params * tokens_per_seq * sequences
                 + 12 * quadratic_width * pairs * sequences)
