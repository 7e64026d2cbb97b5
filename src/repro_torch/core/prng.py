"""The counter-based draws of `jax.random`, reproduced bit for bit in numpy.

`protocol.gate_sample` draws the Bernoulli(p_i) gate of Eq. (3) as
``jax.random.uniform(fold_in(PRNGKey(seed), step), (W,))`` in the JAX
package.  This module computes the same float32 values without JAX, so the
port's gated trajectory is the reference's without injecting θ:

* the raw ``threefry2x32`` key type (JAX's default), 20 rounds;
* ``PRNGKey(seed)`` = ``[seed >> 32, seed & 0xFFFFFFFF]`` for a 32-bit seed
  (``[0, seed]`` without x64);
* ``fold_in(key, d)`` = ``threefry2x32(key, [0, d])``;
* ``split(key, n)`` under ``jax_threefry_partitionable=True`` (the
  default since jax 0.5): key i is ``threefry2x32(key, [0, i])``, both
  words (JAX's ``_threefry_split_foldlike``);
* ``random_bits(key, n)``: bits_i = y0 ^ y1 of ``threefry2x32(key, [0, i])``
  for the flat index i;
* ``uniform(key, (n,))``: ``(bits >> 9) | 0x3F800000`` read as float32,
  minus 1;
* ``normal(key, (n,))``: a uniform on ``[nextafter(-1, 0), 1)`` (the
  ``[0, 1)`` draw times 2, plus the low end), then ``sqrt(2) *
  erf_inv(u)`` with XLA's single-precision ``erf_inv`` polynomial (Giles
  2010), its multiply-adds fused as XLA fuses them.  ``log1p`` is
  rounded from float64 here; XLA's own ``log1p`` is not always correctly
  rounded, so about 1% of the draws differ from ``jax.random.normal`` in
  the last bit or two (tests/test_torch_prng.py);
* ``randint(key, (n,), lo, hi)`` with int32: ``k1, k2 = split(key, 2)``,
  32 random bits from each, then ``((hi_bits % span) * m + lo_bits % span)
  % span`` with ``m = (2^16 % span)^2 % span``, in wrapping uint32 (JAX's
  ``_randint``);
* ``gumbel(key, (n,))`` in its default ``mode="low"``: a uniform on
  ``[tiny, 1)`` (the ``[0, 1)`` draw plus ``tiny``, floored at ``tiny``),
  then ``-log(-log(u))`` with XLA's float32 ``log`` on the CPU (Cephes'
  polynomial, its multiply-adds fused as XLA fuses them): every bit equal
  to ``jax.random.gumbel`` (tests/test_torch_prng.py);
* ``categorical(key, logits)`` along the last axis: ``argmax(gumbel(key,
  logits.shape) + logits)``, the lowest index on ties.

The simulator's sampler (`repro_torch.core.timeline`) draws its batch
indices and gates from these, so its trajectory is the JAX package's;
PowerSGD mixing draws its initial factors with `normal`; sampled
generation (`repro_torch.serve.serve_step`) draws with `categorical`.
The draws run on the host: a few words per step, or one per logit for
`categorical`, whose noise then moves to the logits' device.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _threefry(key: tuple[int, int], x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as in
    `jax._src.prng.threefry2x32`) over int64 numpy arrays or tensors that
    hold uint32 counter words: Python operators only, each result masked
    to 32 bits, so it runs unchanged on either and gives the same words."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """`_threefry` over uint32 counter words ``x0``, ``x1`` -> uint32."""
    y0, y1 = _threefry(key, np.asarray(x0, np.int64),
                       np.asarray(x1, np.int64))
    return y0.astype(np.uint32), y1.astype(np.uint32)


def _unit(bits):
    """The [0, 1) float32 of ``jax.random.uniform`` from 32 random bits (a
    uint32 array, or an int64 tensor holding uint32 words): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    m = (bits >> 9) | 0x3F800000
    if isinstance(m, np.ndarray):
        return m.astype(np.uint32).view(np.float32) - np.float32(1.0)
    import torch
    return m.int().view(torch.float32) - 1.0


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return 0, seed & 0xFFFFFFFF


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return int(y0[0]), int(y1[0])


def split(key: tuple[int, int], n: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, n)`` as ``n`` keys."""
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def random_bits(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), jnp.uint32)``."""
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return y0 ^ y1


def uniform(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,), jnp.float32)``: float32 in [0, 1)."""
    return _unit(random_bits(key, n))


def randint(key: tuple[int, int], n: int, lo: int, hi: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), lo, hi, jnp.int32)`` for int32
    bounds: int32 in [lo, hi) (``lo`` when ``hi <= lo``)."""
    if not (-2**31 <= lo < 2**31 and -2**31 <= hi < 2**31):
        raise ValueError(f"bounds [{lo}, {hi}) do not fit int32")
    k1, k2 = split(key, 2)
    span = np.uint32(max(hi - lo, 1))
    with np.errstate(over="ignore"):
        mult = np.uint32(2**16) % span
        mult = (mult * mult) % span
        off = (random_bits(k1, n) % span) * mult + random_bits(k2, n) % span
        off = off % span
        return (np.int64(lo) + off.astype(np.int64)).astype(np.int32)


# XLA's float32 erf_inv: p(w) for w = -log1p(-x^2) < 5 (at w - 2.5) and
# for w >= 5 (at sqrt(w) - 3), highest power first
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: ``x * p(w)`` with the Horner steps as
    fused multiply-adds (a float32 product is exact in float64, so one
    float64 add and a rounding to float32 stand in for the fused op)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):               # log1p(-1) = -inf
        w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, lo, hi).astype(np.float64)
        p = (p.astype(np.float64) * w + c).astype(np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1, x * np.float32(np.inf),
                        p * x).astype(np.float32)


def normal(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.normal(key, (n,), jnp.float32)`` (reshape the result
    for another shape: the draws follow the flat index)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, uniform(key, n) * (np.float32(1.0) - lo) + lo)
    return np.float32(np.sqrt(2)) * erf_inv(u)


# ------------------------------------------------ bulk draws, in torch
# `categorical` takes one draw per logit (~600 K a decode step at B = 4 and
# vocab 151936), so `gumbel` computes where the logits live: `_threefry`
# and `_unit` over int64 tensors holding uint32 words, and XLA's float32
# log with each fused multiply-add as a float64 add of an exact float32
# product, rounded to float32 once.  The same bits on any device.
# Cephes' logf polynomial in x - 1 on [sqrt(1/2), sqrt(2)), highest power
# first, and ln 2 split into a short and a long part
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _fma_t(a, b, c):
    """float32 ``a * b + c`` rounded once (tensors or float32 constants)."""
    import torch

    def wide(z):
        return z.double() if isinstance(z, torch.Tensor) else float(
            np.float32(z))
    return (wide(a) * wide(b) + wide(c)).float()


def log_f32(x):
    """XLA's float32 ``log`` on the CPU for a positive float32 tensor (what
    ``jnp.log`` computes there; ~14% of its results differ from the
    correctly rounded log): the exponent split off, the mantissa moved to
    [sqrt(1/2), sqrt(2)) and shifted by -1, the polynomial evaluated as
    three interleaved Horner chains of fused multiply-adds."""
    import torch
    f32 = np.float32
    bits = x.clamp(min=float(np.finfo(f32).tiny)).view(torch.int32).long()
    e = 1.0 + ((bits >> 23) - 127).float()
    m = ((bits & 0x807FFFFF) | 0x3F000000).int().view(torch.float32)
    low = m < float(f32(0.707106781186547524))
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma_t(_fma_t(m, p[0], p[1]), m, p[2])
    y1 = _fma_t(_fma_t(m, p[3], p[4]), m, p[5])
    y2 = _fma_t(_fma_t(m, p[6], p[7]), m, p[8])
    y = _fma_t(_fma_t(y, m3, y1), m3, y2)
    y = _fma_t(y, m3, e * float(f32(_LOG_Q1)))
    m = m - m2 * 0.5
    return (m + y) + e * float(f32(_LOG_Q2))


def gumbel(key: tuple[int, int], shape, device=None):
    """``jax.random.gumbel(key, shape, jnp.float32)`` (mode "low", the
    default) as a float32 tensor on ``device``, every bit equal: a uniform
    on [tiny, 1) (the [0, 1) draw plus tiny, floored at tiny), then
    ``-log(-log(u))``.  The draws follow the flat index."""
    import torch
    n = int(np.prod(shape))
    x1 = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry(key, torch.zeros_like(x1), x1)
    u = _unit(y0 ^ y1)
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.clamp(u * float(np.float32(1.0) - np.float32(tiny)) + tiny,
                    min=tiny)
    return (-log_f32(-log_f32(u))).reshape(shape)


def categorical(key: tuple[int, int], logits):
    """``jax.random.categorical(key, logits, axis=-1)`` for a float32
    tensor: the argmax over the last axis of the Gumbel noise (drawn on
    the logits' device) plus the logits, the lowest index on ties ->
    int64 indices of the row shape."""
    import torch
    noise = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(noise + logits, dim=-1)
