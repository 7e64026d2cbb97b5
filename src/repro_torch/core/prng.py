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
  ``_randint``).

The simulator's sampler (`repro_torch.core.timeline`) draws its batch
indices and gates from these, so its trajectory is the JAX package's;
PowerSGD mixing draws its initial factors with `normal`.
Everything here runs on the host; the draws are a few words per step.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as in
    `jax._src.prng.threefry2x32`) over uint32 counter words ``x0``, ``x1``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32).copy()
    x1 = np.asarray(x1, np.uint32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


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
    bits = random_bits(key, n) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


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
