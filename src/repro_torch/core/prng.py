"""The counter-based draws of `jax.random`, reproduced bit for bit in numpy.

`protocol.gate_sample` draws the Bernoulli(p_i) gate of Eq. (3) as
``jax.random.uniform(fold_in(PRNGKey(seed), step), (W,))`` in the JAX
package.  This module computes the same float32 values without JAX, so the
port's gated trajectory is the reference's without injecting θ:

* the raw ``threefry2x32`` key type (JAX's default), 20 rounds;
* ``PRNGKey(seed)`` = ``[seed >> 32, seed & 0xFFFFFFFF]`` for a 32-bit seed
  (``[0, seed]`` without x64);
* ``fold_in(key, d)`` = ``threefry2x32(key, [0, d])``;
* ``uniform(key, (n,))`` under ``jax_threefry_partitionable=True`` (the
  default since jax 0.5): bits_i = y0 ^ y1 of ``threefry2x32(key, [0, i])``
  for the flat index i, then ``(bits >> 9) | 0x3F800000`` read as float32,
  minus 1.

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


def uniform(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,), jnp.float32)``: float32 in [0, 1)."""
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = (y0 ^ y1) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
