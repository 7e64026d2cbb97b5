"""The port's `jax.random.split`, `jax.random.randint` and
`jax.random.normal` (numpy threefry-2x32, `repro_torch.core.prng`) against
JAX's.

The simulator's sampler draws its per-worker batch indices and its gate
from these (``key, kb, kg = split(key, 3)``, ``split(kb, W)``, ``randint``
per worker, ``uniform(kg, (W,))``), so the tolerance is exact equality
over a grid of seeds, counts and ranges.  PowerSGD mixing draws its
initial factors with ``normal``: the uniform draw underneath is exact, and
``sqrt(2) * erf_inv(u)`` follows XLA's polynomial with fused
multiply-adds but a float64 ``log1p``, so at most 2% of the draws may
differ, each by at most 2 float32 ulps (rtol 3e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_split_is_jax_random_split_bit_for_bit(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for n in (1, 2, 3, 7, 33, 100):
        want = np.asarray(jax.random.split(key, n))
        got = np.asarray(prng.split(tkey, n), np.uint32)
        np.testing.assert_array_equal(got, want)
    # nested splits, as the sampler takes them
    k, kb, kg = jax.random.split(key, 3)
    tk, tkb, tkg = prng.split(tkey, 3)
    np.testing.assert_array_equal(np.asarray(jax.random.split(kb, 5)),
                                  np.asarray(prng.split(tkb, 5), np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kg, (9,))).view(np.uint32),
        prng.uniform(tkg, 9).view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_is_jax_random_randint_bit_for_bit(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for n in (1, 4, 16, 33):
        for lo, hi in ((0, 1), (0, 2), (0, 5), (0, 64), (0, 1000),
                       (0, 2**31 - 1), (-3, 7), (-2**31, 2**31 - 1),
                       (5, 5), (9, 2)):
            want = np.asarray(jax.random.randint(key, (n,), lo, hi,
                                                 jnp.int32))
            got = prng.randint(tkey, n, lo, hi)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=f"{lo} {hi}")


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.prng_key(0), 3, 0, 2**31)


@pytest.mark.parametrize("seed", SEEDS + [12345])
def test_normal_is_jax_random_normal_to_two_ulps(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape in ((1,), (7, 3), (1000, 2), (5, 1), (50_000,)):
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = prng.normal(tkey, int(np.prod(shape))).reshape(shape)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=0,
                                   err_msg=str(shape))
        assert (got != want).mean() <= 0.02, shape
    # the uniform underneath is the reference's, bit for bit
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want_u = np.asarray(jax.random.uniform(key, (999,), jnp.float32, lo, 1.0))
    got_u = np.maximum(lo, prng.uniform(tkey, 999) * (np.float32(1) - lo)
                       + lo)
    np.testing.assert_array_equal(got_u, want_u)


def test_erf_inv_edges():
    x = np.array([-1.0, 1.0, 0.0, -0.0, 0.5, -0.999], np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(x)
    assert np.isinf(got[:2]).all() and (np.sign(got[:2]) == [-1, 1]).all()
    np.testing.assert_allclose(got[2:], want[2:], rtol=3e-7, atol=0)
