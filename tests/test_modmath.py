"""Property tests for modular arithmetic vs exact Python integers."""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_omr.ops.modmath import PrimeField

Q1 = 134215681  # reference FirstLevelField (2**27 - 2047)
Q2 = 1125899906826241  # reference SecondLevelField (2**50 - 16383)


@pytest.mark.parametrize("q", [Q1, Q2, (1 << 24) - 63, (1 << 30) - 173, (1 << 34) - 41, (1 << 47) - 115])
def test_mul_matches_python(q, rng):
    f = PrimeField(q)
    a = rng.integers(0, q, size=4096, dtype=np.int64)
    b = rng.integers(0, q, size=4096, dtype=np.int64)
    got = np.asarray(f.mul(jnp.asarray(a), jnp.asarray(b)))
    want = (a.astype(object) * b.astype(object)) % q
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("q", [Q1, Q2])
def test_mul_edge_values(q):
    f = PrimeField(q)
    edge = np.array([0, 1, 2, q - 1, q - 2, q // 2, q // 2 + 1], dtype=np.int64)
    a, b = np.meshgrid(edge, edge)
    a, b = a.ravel(), b.ravel()
    got = np.asarray(f.mul(jnp.asarray(a), jnp.asarray(b)))
    want = (a.astype(object) * b.astype(object)) % q
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("q", [Q1, Q2])
def test_mul_shoup(q, rng):
    f = PrimeField(q)
    x = rng.integers(0, q, size=2048, dtype=np.int64)
    w = rng.integers(0, q, size=2048, dtype=np.int64)
    w_sh = jnp.asarray(f.shoup(w))
    got = np.asarray(f.mul_shoup(jnp.asarray(x), jnp.asarray(w), w_sh))
    want = (x.astype(object) * w.astype(object)) % q
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("q", [Q1, Q2])
def test_add_sub_neg(q, rng):
    f = PrimeField(q)
    a = rng.integers(0, q, size=1000, dtype=np.int64)
    b = rng.integers(0, q, size=1000, dtype=np.int64)
    np.testing.assert_array_equal(
        np.asarray(f.add(jnp.asarray(a), jnp.asarray(b))), (a + b) % q
    )
    np.testing.assert_array_equal(
        np.asarray(f.sub(jnp.asarray(a), jnp.asarray(b))),
        np.mod(a - b, q),
    )
    np.testing.assert_array_equal(
        np.asarray(f.neg(jnp.asarray(a))), np.mod(-a, q)
    )


@pytest.mark.parametrize("q", [Q1, Q2])
def test_mod_sum(q, rng):
    f = PrimeField(q)
    x = rng.integers(0, q, size=(1000, 7), dtype=np.int64)
    got = np.asarray(f.mod_sum(jnp.asarray(x), axis=0))
    want = np.mod(x.astype(object).sum(axis=0), q)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_shoup_exact(rng):
    f = PrimeField(Q2)
    w = rng.integers(0, Q2, size=100, dtype=np.int64)
    got = f.shoup(w)
    want = (w.astype(object) << f.shoup_shift) // Q2
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_gaussian_noise_free():
    f = PrimeField(Q1)
    assert not f.gaussian(np.random.default_rng(0), 0.0, (10,)).any()
