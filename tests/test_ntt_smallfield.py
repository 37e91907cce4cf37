"""Mixed-radix small-field NTT must agree with the radix-2 reference."""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.ops.ntt import NegacyclicNtt
from tfhe_omr.ops.ntt_smallfield import SmallFieldNtt

Q1 = 134215681


@pytest.mark.parametrize("q,n", [(Q1, 1024), (Q1, 64), (33551873, 256)])
def test_roundtrip_and_convolution(q, n, rng):
    f = PrimeField(q)
    sf = SmallFieldNtt(f, n)
    ref = NegacyclicNtt(f, n)
    x = rng.integers(0, q, size=(n, 4), dtype=np.int64)
    np.testing.assert_array_equal(
        np.asarray(sf.inv(sf.fwd(jnp.asarray(x)))), x
    )
    a = rng.integers(0, q, size=(n, 1), dtype=np.int64)
    b = rng.integers(0, q, size=(n, 1), dtype=np.int64)
    p_ref = np.asarray(
        ref.inv(f.mul(ref.fwd(jnp.asarray(a)), ref.fwd(jnp.asarray(b))))
    )
    p_sf = np.asarray(
        sf.inv(f.mul(sf.fwd(jnp.asarray(a)), sf.fwd(jnp.asarray(b))))
    )
    np.testing.assert_array_equal(p_ref, p_sf)


def test_monomial_tables(rng):
    q, n = Q1, 128
    f = PrimeField(q)
    sf = SmallFieldNtt(f, n)
    tab, _ = sf.monomial_minus_one_tables()
    tab = np.asarray(tab)
    for a in [0, 1, n - 1, n, 2 * n - 1]:
        poly = np.zeros((n, 1), dtype=np.int64)
        poly[0, 0] = q - 1
        if a < n:
            poly[a, 0] = (poly[a, 0] + 1) % q
        else:
            poly[a - n, 0] = (poly[a - n, 0] - 1) % q
        want = np.asarray(sf.fwd(jnp.asarray(poly)))[:, 0]
        e = (sf.orders * a) % (2 * n)
        np.testing.assert_array_equal(tab[e].astype(np.int64), want)


def test_storage_dtype(rng):
    f = PrimeField(Q1)
    sf = SmallFieldNtt(f, 64)
    x = rng.integers(0, Q1, size=(64, 3), dtype=np.int64)
    out = sf.fwd(jnp.asarray(x))
    assert out.dtype == f.storage_dtype
