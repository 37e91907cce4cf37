"""NTT correctness: roundtrip, negacyclic convolution, monomial tables."""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.ops.ntt import NegacyclicNtt

Q1 = 134215681
Q2 = 1125899906826241


def negacyclic_mul_ref(a, b, q):
    """Schoolbook negacyclic convolution with exact Python ints."""
    n = len(a)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            if k < n:
                out[k] += ai * int(b[j])
            else:
                out[k - n] -= ai * int(b[j])
    return np.mod(out, q).astype(np.int64)


@pytest.mark.parametrize("q,n", [(Q1, 1024), (Q2, 2048), (Q1, 64)])
def test_roundtrip(q, n, rng):
    f = PrimeField(q)
    ntt = NegacyclicNtt(f, n)
    x = rng.integers(0, q, size=(n, 5), dtype=np.int64)
    y = np.asarray(ntt.inv(ntt.fwd(jnp.asarray(x))))
    np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("q,n", [(Q1, 64), (Q2, 128)])
def test_convolution(q, n, rng):
    f = PrimeField(q)
    ntt = NegacyclicNtt(f, n)
    a = rng.integers(0, q, size=n, dtype=np.int64)
    b = rng.integers(0, q, size=n, dtype=np.int64)
    an = ntt.fwd(jnp.asarray(a)[:, None])
    bn = ntt.fwd(jnp.asarray(b)[:, None])
    prod = np.asarray(ntt.inv(f.mul(an, bn)))[:, 0]
    np.testing.assert_array_equal(prod, negacyclic_mul_ref(a, b, q))


@pytest.mark.parametrize("q,n", [(Q1, 64), (Q2, 128)])
def test_monomial_tables(q, n, rng):
    """NTT(X^a - 1)[k] == tab[(orders[k] * a) % 2n] for every a."""
    f = PrimeField(q)
    ntt = NegacyclicNtt(f, n)
    tab, _ = ntt.monomial_minus_one_tables()
    tab = np.asarray(tab)
    for a in [0, 1, 2, n - 1, n, n + 3, 2 * n - 1]:
        poly = np.zeros(n, dtype=np.int64)
        poly[0] = q - 1
        if a < n:
            poly[a] = (poly[a] + 1) % q
        else:
            poly[a - n] = (poly[a - n] - 1) % q
        want = np.asarray(ntt.fwd(jnp.asarray(poly)[:, None]))[:, 0]
        e = (ntt.orders * a) % (2 * n)
        np.testing.assert_array_equal(tab[e], want)


def test_fwd_last_matches_axis0(rng):
    f = PrimeField(Q1)
    ntt = NegacyclicNtt(f, 64)
    x = rng.integers(0, Q1, size=(3, 64), dtype=np.int64)
    a = np.asarray(ntt.fwd_last(jnp.asarray(x)))
    b = np.asarray(ntt.fwd(jnp.asarray(x.T))).T
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "q,n,kind",
    [(Q1, 1024, "SmallFieldNtt"), (Q2, 2048, "PermutedNtt")],
)
def test_make_ntt_picks_class_per_field(q, n, kind):
    from tfhe_omr.core.context import make_ntt

    ntt = make_ntt(PrimeField(q), n)
    assert type(ntt).__name__ == kind
    if kind == "SmallFieldNtt":
        assert ntt.radices == [32, n // 32]


@pytest.mark.parametrize("q,n", [(Q1, 1024), (Q2, 2048)])
def test_make_ntt_roundtrip(q, n, rng):
    from tfhe_omr.core.context import make_ntt

    ntt = make_ntt(PrimeField(q), n)
    x = rng.integers(0, q, size=(n, 3), dtype=np.int64)
    y = np.asarray(ntt.inv(ntt.fwd(jnp.asarray(x))))
    np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("q,n", [(Q1, 1024), (Q2, 2048)])
def test_make_ntt_convolution(q, n, rng):
    """Pointwise product in make_ntt's domain == negacyclic convolution,
    against a ternary second operand (exact int64 reference)."""
    from tfhe_omr.core.context import make_ntt

    f = PrimeField(q)
    ntt = make_ntt(f, n)
    a = rng.integers(0, q, size=n, dtype=np.int64)
    t = rng.integers(-1, 2, size=n, dtype=np.int64)
    want = np.zeros(n, dtype=np.int64)
    for k in np.nonzero(t)[0]:
        shifted = np.concatenate([-a[n - k:], a[: n - k]])  # X^k * a
        want = np.mod(want + t[k] * shifted, q)
    an = ntt.fwd(jnp.asarray(a)[:, None])
    tn = ntt.fwd(jnp.asarray(np.mod(t, q))[:, None])
    got = np.asarray(ntt.inv(f.mul(an, tn)))[:, 0]
    np.testing.assert_array_equal(got, want)


def test_permuted_ntt_is_radix2_under_perm(rng):
    from tfhe_omr.ops.ntt import PermutedNtt

    f = PrimeField(Q2)
    pn = PermutedNtt(f, 2048)
    ref = NegacyclicNtt(f, 2048)
    x = jnp.asarray(rng.integers(0, Q2, size=(2048, 2), dtype=np.int64))
    fx = np.asarray(pn.fwd(x))
    np.testing.assert_array_equal(fx, np.asarray(ref.fwd(x))[pn._perm])
    np.testing.assert_array_equal(
        np.asarray(pn.inv(jnp.asarray(fx))), np.asarray(x)
    )
    np.testing.assert_array_equal(pn.orders, ref.orders[pn._perm])


def test_permuted_ntt_orders_match_monomial_exponents():
    """NTT(X^a - 1) in the permuted order is the psi-power table indexed by
    monomial_exponents(a), for a spread of rotation amounts."""
    from tfhe_omr.ops.ntt import PermutedNtt

    f = PrimeField(Q2)
    n = 2048
    pn = PermutedNtt(f, n)
    tab = np.asarray(pn.monomial_minus_one_tables()[0])
    amounts = np.array([0, 1, 5, n - 1, n, n + 7, 2 * n - 1], dtype=np.int64)
    polys = np.zeros((n, len(amounts)), dtype=np.int64)
    polys[0] = Q2 - 1
    for j, a in enumerate(amounts):
        if a < n:
            polys[a, j] = (polys[a, j] + 1) % Q2
        else:
            polys[a - n, j] = (polys[a - n, j] - 1) % Q2
    want = np.asarray(pn.fwd(jnp.asarray(polys)))
    e = np.asarray(pn.monomial_exponents(jnp.asarray(amounts)))
    np.testing.assert_array_equal(tab[e], want)
