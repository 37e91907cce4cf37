"""Gadget decomposition: exactness / error bounds of recomposition."""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_omr.ops.decompose import SignedGadget
from tfhe_omr.ops.modmath import PrimeField

Q1 = 134215681
Q2 = 1125899906826241


@pytest.mark.parametrize(
    "q,log_b,d",
    [(Q1, 5, 4), (Q2, 7, 6)],  # reference BSK1 / BSK2 bases
)
def test_approx_recompose_error(q, log_b, d, rng):
    f = PrimeField(q)
    g = SignedGadget(f, log_b, d)
    assert not g.exact
    x = rng.integers(0, q, size=4096, dtype=np.int64)
    digs = np.asarray(g.decompose(jnp.asarray(x)))
    assert np.abs(digs).max() <= (1 << log_b) // 2
    rec = g.recompose_host(digs)
    err = np.mod(x - rec, q)
    err = np.where(err > q // 2, err - q, err)
    bound = q // (2 << (log_b * d)) + d * (1 << log_b)
    assert np.abs(err).max() <= bound, (np.abs(err).max(), bound)


@pytest.mark.parametrize(
    "q,log_b,d",
    [(Q1, 1, 27), (Q2, 2, 25)],  # reference KSK / trace bases
)
def test_exact_recompose(q, log_b, d, rng):
    f = PrimeField(q)
    g = SignedGadget(f, log_b, d)
    assert g.exact
    x = rng.integers(0, q, size=4096, dtype=np.int64)
    digs = np.asarray(g.decompose(jnp.asarray(x)))
    assert digs.min() >= 0 and digs.max() < (1 << log_b)
    rec = g.recompose_host(digs)
    np.testing.assert_array_equal(rec, x)


def test_axis_param(rng):
    f = PrimeField(Q1)
    g = SignedGadget(f, 5, 4)
    x = rng.integers(0, Q1, size=(8, 3), dtype=np.int64)
    d0 = np.asarray(g.decompose(jnp.asarray(x), axis=0))
    d1 = np.asarray(g.decompose(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(d0.transpose(1, 0, 2), d1)
