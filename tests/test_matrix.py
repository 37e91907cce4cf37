"""Matrix solver tests (numpy and native paths must agree and be correct)."""

import numpy as np
import pytest

from tfhe_omr.core.errors import InvertibleMatrixError
from tfhe_omr.core.matrix import solve_matrix_numpy


def random_system(rng, rows, cols, plen, p):
    x = rng.integers(0, p, size=(cols, plen), dtype=np.int64)
    m = rng.integers(0, p, size=(rows, cols), dtype=np.int64)
    rhs = np.mod(m @ x, p)
    return m, rhs, x


@pytest.mark.parametrize("p", [257, 256, 251])
def test_solve_numpy(p, rng):
    # a random draw can be singular mod a non-prime p — the protocol
    # handles that via redundant combinations (reference
    # ``retrieval_params.rs:85-89``), so the test retries the same way
    for attempt in range(4):
        m, rhs, x = random_system(rng, 55, 50, 612, p)
        try:
            got = solve_matrix_numpy(m.copy(), rhs.copy(), p)
            break
        except InvertibleMatrixError:
            if attempt == 3:
                raise
    np.testing.assert_array_equal(got, x)


def test_solve_native_matches(rng):
    from tfhe_omr.native import solve_matrix_native

    p = 257
    m, rhs, x = random_system(rng, 55, 50, 612, p)
    got = solve_matrix_native(m.copy(), rhs.copy(), p)
    if got is None:
        pytest.skip("native lib unavailable")
    np.testing.assert_array_equal(got, x)


def test_singular_raises(rng):
    p = 257
    m = np.zeros((5, 3), dtype=np.int64)
    rhs = np.zeros((5, 10), dtype=np.int64)
    with pytest.raises(InvertibleMatrixError):
        solve_matrix_numpy(m, rhs, p)


def test_scan_buckets_native(rng):
    from tfhe_omr.native import scan_buckets_native

    p, spb, n_buckets, n_seg = 257, 3, 10, 4
    sps = spb * n_buckets
    decoded = np.zeros(n_seg * sps, dtype=np.int64)
    # plant index 1234 = 4*257 + 206 in segment 2, bucket 7
    base = 2 * sps + 7 * spb
    decoded[base] = 206
    decoded[base + 1] = 4
    decoded[base + 2] = 1  # flag
    # plant a flag==2 bucket that must be skipped
    decoded[0 * sps + 1 * spb + 2] = 2
    out = scan_buckets_native(decoded, n_seg, sps, spb, n_buckets, p, 10_000)
    if out is None:
        pytest.skip("native lib unavailable")
    assert out.tolist() == [1234]
