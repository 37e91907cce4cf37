"""Linear-system solvers over Z_p for payload recovery.

Counterpart of reference ``omr_core/src/matrix.rs`` (Gaussian elimination +
back substitution on Payload-vector right-hand sides: ``solve_matrix_mod_256``
``:78-159``, ``solve_matrix_mod_257`` ``:164-247``, generic ``solve_matrix``
``:250-336``). Implemented as vectorised NumPy with an optional C++ fast path
(tfhe_omr.native); the reference's unsafe unchecked indexing hot loops
(``matrix.rs:43-75``) correspond to the native implementation here.
"""

from __future__ import annotations

import numpy as np

from tfhe_omr.core.errors import InvertibleMatrixError


def _inv_mod(v: int, p: int) -> int:
    g, x = _xgcd(v % p, p)
    if g != 1:
        raise InvertibleMatrixError(f"{v} not invertible mod {p}")
    return x % p


def _xgcd(a: int, b: int):
    x0, x1 = 1, 0
    while b:
        q, a, b = a // b, b, a % b
        x0, x1 = x1, x0 - q * x1
    return a, x0


def solve_matrix(matrix: np.ndarray, rhs: np.ndarray, p: int) -> np.ndarray:
    """Solve (an overdetermined) ``matrix @ x = rhs`` mod p.

    matrix: (rows, cols) with rows >= cols; rhs: (rows, payload_len).
    Returns x: (cols, payload_len). Row-pivoted Gaussian elimination over the
    redundant rows — mirrors the generic ``solve_matrix``
    (reference ``matrix.rs:250-336``) but vectorised over the payload axis.
    """
    try:
        from tfhe_omr.native import solve_matrix_native

        out = solve_matrix_native(matrix, rhs, p)
        if out is not None:
            return out
    except ImportError:
        pass
    return solve_matrix_numpy(matrix, rhs, p)


def solve_matrix_numpy(matrix: np.ndarray, rhs: np.ndarray, p: int) -> np.ndarray:
    m = np.mod(matrix.astype(np.int64), p).copy()
    r = np.mod(rhs.astype(np.int64), p).copy()
    rows, cols = m.shape
    if rows < cols:
        raise InvertibleMatrixError("underdetermined system")
    for c in range(cols):
        # pivot: first row >= c with invertible entry (mirrors the odd-entry
        # pivoting of ``solve_matrix_mod_256``; for prime p any nonzero works)
        piv = None
        for rr in range(c, rows):
            if np.gcd(int(m[rr, c]), p) == 1:
                piv = rr
                break
        if piv is None:
            raise InvertibleMatrixError(f"no pivot for column {c}")
        if piv != c:
            m[[c, piv]] = m[[piv, c]]
            r[[c, piv]] = r[[piv, c]]
        inv = _inv_mod(int(m[c, c]), p)
        m[c] = np.mod(m[c] * inv, p)
        r[c] = np.mod(r[c] * inv, p)
        below = np.arange(c + 1, rows)
        if len(below):
            f = m[below, c][:, None]
            m[below] = np.mod(m[below] - f * m[c][None, :], p)
            r[below] = np.mod(r[below] - f * r[c][None, :], p)
    # back substitution
    for c in range(cols - 1, -1, -1):
        above = np.arange(0, c)
        if len(above):
            f = m[above, c][:, None]
            m[above] = np.mod(m[above] - f * m[c][None, :], p)
            r[above] = np.mod(r[above] - f * r[c][None, :], p)
    return r[:cols]
