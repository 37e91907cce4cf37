"""Mixed-radix negacyclic NTT for small fields (q below 2^29).

Performance variant of :mod:`tfhe_omr.ops.ntt` for the first-level field
(q1 = 2^27 - 2047, reference ``omr_core/src/parameters/mod.rs:18``). The
radix-2 transform materialises the whole tensor log2(N) times (it is
memory-bound); here the cyclic DFT is factorised into mixed radices

    N = r_0 * r_1 * ... * r_{L-1},   r in {4, 8, 16} by default
    (the reference rings use ``reference_radices(N)``, see
    ``core.context.make_ntt``)

and each level is ONE materialised pass: an unrolled sum of r
constant-multiplied slices along the level's axis (raw int64 products,
Solinas-folded once — exact because r * q^2 < 2^62), fused by XLA with the
inter-level twiddle multiply. A 1024-point transform is 3 passes instead
of 11, and values are stored as int32.

The negacyclic psi-twist (and on the inverse side the un-twist and the 1/N
scale) are folded into the per-level constant matrices, so no separate twist
pass exists. The output ordering is a mixed-radix digit permutation — all
NTT-domain ordering in this framework is abstract (consumers only do
pointwise work; the evaluation order is derived empirically into ``orders``),
so this class is a drop-in replacement for NegacyclicNtt wherever the same
instance produces and consumes the NTT domain.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.utils.devices import host_math


#: The reference rings' NTT-domain order is that of the two-level plan
#: ``[REFERENCE_RADIX, N / REFERENCE_RADIX]``; keys and the golden vectors
#: are laid out in it.
REFERENCE_RADIX = 32


def reference_radices(n: int) -> list[int]:
    """The two-level plan that defines the reference rings' NTT order."""
    return [REFERENCE_RADIX, n // REFERENCE_RADIX]


def _factorize(n: int) -> list[int]:
    """Factor n into radices in {4, 8, 16}, preferring large leaves."""
    out = []
    while n > 16:
        out.append(8)
        n //= 8
    assert n in (2, 4, 8, 16), n
    out.append(n)
    return out


def build_mixed_radix_plan(field, n: int, radices, psi: int, inverse: bool):
    """Per-level (dft_matrix, twiddle, r, m_l, pre) for a mixed-radix NTT.

    Forward, x viewed as (r_0, ..., r_{L-1}) with flat index
    i = sum_l i_l * s_l, s_l = prod_{j>l} r_j:

      level l: DFT_{r_l} along axis l with root w_l, then twiddle
      T_l[k_l, j] = wc_l^(k_l * j) over the remaining flat index j in [m_l),
      where wc_l = omega^(prod_{j<l} r_j) and w_l = wc_l^(m_l); the psi-twist
      psi^(i_l * s_l) is folded into the matrix columns of level l.

    Inverse runs levels L-1..0, applying the conjugate twiddle before the
    inverse matrix; the un-twist is folded into matrix rows and the full 1/N
    into level 0's matrix. Shared by SmallFieldNtt and PermutedNtt
    (matrices are exact host Python-int arithmetic, any field width).
    """
    q = field.q
    psi_t = field.inv(psi) if inverse else psi
    omega_t = psi_t * psi_t % q

    rads = list(radices)
    L = len(rads)
    s = [1] * L
    for l in range(L - 2, -1, -1):
        s[l] = s[l + 1] * rads[l + 1]
    m = s  # m_l == prod_{j>l} r_j == stride of axis l

    plan = []
    pre = 1  # prod_{j<l} r_j
    n_inv = field.inv(n)
    for l, r in enumerate(rads):
        wc = pow(omega_t, pre, q)  # primitive (r*m_l)-th root
        w_l = pow(wc, m[l], q)  # primitive r-th root
        # object dtype: products of ~50-bit entries would overflow int64
        mat = np.empty((r, r), dtype=object)
        for k in range(r):
            for i in range(r):
                mat[k, i] = pow(w_l, (k * i) % r, q)
        if not inverse:
            for i in range(r):
                mat[:, i] = mat[:, i] * pow(psi_t, i * s[l], q) % q
        else:
            for i in range(r):
                mat[i, :] = mat[i, :] * pow(psi_t, i * s[l], q) % q
            if l == 0:
                mat = mat * n_inv % q
        mat = mat.astype(np.int64)
        tw = None
        if m[l] > 1:
            tw = np.empty((r, m[l]), dtype=np.int64)
            for k in range(r):
                tw[k, :] = [pow(wc, k * j, q) for j in range(m[l])]
        plan.append((mat, tw, r, m[l], pre))
        pre *= r
    return plan


class SmallFieldNtt:
    """Mixed-radix negacyclic NTT (same interface as NegacyclicNtt)."""

    def __init__(self, field: PrimeField, n: int, radices: list[int] | None = None):
        assert n & (n - 1) == 0
        assert 2 * field.bits + 4 <= 62, "raw-product DFT needs q < 2^29"
        self.field = field
        self.n = n
        q = field.q
        psi = field.find_primitive_root_of_unity(2 * n)
        self.psi = psi
        self.n_inv = field.inv(n)
        if radices is None:
            radices = _factorize(n)
        else:
            prod = 1
            for r in radices:
                prod *= r
            assert prod == n, (radices, n)
        self.radices = radices

        self._fwd_plan = self._build_plan(inverse=False)
        self._inv_plan = self._build_plan(inverse=True)

        # psi power table for monomial products
        pow2n = np.empty(2 * n, dtype=np.int64)
        acc = 1
        for i in range(2 * n):
            pow2n[i] = acc
            acc = acc * psi % q
        self._psi_pow_2n = pow2n

        with host_math():
            root_of_slot = np.asarray(
                self.fwd(
                    jnp.asarray(np.eye(1, n, 1, dtype=np.int64).reshape(n, 1))
                )
            )[:, 0]
        dlog = {int(pow2n[i]): i for i in range(2 * n)}
        self.orders = np.array(
            [dlog[int(r)] for r in root_of_slot], dtype=np.int64
        )
        assert np.all(self.orders % 2 == 1)

    # ------------------------------------------------------------------ plan
    def _build_plan(self, inverse: bool):
        return build_mixed_radix_plan(
            self.field, self.n, self.radices, self.psi, inverse
        )

    # ---------------------------------------------------------------- device
    def _dft_level(self, x, mat, r, batch_shape):
        """Unrolled constant-matrix DFT along axis 1 of x (pre, r, rest*B)."""
        f = self.field
        x64 = x.astype(jnp.int64)
        outs = []
        bound = 2 * f.bits + r.bit_length()
        for k in range(r):
            acc = None
            for i in range(r):
                c = int(mat[k, i])
                if c == 0:
                    continue
                term = x64[:, i] if c == 1 else x64[:, i] * jnp.int64(c)
                acc = term if acc is None else acc + term
            outs.append(f._up(f.reduce(acc, bound)))
        return jnp.stack(outs, axis=1)

    def _apply(self, x, plan, order):
        f = self.field
        n = self.n
        batch = x.shape[1:]
        bflat = 1
        for b in batch:
            bflat *= b
        x = x.reshape(n, bflat)
        for l in order:
            mat, tw, r, m_l, pre = plan[l]
            xr = x.reshape(pre, r, m_l * bflat)
            if tw is not None and order[0] != 0:  # inverse: twiddle first
                twv = jnp.asarray(tw, dtype=f.storage_dtype).reshape(
                    1, r, m_l, 1
                )
                twsh = jnp.asarray(
                    f.shoup(tw), dtype=f.storage_dtype
                ).reshape(1, r, m_l, 1)
                xr4 = xr.reshape(pre, r, m_l, bflat)
                xr = f.mul_shoup(xr4, twv, twsh).reshape(pre, r, m_l * bflat)
            y = self._dft_level(xr, mat, r, batch)
            if tw is not None and order[0] == 0:  # forward: twiddle after
                y4 = y.reshape(pre, r, m_l, bflat)
                twv = jnp.asarray(tw, dtype=f.storage_dtype).reshape(
                    1, r, m_l, 1
                )
                twsh = jnp.asarray(
                    f.shoup(tw), dtype=f.storage_dtype
                ).reshape(1, r, m_l, 1)
                y = f.mul_shoup(y4, twv, twsh)
            else:
                y = f._down(f.reduce(y, f.bits + 1))
            x = y.reshape(n, bflat)
        return x.reshape((n,) + batch)

    def fwd(self, x):
        """Forward negacyclic NTT along axis 0."""
        return self._apply(x, self._fwd_plan, list(range(len(self.radices))))

    def inv(self, x):
        """Inverse negacyclic NTT along axis 0 (includes 1/N)."""
        return self._apply(
            x, self._inv_plan, list(range(len(self.radices) - 1, -1, -1))
        )

    def fwd_last(self, x):
        return jnp.moveaxis(self.fwd(jnp.moveaxis(x, -1, 0)), 0, -1)

    def inv_last(self, x):
        return jnp.moveaxis(self.inv(jnp.moveaxis(x, -1, 0)), 0, -1)

    # ----------------------------------------------------- monomial products
    def monomial_minus_one_tables(self):
        q = self.field.q
        sd = self.field.storage_dtype
        vals = (self._psi_pow_2n - 1) % q
        return (
            jnp.asarray(vals, dtype=sd),
            jnp.asarray(self.field.shoup(vals), dtype=sd),
        )

    def monomial_exponents(self, a):
        orders = jnp.asarray(self.orders).reshape((self.n,) + (1,) * a.ndim)
        return (orders * a[None]) % (2 * self.n)
