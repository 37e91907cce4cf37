"""Negacyclic NTT/INTT over prime fields, batched, poly-axis-major layout.

Counterpart of primus-fhe's NTT tables and
``NumberTheoryTransform`` (generation at reference
``omr_core/src/parameters/mod.rs:174-181,238-245``; use at
``omr_core/src/detector.rs:325,435`` and ``omr_core/src/retriever.rs:79-91``).

Design notes:

* The transform operates on **axis 0** with all batch axes trailing, so in the
  bootstrapping hot loop (layout ``(2, N, B)``) the minor dimension of every
  butterfly stage is the batch axis, and all inter-stage reshapes act on
  leading axes (free, row-major).
* Forward = Cooley-Tukey DIT with psi powers merged into the twiddles
  (natural order in, bit-reversed evaluation order out); inverse =
  Gentleman-Sande consuming that order. All NTT-domain tensors in the
  framework share this ordering, so it never needs to be materialised.
* Every twiddle multiply is a Shoup modmul against precomputed companions.
* ``monomial_exponents``/tables support multiplying an NTT-domain vector by
  ``NTT(X^a - 1)`` via a tiny ``2N``-entry table lookup — this is how blind
  rotation avoids per-message coefficient gathers (see blind_rotate.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.ops.ntt_smallfield import build_mixed_radix_plan, reference_radices
from tfhe_omr.utils.devices import host_math


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class NegacyclicNtt:
    """Number-theoretic transform over Z_q[X]/(X^N + 1)."""

    def __init__(self, field: PrimeField, n: int):
        assert n & (n - 1) == 0, "N must be a power of two"
        self.field = field
        self.n = n
        self.log_n = n.bit_length() - 1
        q = field.q
        psi = field.find_primitive_root_of_unity(2 * n)
        self.psi = psi
        psi_inv = field.inv(psi)
        self.n_inv = field.inv(n)

        br = _bit_reverse_indices(n)
        # psi^br(i) tables for CT forward, psi^-br(i) for GS inverse
        psi_pows = np.empty(n, dtype=np.int64)
        ipsi_pows = np.empty(n, dtype=np.int64)
        acc = 1
        iacc = 1
        pw = np.empty(n, dtype=object)
        ipw = np.empty(n, dtype=object)
        for i in range(n):
            pw[i] = acc
            ipw[i] = iacc
            acc = acc * psi % q
            iacc = iacc * psi_inv % q
        psi_pows[:] = pw[br]
        ipsi_pows[:] = ipw[br]

        # stage twiddles as device constants (field storage dtype)
        sd = field.storage_dtype
        self._fwd_tw = []
        self._inv_tw = []
        m = 1
        while m < n:
            w = np.asarray(psi_pows[m : 2 * m], dtype=sd)
            self._fwd_tw.append(
                (w, np.asarray(field.shoup(psi_pows[m : 2 * m]), dtype=sd))
            )
            m *= 2
        h = n // 2
        while h >= 1:
            tw = ipsi_pows[h : 2 * h]
            if h == 1:
                # fold the 1/N scale into the last GS stage (both outputs)
                tw = tw * np.int64(0) + np.asarray(
                    [(int(ipsi_pows[1]) * self.n_inv) % q], dtype=np.int64
                )
            w = np.asarray(tw, dtype=sd)
            self._inv_tw.append(
                (w, np.asarray(field.shoup(tw), dtype=sd))
            )
            h //= 2
        # host scalars/tables, embedded by value at trace time
        self._n_inv = np.int64(self.n_inv)
        self._n_inv_sh = np.int64(int(field.shoup(self.n_inv)))

        # full psi power table (exponents mod 2N) for monomial products
        pow2n = np.empty(2 * n, dtype=np.int64)
        acc = 1
        for i in range(2 * n):
            pow2n[i] = acc
            acc = acc * psi % q
        self._psi_pow_2n = pow2n

        # evaluation-order exponents: fwd output slot k evaluates the input
        # polynomial at psi**orders[k]. Derived empirically so it is robust to
        # the butterfly ordering convention. Pinned to CPU: one tiny eager
        # transform is not worth an accelerator compile. Subclasses that
        # reorder the output derive their own orders from this one.
        with host_math():
            root_of_slot = np.asarray(NegacyclicNtt.fwd(self, jnp.asarray(
                np.eye(1, n, 1, dtype=np.int64).reshape(n, 1))))[:, 0]
        dlog = {int(pow2n[i]): i for i in range(2 * n)}
        self.orders = np.array([dlog[int(r)] for r in root_of_slot],
                               dtype=np.int64)
        assert np.all(self.orders % 2 == 1)

    # ---------------------------------------------------------------- device
    def fwd(self, x):
        """Forward negacyclic NTT along axis 0. x: (N, ...) int64 in [0,q)."""
        f = self.field
        n = self.n
        batch = x.shape[1:]
        m = 1
        t = n
        for w, w_sh in self._fwd_tw:
            t //= 2
            xr = x.reshape((m, 2, t) + batch)
            u = xr[:, 0]
            wv = w.reshape((m, 1) + (1,) * len(batch))
            wsv = w_sh.reshape((m, 1) + (1,) * len(batch))
            v = f.mul_shoup(xr[:, 1], wv, wsv)
            x = jnp.stack((f.add(u, v), f.sub(u, v)), axis=1).reshape(
                (n,) + batch
            )
            m *= 2
        return x

    def inv(self, x):
        """Inverse negacyclic NTT along axis 0 (GS), including 1/N scale.

        The 1/N factor is folded into the final stage: its twiddle is
        ipsi*ninv and the sum output is scaled by ninv directly, so no extra
        full-array pass is materialised.
        """
        f = self.field
        n = self.n
        batch = x.shape[1:]
        t = 1
        h = n // 2
        for w, w_sh in self._inv_tw:
            last = h == 1
            xr = x.reshape((h, 2, t) + batch)
            u = xr[:, 0]
            v = xr[:, 1]
            wv = w.reshape((h, 1) + (1,) * len(batch))
            wsv = w_sh.reshape((h, 1) + (1,) * len(batch))
            s = f.add(u, v)
            if last:
                s = f.mul_shoup(s, self._n_inv, self._n_inv_sh)
            x = jnp.stack(
                (s, f.mul_shoup(f.sub(u, v), wv, wsv)), axis=1
            ).reshape((n,) + batch)
            t *= 2
            h //= 2
        return x

    def fwd_last(self, x):
        """Forward NTT along the last axis (convenience, extra transposes)."""
        return jnp.moveaxis(self.fwd(jnp.moveaxis(x, -1, 0)), 0, -1)

    def inv_last(self, x):
        return jnp.moveaxis(self.inv(jnp.moveaxis(x, -1, 0)), 0, -1)

    # ----------------------------------------------------- monomial products
    def monomial_minus_one_tables(self):
        """Device tables ``T[e] = psi**e - 1 mod q`` and Shoup companions.

        ``NTT(X^a - 1)[k] == T[(a * orders[k]) % 2N]``, so multiplying an
        NTT-domain vector by ``X^a - 1`` is two small-table gathers plus a
        Shoup modmul — no data-dependent gathers of ciphertext data.
        """
        q = self.field.q
        sd = self.field.storage_dtype
        vals = (self._psi_pow_2n - 1) % q
        return (
            jnp.asarray(vals, dtype=sd),
            jnp.asarray(self.field.shoup(vals), dtype=sd),
        )

    def monomial_exponents(self, a):
        """Exponent indices e[k, ...] = (orders[k] * a[...]) % 2N.

        a: integer array of rotation amounts in [0, 2N). Result indexes the
        tables from :meth:`monomial_minus_one_tables`.
        """
        orders = jnp.asarray(self.orders).reshape(
            (self.n,) + (1,) * a.ndim
        )
        return (orders * a[None]) % (2 * self.n)


class PermutedNtt(NegacyclicNtt):
    """Radix-2 :class:`NegacyclicNtt` with its outputs permuted into the
    evaluation order of the two-level mixed-radix plan
    ``reference_radices(n)``.

    The 50-bit ring's NTT-domain data (bootstrapping and trace keys, the
    pinned golden vectors) is laid out in that order, so this class keeps
    the radix-2 butterflies (exact for any field width) and applies the
    static permutation ``_perm`` after the forward transform and
    ``_perm_inv`` before the inverse.
    """

    def __init__(self, field: PrimeField, n: int):
        super().__init__(field, n)
        plan = build_mixed_radix_plan(field, n, reference_radices(n), self.psi,
                                      False)
        delta = np.zeros(n, dtype=object)
        delta[1] = 1
        col = _apply_plan_host(delta, plan, field.q)
        dlog = {int(self._psi_pow_2n[i]): i for i in range(2 * n)}
        orders = np.array([dlog[int(v)] for v in col], dtype=np.int64)
        ref_pos = {int(o): i for i, o in enumerate(self.orders)}
        self._perm = np.array([ref_pos[int(o)] for o in orders], dtype=np.int64)
        self._perm_inv = np.argsort(self._perm)
        self.orders = orders

    def fwd(self, x):
        return super().fwd(x)[jnp.asarray(self._perm)]

    def inv(self, x):
        return super().inv(x[jnp.asarray(self._perm_inv)])


def _apply_plan_host(x_obj, plan, q: int):
    """Exact object-int application of a two-level forward plan to one
    column (used only to read off its evaluation order)."""
    mat0, tw0, r, c, _ = plan[0]
    mat1 = plan[1][0]
    a = (mat0.astype(object) @ x_obj.reshape(r, c)) % q
    a = (a * tw0.astype(object)) % q
    out = np.empty((r, c), dtype=object)
    for k0 in range(r):
        out[k0] = (mat1.astype(object) @ a[k0]) % q
    return out.reshape(r * c)
