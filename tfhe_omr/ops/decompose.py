"""Gadget decomposition: approximate signed (TFHE-style) and exact digits.

Counterpart of primus-fhe's ``NonPowOf2ApproxSignedBasis``
(constructed at reference ``omr_core/src/parameters/mod.rs:55,81,89`` and
``:58-66`` for the key-switching basis). The reference crate's exact rounding
convention is not vendored, so this module *defines* a self-consistent
convention shared by key generation (gadget values) and the device kernels
(digit extraction); correctness is enforced end-to-end by the omd oracle test
rather than by primus-fhe bit-compatibility (see SURVEY.md §4).

Two modes:

* **approx** (``d * log_B < ceil(log q)``; used by both blind-rotation keys):
  MSB-oriented TFHE gadget. ``u = round(x * B**d / q)`` computed exactly-ish
  with a Solinas correction term, then balanced signed digits of ``u``
  LSB-first; the final carry multiplies ``q`` and vanishes mod q. Gadget
  values are ``h_j = round(q * B**j / B**d)``; the approximation error is
  ``|x - sum_j d_j h_j| <= q/(2 B**d) + d*B/4`` — plain additive noise.
* **exact** (``d * log_B >= ceil(log q)``; key-switching and trace bases):
  plain unsigned base-B digits of x, ``h_j = B**j``, zero error.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from tfhe_omr.ops.modmath import PrimeField


class SignedGadget:
    """Decomposition basis for modulus q, base ``B = 2**log_b``, ``d`` digits."""

    def __init__(self, field: PrimeField, log_b: int, d: int):
        self.field = field
        self.log_b = log_b
        self.d = d
        q = field.q
        qbits = field.bits
        self.exact = d * log_b >= qbits
        if self.exact:
            self.h = [(1 << (log_b * j)) % q for j in range(d)]
        else:
            # shift s such that u = round(x * 2**(d*log_b) / q) fits; the
            # rounding uses the Solinas structure q = 2**qbits - eps:
            #   x * B**d / q = (x + x*eps/2**qbits + ...) / 2**(qbits - d*log_b)
            self.shift = qbits - d * log_b
            assert self.shift > 0
            self.h = [
                ((q << (log_b * j)) + (1 << (d * log_b - 1))) >> (d * log_b)
                for j in range(d)
            ]

    # ---------------------------------------------------------------- device
    def decompose(self, x, axis: int = 0):
        """Digits of x (int64, [0,q)) -> stacked along new axis ``axis``.

        Approx mode gives balanced signed digits in [-B/2, B/2), exact mode
        unsigned digits in [0, B).
        """
        x = self.field._up(x)  # int32-stored fields: products below need 64b
        log_b = self.log_b
        bmask = jnp.int64((1 << log_b) - 1)
        if self.exact:
            digs = [
                (x >> jnp.int64(log_b * j)) & bmask for j in range(self.d)
            ]
            return jnp.stack(digs, axis=axis)
        f = self.field
        eps = f.eps
        qbits = f.bits
        # u = round(x * B**d / q), via first-order Solinas series; exact
        # enough that errors only perturb rounding at ~2**-8 boundaries.
        if qbits + eps.bit_length() <= 62:
            corr = (x * jnp.int64(eps)) >> jnp.int64(qbits)
        else:
            sh = qbits + eps.bit_length() - 62
            corr = ((x >> jnp.int64(sh)) * jnp.int64(eps)) >> jnp.int64(
                qbits - sh
            )
        u = (x + corr + jnp.int64(1 << (self.shift - 1))) >> jnp.int64(
            self.shift
        )
        half_b = jnp.int64(1 << (log_b - 1))
        digs = []
        r = u
        for _ in range(self.d):
            dj = r & bmask
            r = r >> jnp.int64(log_b)
            carry = (dj >= half_b).astype(jnp.int64)
            digs.append(dj - (carry << jnp.int64(log_b)))
            r = r + carry
        # final carry r multiplies q => drops out mod q
        return jnp.stack(digs, axis=axis)

    def decompose_to_field(self, x, axis: int = 0):
        """Digits mapped into [0, q) (ready for NTT input)."""
        return self.field.to_field(self.decompose(x, axis=axis))

    # ------------------------------------------------------------------ host
    def gadget_values(self) -> np.ndarray:
        """h_j values (int64 numpy) used by key generation."""
        return np.asarray(self.h, dtype=np.int64)

    def recompose_host(self, digits: np.ndarray) -> np.ndarray:
        """Host-side Σ d_j h_j mod q (for tests)."""
        q = self.field.q
        acc = np.zeros(digits.shape[1:], dtype=object)
        for j in range(self.d):
            acc = acc + digits[j].astype(object) * self.h[j]
        return np.mod(acc, q).astype(np.int64)
