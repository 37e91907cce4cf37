"""Exact modular arithmetic over NTT-friendly prime fields, in int64 lanes.

Counterpart of primus-fhe's ``U32FieldEval<134215681>`` /
``U64FieldEval<1125899906826241>`` (reference ``omr_core/src/parameters/mod.rs:16-22``)
and its Barrett/Shoup reduction machinery (``ShoupFactor`` usage at
``omr_core/src/detector.rs:634-636``).

Design notes:

* All algorithms below only ever need *exact low-64-bit* products (wrapping
  multiply) plus limb products of <=26-bit halves, so no 128-bit
  intermediate is ever formed.
* Supported moduli are "Solinas-like": ``q = 2**bits - eps`` with
  ``eps < 2**(bits//2)`` and ``bits <= 50``. Both reference fields qualify
  (eps = 2047 and 16383).
* Multiplication by *fixed* operands (twiddles, bootstrapping keys) uses Shoup
  precomputation: one precomputed companion per constant makes the modmul
  3 multiplies (small field) or 6 (large field). Variable x variable products
  use a limbed Solinas reduction.

Everything operates elementwise on jnp int64 arrays with values in [0, q).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_I64 = jnp.int64


def _const(v: int):
    return jnp.int64(v)


class PrimeField:
    """Modular arithmetic helpers for a fixed prime ``q = 2**bits - eps``."""

    #: Shoup precomputation shift for the small-field path (bits <= 28).
    #: Chosen as 30 so Shoup companions fit in int32 storage (correctness
    #: needs shift >= bits + 2; all intermediates stay < 2**58 in int64).
    SMALL_SHOUP_SHIFT = 30
    #: Shoup precomputation shift for the large-field path (bits <= 50).
    BIG_SHOUP_SHIFT = 52

    def __init__(self, q: int):
        if q.bit_length() > 50:
            raise ValueError("moduli above 2**50 are not supported")
        self.q = int(q)
        self.bits = q.bit_length()
        self.eps = (1 << self.bits) - q
        if self.eps >= (1 << (self.bits // 2)):
            raise ValueError(
                f"modulus {q} is not Solinas-like (eps={self.eps} too large)"
            )
        # generic mul: direct int64 product fits iff 2*bits <= 62
        self.small = self.bits <= 31
        self.mid = 31 < self.bits <= 38
        if not (self.small or self.mid or 46 <= self.bits <= 50):
            raise ValueError(
                "generic modmul supports bits <= 38 or 46..50 "
                f"(got {self.bits})"
            )
        # Shoup path: small variant needs x * w_sh < 2**63 (bits + 35 <= 63)
        self.small_shoup = self.bits <= 28
        self.mask = (1 << self.bits) - 1
        self.shoup_shift = (
            self.SMALL_SHOUP_SHIFT if self.small_shoup else self.BIG_SHOUP_SHIFT
        )
        # fields below 29 bits store values (and Shoup companions) as int32 —
        # this halves memory traffic for every materialised tensor; all
        # arithmetic still happens in int64 registers (upcast/downcast fuse
        # into the elementwise op chains).
        self.storage_dtype = jnp.int32 if self.bits <= 28 else jnp.int64

    # ------------------------------------------------------------------ host
    def shoup(self, w):
        """Host-side Shoup companion ``floor(w << shift / q)`` (exact).

        ``w`` may be an int, a numpy array, or a nested list; returns the same
        shape as int64 numpy. Uses chunked long division so every intermediate
        fits in uint64.
        """
        w = np.asarray(w, dtype=np.uint64)
        q = np.uint64(self.q)
        quot = np.zeros_like(w)
        rem = w.copy()
        shift = self.shoup_shift
        # divide (w << shift) by q in <=13-bit chunks
        while shift > 0:
            step = min(13, shift)
            shift -= step
            rem = rem << np.uint64(step)
            quot = (quot << np.uint64(step)) + rem // q
            rem = rem % q
        return quot.astype(np.int64)

    def inv(self, x: int) -> int:
        return pow(int(x), self.q - 2, self.q)

    def pow(self, x: int, e: int) -> int:
        return pow(int(x), int(e), self.q)

    def find_primitive_root_of_unity(self, order: int) -> int:
        """Host: a primitive ``order``-th root of unity mod q (order | q-1)."""
        q = self.q
        assert (q - 1) % order == 0, (q, order)
        # factor q-1 (q-1 < 2**50; trial division is fine on host)
        n = q - 1
        factors = set()
        d = 2
        while d * d <= n:
            while n % d == 0:
                factors.add(d)
                n //= d
            d += 1
        if n > 1:
            factors.add(n)
        for g in range(2, 10_000):
            if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
                break
        else:  # pragma: no cover
            raise RuntimeError("no generator found")
        root = pow(g, (q - 1) // order, q)
        assert pow(root, order, q) == 1
        assert pow(root, order // 2, q) == q - 1
        return root

    # ---------------------------------------------------------------- device
    def _up(self, x):
        return x.astype(_I64) if x.dtype != _I64 else x

    def _down(self, x):
        return x.astype(self.storage_dtype)

    def add(self, a, b):
        a, b = self._up(a), self._up(b)
        s = a + b
        return self._down(s - _const(self.q) * (s >= _const(self.q)))

    def sub(self, a, b):
        a, b = self._up(a), self._up(b)
        d = a - b
        return self._down(d + _const(self.q) * (d < 0))

    def neg(self, a):
        a = self._up(a)
        return self._down(
            jnp.where(a == 0, jnp.zeros_like(a), _const(self.q) - a)
        )

    def to_field(self, a):
        """Map signed values in (-q, q) into [0, q)."""
        a = self._up(a)
        return self._down(a + _const(self.q) * (a < 0))

    def mul(self, a, b):
        """Generic modmul, both operands variable, values in [0, q)."""
        a, b = self._up(a), self._up(b)
        if self.small:
            return self.reduce(a * b)  # product < 2**62 exact in int64
        if self.mid:
            # half-width limbs: P = H*2^2t + M*2^t + L with 2^2t == e2t (mod q)
            t = (self.bits + 1) // 2
            tm = _const((1 << t) - 1)
            a1, a0 = a >> t, a & tm
            b1, b0 = b >> t, b & tm
            e2t = _const((1 << (2 * t)) % self.q)
            T = a1 * b1 * e2t + (a1 * b0 + a0 * b1) * (1 << t) + a0 * b0
            return self.reduce(T, 3 * self.bits // 2 + 4)
        L25 = _const((1 << 25) - 1)
        a1, a0 = a >> 25, a & L25
        b1, b0 = b >> 25, b & L25
        H = a1 * b1  # < 2**50
        M = a1 * b0 + a0 * b1  # < 2**51
        L = a0 * b0  # < 2**50
        # 2**50 == e50 (mod q)
        e50 = _const((1 << 50) % self.q)
        H1, H0 = H >> 25, H & L25
        Mp = H1 * e50 + M  # < 2**52
        Lp = H0 * e50 + L  # < 2**51
        M1, M0 = Mp >> 25, Mp & L25
        T = M1 * e50 + (M0 << 25) + Lp  # < 2**56 (bits 46..50)
        return self.reduce(T, 56)

    def mul_shoup(self, x, w, w_sh):
        """Modmul by fixed ``w`` with precomputed companion ``w_sh``.

        Requires x in [0, 2**shoup_shift); w in [0, q). Result in [0, q).
        """
        x, w, w_sh = self._up(x), self._up(w), self._up(w_sh)
        q = _const(self.q)
        if self.small_shoup:
            t = (x * w_sh) >> self.SMALL_SHOUP_SHIFT  # x*w_sh < 2**58
            r = x * w - t * q
            return self._down(r - q * (r >= q))
        L26 = _const((1 << 26) - 1)
        x1, x0 = x >> 26, x & L26  # x1 < 2**24
        w1, w0 = w_sh >> 26, w_sh & L26  # w1 < 2**26
        mid = x1 * w0 + x0 * w1 + ((x0 * w0) >> 26)  # < 2**53
        t = x1 * w1 + (mid >> 26)  # == floor(x * w_sh / 2**52)
        r = x * w - t * q  # wrapping; true value in [0, 2q)
        return r - q * (r >= q)  # int64 storage for big fields

    def reduce(self, v, bound_bits: int = 62):
        """Reduce non-negative int64 v < 2**bound_bits to [0, q)."""
        v = self._up(v)
        q = _const(self.q)
        bits = self.bits
        mask = _const(self.mask)
        eps = _const(self.eps)
        eps_bits = self.eps.bit_length()
        bound = bound_bits
        # Solinas folds: v -> (v >> bits)*eps + (v & mask); fold while it
        # strictly shrinks the value bound.
        while True:
            nb = max(bits, (bound - bits) + eps_bits) + 1
            if nb >= bound:
                break
            v = (v >> bits) * eps + (v & mask)
            bound = nb
        assert bound <= bits + 2, (bound, bits)
        v = v - q * (v >= q)
        return self._down(v - q * (v >= q))

    def mod_sum(self, x, axis: int):
        """Exact modular sum along ``axis`` with overflow-safe chunking."""
        n = x.shape[axis]
        # how many q-sized terms fit in an int64 without overflow
        chunk = max(2, (1 << 62) // (1 << self.bits) // 2)
        x = self._up(jnp.moveaxis(x, axis, 0))
        while x.shape[0] > 1:
            c = min(chunk, x.shape[0])
            pad = (-x.shape[0]) % c
            if pad:
                x = jnp.concatenate(
                    [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0
                )
            x = self._up(
                x.reshape((x.shape[0] // c, c) + x.shape[1:]).sum(axis=1)
            )
            x = self._up(self.reduce(x))
        return self._down(x[0])

    # ------------------------------------------------------------- utilities
    def rand(self, rng: np.random.Generator, shape):
        """Host: uniform field elements as int64 numpy."""
        return rng.integers(0, self.q, size=shape, dtype=np.int64)

    def gaussian(self, rng: np.random.Generator, sigma: float, shape):
        """Host: rounded discrete Gaussian noise, mapped into [0, q).

        Counterpart of primus-fhe ``DiscreteGaussian`` (reference
        ``omr_core/src/parameters/mod.rs:157-161``). ``sigma == 0`` gives the
        noise-free deterministic mode (the reference lacks one; SURVEY.md §4).
        """
        if sigma == 0.0:
            return np.zeros(shape, dtype=np.int64)
        e = np.rint(rng.normal(0.0, sigma, size=shape)).astype(np.int64)
        return np.mod(e, self.q)
