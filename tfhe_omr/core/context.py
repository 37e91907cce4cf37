"""Runtime context: fields, NTT tables, gadgets and LUTs for a parameter set.

Rough counterpart of the table/basis state the reference threads through
``OmrParameters`` accessors (``generate_first_level_ntt_table`` etc.,
reference ``omr_core/src/parameters/mod.rs:174-181,238-245``) and the LUT
precomputation in ``Detector::new`` (``detector.rs:82-110``).
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import jax.numpy as jnp

from tfhe_omr.core.lut import first_level_lut, second_level_lut
from tfhe_omr.core.params import OmrParameters
from tfhe_omr.ops.decompose import SignedGadget
from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.ops.ntt import NegacyclicNtt, PermutedNtt
from tfhe_omr.ops.ntt_smallfield import (
    REFERENCE_RADIX, SmallFieldNtt, reference_radices,
)


def make_ntt(field: PrimeField, n: int):
    """The NTT for a ring, chosen from the field width and ring size.

    The reference rings (N >= 1024) use the two-level plan
    ``reference_radices(N)``, i.e. ``[32, N/32]``:
    the mixed-radix transform itself below 2^29, and the radix-2 transform
    permuted into that plan's evaluation order for the 50-bit field (the
    raw-product DFT needs q < 2^29). Every NTT-domain value, keys and
    golden vectors included, is defined in these orders. Smaller rings use
    the default mixed-radix factorisation, and other wide fields plain
    radix-2.
    """
    if n >= 1024 and n % REFERENCE_RADIX == 0:
        if field.bits <= 27:
            return SmallFieldNtt(field, n, radices=reference_radices(n))
        if field.bits == 50:
            return PermutedNtt(field, n)
    if 2 * field.bits + 4 <= 62 and n >= 32:
        return SmallFieldNtt(field, n)
    return NegacyclicNtt(field, n)


class OmrContext:
    """Derived (non-secret) state for one parameter set."""

    def __init__(self, params: OmrParameters):
        self.params = params
        self.f1 = PrimeField(params.q1)
        self.f2 = PrimeField(params.q2)

    @cached_property
    def ntt1(self):
        return make_ntt(self.f1, self.params.n1)

    @cached_property
    def ntt2(self):
        return make_ntt(self.f2, self.params.n2)

    @cached_property
    def gadget_br1(self) -> SignedGadget:
        br = self.params.first_level_br
        return SignedGadget(self.f1, br.log_basis, br.basis_len)

    @cached_property
    def gadget_br2(self) -> SignedGadget:
        br = self.params.second_level_br
        return SignedGadget(self.f2, br.log_basis, br.basis_len)

    @cached_property
    def gadget_ks(self) -> SignedGadget:
        ks = self.params.first_level_ks
        return SignedGadget(self.f1, ks.log_basis, ks.digits)

    @cached_property
    def gadget_trace(self) -> SignedGadget:
        tr = self.params.trace
        return SignedGadget(self.f2, tr.log_basis, tr.basis_len)

    # ------------------------------------------------------------------ LUTs
    @cached_property
    def lut1_ext(self) -> np.ndarray:
        """[LUT1, -LUT1] length 2*N1 — X^-b init by small-table lookup."""
        lut = first_level_lut(self.params)
        return np.concatenate([lut, (self.f1.q - lut) % self.f1.q])

    @cached_property
    def lut2_ext(self) -> np.ndarray:
        lut = second_level_lut(self.params)
        return np.concatenate([lut, (self.f2.q - lut) % self.f2.q])

    # -------------------------------------------------- clue sample extraction
    @cached_property
    def clue_extract_tables(self):
        """Static index/sign tables for ``CmLweCiphertext::extract_all``.

        Extraction at coefficient position i of a ring ciphertext (a(X), b(X))
        of dimension n yields the LWE ciphertext with
        ``a_vec[j] = a[i-j]`` for j <= i and ``-a[n+i-j]`` for j > i
        (counterpart of ``detector.rs:505-531`` / primus-fhe extract_all).
        Returns (idx, neg) of shape (clue_count, n).
        """
        n = self.params.clue_params.dimension
        c = self.params.clue_count
        idx = np.zeros((c, n), dtype=np.int64)
        neg = np.zeros((c, n), dtype=np.int64)
        for i in range(c):
            for j in range(n):
                if j <= i:
                    idx[i, j] = i - j
                    neg[i, j] = 0
                else:
                    idx[i, j] = n + i - j
                    neg[i, j] = 1
        return idx, neg

    # ------------------------------------------------------ trace automorphisms
    @cached_property
    def trace_autos(self):
        """Galois elements and gather permutations for the trace rounds.

        EvalTr over log2(N) rounds with g_r = N / 2**r + 1
        (counterpart of primus-fhe ``TraceKey::trace``,
        used at reference ``detector.rs:626-639``). For each round,
        ``sigma_g(c)[k] = gsign[k] * c[gidx[k]]`` with static tables.
        """
        n = self.params.n2
        autos = []
        r = n
        while r >= 2:
            g = r + 1
            # forward map: coeff j -> position (g*j mod 2n) with negacyclic sign
            dest = np.zeros(n, dtype=np.int64)
            sgn = np.zeros(n, dtype=np.int64)
            for j in range(n):
                p = (g * j) % (2 * n)
                if p < n:
                    dest[j] = p
                    sgn[j] = 1
                else:
                    dest[j] = p - n
                    sgn[j] = -1
            gidx = np.zeros(n, dtype=np.int64)
            gsign = np.zeros(n, dtype=np.int64)
            gidx[dest] = np.arange(n)
            gsign[dest] = sgn
            autos.append((g, gidx, gsign))
            r //= 2
        return autos
