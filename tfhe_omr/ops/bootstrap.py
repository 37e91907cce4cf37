"""Bootstrapping primitives: batched blind rotation, key switch, trace.

Counterparts of primus-fhe's ``BlindRotationKey::blind_rotate``
(used at reference ``omr_core/src/detector.rs:553-557,623``),
``NonPowOf2LweKeySwitchingKey::key_switch`` (``detector.rs:560-563``) and
``TraceKey::trace`` (``detector.rs:626-639``).

Key architectural inversions vs the reference (SURVEY.md §7):

* Everything is batched over a trailing message axis B; the CMUX loop is a
  ``lax.fori_loop`` whose body operates on ``(N, ..., B)`` tensors with the
  batch as the minor axis.
* The per-message monomial rotation ``X^a * ACC`` is applied **in the NTT
  domain after the gadget MAC**, as a pointwise product with
  ``NTT(X^a - 1)`` (exact because gadget recomposition is linear; the
  decomposition error lands in the noise term either way); the multiplier
  values come from per-message power tables selected by static one-hot
  int8 dots (``make_mono_powers``), so the hot loop has no data-dependent
  gathers.
* LWE key switching is a set of int8 limb matmuls (digits are binary; the
  key is pre-split into 7-bit planes with int32 accumulation).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tfhe_omr.ops.decompose import SignedGadget
from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.ops.ntt import NegacyclicNtt


def make_mono_powers(field: PrimeField, ntt):
    """Factored power tables for the NTT-domain monomial multiplier.

    ``NTT(X^a)[k] = psi^(a * o_k)``.  Write ``o_k = o_lo + 2^lo * o_hi`` with
    STATIC digits of the (compile-time) evaluation orders; then with
    ``x = psi^a``:

        psi^(a * o_k) = x^{o_lo(k)} * (x^{2^lo})^{o_hi(k)}

    ``build_tables(amounts)`` produces the per-column power tables
    ``P1[t] = x^t`` (t < 2^lo) and ``P2[u] = (x^{2^lo})^u`` once for ALL
    steps (a ladder of ~n_lo + n_hi sequential elementwise muls on the small
    ``(n_steps, B)`` grid), and ``select(p1_i, p2_i)`` turns one step's
    slices into the ``(rows, N, B)`` multiplier values with two STATIC
    one-hot int8 dots (exact: a one-hot dot is a copy) and a single
    elementwise modmul — replacing the per-step 11-deep square-multiply
    ladder (log2n sequential (N, B) modmuls) that previously dominated the
    CMUX step.
    """
    two_n = 2 * ntt.n
    n = ntt.n
    log2n = two_n.bit_length() - 1
    lo_bits = log2n // 2
    n_lo = 1 << lo_bits
    n_hi = two_n >> lo_bits
    q = field.q
    psi_pows2 = [pow(ntt.psi, 1 << j, q) for j in range(log2n)]
    psi_pows2_sh = [int(field.shoup(w)) for w in psi_pows2]

    orders_np = np.asarray(ntt.orders)
    # host numpy closures: embedded by value at trace time
    oh_lo = np.zeros((n, n_lo), dtype=np.int8)
    oh_lo[np.arange(n), orders_np % n_lo] = 1
    oh_hi = np.zeros((n, n_hi), dtype=np.int8)
    oh_hi[np.arange(n), orders_np >> lo_bits] = 1

    levels = -(-field.bits // 7)
    big = field.bits > 27  # recombined one-hot dots need int64

    def build_tables(amounts):
        """amounts (n_steps, B) in [0, 2N) ->
        (P1 (n_lo, n_steps, B), P2 (n_hi, n_steps, B)).
        """
        one = jnp.ones(amounts.shape, dtype=field.storage_dtype)
        x = one
        for j in range(log2n):
            bit = ((amounts >> j) & 1).astype(bool)
            stepped = field.mul_shoup(
                x, jnp.int64(psi_pows2[j]), jnp.int64(psi_pows2_sh[j])
            )
            x = jnp.where(bit, stepped, x)
        p1 = [one, x]
        for _ in range(n_lo - 2):
            p1.append(field.mul(p1[-1], x))
        y = field.mul(p1[-1], x)  # x^{2^lo}
        p2 = [one, y]
        for _ in range(n_hi - 2):
            p2.append(field.mul(p2[-1], y))
        return jnp.stack(p1), jnp.stack(p2)

    def _onehot_select(oh, tab):
        """tab (n_e, rows, B) in [0, q) -> exact values (N, rows, B)."""
        n_e, rows, b = tab.shape
        planes = jnp.stack(
            [
                ((tab >> jnp.int64(7 * a)) & jnp.int64(127)).astype(jnp.int8)
                for a in range(levels)
            ],
            axis=1,
        ).reshape(n_e, levels * rows * b)
        sel = jax.lax.dot_general(
            oh,
            planes,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).reshape(n, levels, rows, b)
        if big:
            sel = sel.astype(jnp.int64)
        out = sel[:, 0]
        for a in range(1, levels):
            out = out + (sel[:, a] << (7 * a))
        return out.astype(field.storage_dtype)

    def select(p1_i, p2_i):
        """p1_i (n_lo, rows, B), p2_i (n_hi, rows, B) ->
        mono (rows, N, B) = psi^(a*o_k) - 1."""
        s1 = _onehot_select(oh_lo, p1_i)  # (N, rows, B)
        s2 = _onehot_select(oh_hi, p2_i)
        mono = field.mul(s1, s2)
        mono = field.sub(mono, jnp.ones((), dtype=field.storage_dtype))
        return jnp.moveaxis(mono, 1, 0)

    return build_tables, select


def make_blind_rotate(
    field: PrimeField,
    ntt: NegacyclicNtt,
    gadget: SignedGadget,
    paired: bool = False,
):
    """Returns blind_rotate(acc, amounts, bsk, bsk_sh).

    acc:     (N, 2, B) int64 coefficient domain, the accumulator (a, b).
    amounts: (n_lwe, B) int64 rotation amounts in [0, 2N) (the LWE a-vector).
    bsk:     (n_lwe, N, d, 2, 2) int64 NTT-domain RGSW keys (+ Shoup planes).

    Computes ACC <- ACC + (X^{a_i} - 1) * (ACC (x) RGSW(s_i)) for each i,
    i.e. the CMUX chain of TFHE blind rotation for binary LWE secrets.
    """
    two_n = 2 * ntt.n
    rows = 3 if paired else 1
    build_tables, mono_select = make_mono_powers(field, ntt)

    def step(i, acc, p1, p2, bsk, bsk_sh):
        # paired step: three RGSW rows [m10, m01, m11] and three rotations
        # [a0, a1, a0+a1] handled with ONE decomposition + forward NTT;
        # unpaired step: the same code with a single row [s_i] and [a_i]
        p1_i = jax.lax.dynamic_slice_in_dim(p1, rows * i, rows, axis=1)
        p2_i = jax.lax.dynamic_slice_in_dim(p2, rows * i, rows, axis=1)
        k_i = jax.lax.dynamic_slice_in_dim(bsk, rows * i, rows, axis=0)
        k_sh_i = jax.lax.dynamic_slice_in_dim(bsk_sh, rows * i, rows, axis=0)

        # gadget-decompose both acc polys: (N, d, 2, B)
        digs = gadget.decompose_to_field(acc, axis=1)
        dn = ntt.fwd(digs)
        # MAC against the three RGSW rows:
        # P[t, n, o, b] = sum_{j,c} dn[n,j,c,b] * K[t,n,j,c,o]
        prod = field.mul_shoup(
            dn[None, :, :, :, None, :], k_i[..., None], k_sh_i[..., None]
        )
        p = field.reduce(
            field._up(prod).sum(axis=(2, 3)),
            field.bits + (2 * gadget.d).bit_length() + 1,
        )  # (3, N, 2, B)
        mono = mono_select(p1_i, p2_i)  # (rows, N, B)
        p = field.mul(p, mono[:, :, None, :])
        if paired:
            p = field.mod_sum(p, axis=0)  # (N, 2, B)
        else:
            p = p[0]
        return field.add(acc, ntt.inv(p))

    def blind_rotate(acc, amounts, bsk, bsk_sh):
        """amounts (n_lwe, B); bsk rows are the 3-per-pair layout
        (3*n_lwe/2, N, d, 2, 2) from keygen's ``_pair_bits`` when paired,
        else the plain per-bit layout (n_lwe, N, d, 2, 2)."""
        acc = acc.astype(field.storage_dtype)
        n_lwe = amounts.shape[0]
        if paired:
            assert n_lwe % 2 == 0, "pairwise CMUX needs an even LWE dimension"
            a0 = amounts[0::2]
            a1 = amounts[1::2]
            a01 = (a0 + a1) % two_n
            amounts_r = jnp.stack([a0, a1, a01], axis=1).reshape(
                3 * (n_lwe // 2), amounts.shape[1]
            )
            n_steps = n_lwe // 2
        else:
            amounts_r = amounts
            n_steps = n_lwe
        p1, p2 = build_tables(amounts_r)
        return jax.lax.fori_loop(
            0,
            n_steps,
            lambda i, a: step(i, a, p1, p2, bsk, bsk_sh),
            acc,
        )

    return blind_rotate


def init_accumulator(field: PrimeField, ext_lut: jnp.ndarray, b: jnp.ndarray, n: int):
    """ACC init = X^{-b} * LUT: coefficient k is ext_lut[(k + b) mod 2N].

    ext_lut: (2N,) = [lut, -lut]. b: (B,) int64. Returns (N, 2, B) with the
    a-part zero.
    """
    ks = jnp.arange(n, dtype=jnp.int64)[:, None]
    idx = (ks + b[None, :]) % (2 * n)
    acc_b = ext_lut[idx]  # (N, B)
    return jnp.stack([jnp.zeros_like(acc_b), acc_b], axis=1)


def make_init_accumulator(field: PrimeField, ext_lut_np: np.ndarray, n: int):
    """Gather-free ``init_accumulator``: the LUT rotation is a one-hot int8
    dot against the static shifted-LUT digit planes:
    acc_b[k, b] = lut_shift[k, t]·[t == b] with lut_shift[k, t] =
    ext_lut[(k + t) mod 2N].
    """
    two_n = 2 * n
    lut = np.asarray(ext_lut_np, dtype=np.int64)
    ks = np.arange(n, dtype=np.int64)[:, None]
    ts = np.arange(two_n, dtype=np.int64)[None, :]
    shift = lut[(ks + ts) % two_n]  # (N, 2N) static
    levels = -(-field.bits // 7)
    planes_np = np.concatenate(
        [((shift >> (7 * a)) & 127).astype(np.int8) for a in range(levels)],
        axis=0,
    )  # (L*N, 2N), HOST numpy (device copy rides the jit args)

    wide = field.bits > 27

    def init(b, planes=None):
        if planes is None:
            planes = planes_np
        oh = (
            jnp.arange(two_n, dtype=b.dtype)[:, None] == b[None, :]
        ).astype(jnp.int8)  # (2N, B)
        sel = jax.lax.dot_general(
            planes, oh, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (L*N, B)
        out = sel[0:n].astype(jnp.int64) if wide else sel[0:n]
        for a in range(1, levels):
            blk = sel[a * n : (a + 1) * n]
            out = out + (
                (blk.astype(jnp.int64) if wide else blk) << (7 * a)
            )
        acc_b = out.astype(field.storage_dtype)
        return jnp.stack([jnp.zeros_like(acc_b), acc_b], axis=1)

    init.planes = planes_np
    return init


def extract_constant_lwe(field: PrimeField, acc):
    """Sample-extract the constant coefficient as an LWE ciphertext.

    acc: (N, 2, B). Returns (a_vec (N, B), b (B,)): a_vec[0] = A[0],
    a_vec[j] = -A[N-j] so the LWE secret is the ring key's coefficient vector
    in natural order (counterpart of ``extract_lwe_locally``,
    reference ``detector.rs:560-561``).
    """
    n = acc.shape[0]
    # index map (-j) mod n == [0, n-1, ..., 1]: row 0 then the reversed
    # tail — lax.rev instead of a gather
    a = acc[:, 0, :]
    a_perm = jnp.concatenate([a[0:1], jnp.flip(a[1:], axis=0)], axis=0)
    sign_neg = jnp.arange(n)[:, None] > 0
    a_vec = jnp.where(sign_neg, field.neg(a_perm), a_perm)
    return a_vec, acc[0, 1, :]


def make_lwe_keyswitch(field: PrimeField, digits: int, n_out: int):
    """Returns keyswitch(a_vec (B, n_in), b (B,)) -> (a (B,n_out), b (B,)).

    Binary-digit LWE key switch as int8 limb matmuls; the combined
    key matrix has the b-row as its last column. Counterpart of
    ``NonPowOf2LweKeySwitchingKey::key_switch`` (``detector.rs:560-563``).
    """
    limbs = -(-field.bits // 7)
    shifts = np.arange(digits, dtype=np.int32)

    def keyswitch(a_vec, b, ksk_limbs):
        bsz, n_in = a_vec.shape
        a32 = a_vec.astype(jnp.int32)
        # digit-major bit expansion: (B, digits, n_in) keeps the wide n_in
        # axis minor (not the 27-wide digit axis); the KSK rows are
        # ordered to match
        bits = (
            (a32[:, None, :] >> shifts[None, :, None]) & 1
        ).astype(jnp.int8)
        bits = bits.reshape(bsz, digits * n_in)
        acc = jnp.zeros((bsz, n_out + 1), dtype=jnp.int64)
        for k in range(limbs):
            part = jax.lax.dot_general(
                bits,
                ksk_limbs[k],
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).astype(jnp.int64)
            acc = acc + (part << (7 * k))
        bound = (n_in * digits * 127).bit_length() + 7 * (limbs - 1) + 2
        acc = field.reduce(acc, bound)
        out_a = field.neg(acc[:, :n_out])
        out_b = field.sub(b, acc[:, n_out])
        return out_a, out_b

    return keyswitch


def lwe_modulus_switch(field: PrimeField, x, new_modulus: int):
    """Round-scale an LWE ciphertext component from q to a power-of-2 modulus.

    y = round(x * q' / q) mod q' (counterpart of ``lwe_modulus_switch``,
    reference ``detector.rs:571-575``).
    """
    q = field.q
    qp = jnp.int64(new_modulus)
    y = (x * (2 * qp) + jnp.int64(q)) // jnp.int64(2 * q)
    return y & (new_modulus - 1)


def make_trace(
    field: PrimeField,
    ntt: NegacyclicNtt,
    gadget: SignedGadget,
    autos,
):
    """Returns trace(acc (N,2,B), trace_k, trace_k_sh) -> (N,2,B).

    EvalTr: log2(N) rounds of c <- c + KS(sigma_g(c)); the caller must
    pre-multiply by N^{-1} (reference ``detector.rs:634-638``). ``autos`` is
    OmrContext.trace_autos; rounds are statically unrolled so the gather
    permutations are compile-time constants.
    """

    def trace(acc, trace_k, trace_k_sh):
        for r, (g, gidx, gsign) in enumerate(autos):
            gi = jnp.asarray(gidx)
            gs = jnp.asarray(gsign)[:, None, None]
            auto = field.to_field(gs * acc[gi])  # (N, 2, B)
            digs = gadget.decompose_to_field(auto[:, 0, :], axis=1)  # (N,d,B)
            dn = ntt.fwd(digs)
            tk = trace_k[r]  # (N, d, 2)
            tk_sh = trace_k_sh[r]
            prod = field.mul_shoup(
                dn[:, :, None, :], tk[..., None], tk_sh[..., None]
            )
            p = field.reduce(
                prod.sum(axis=1), field.bits + gadget.d.bit_length() + 1
            )  # (N, 2, B)
            pc = ntt.inv(p)
            new_a = field.neg(pc[:, 0, :])
            new_b = field.sub(auto[:, 1, :], pc[:, 1, :])
            acc = field.add(acc, jnp.stack([new_a, new_b], axis=1))
        return acc

    return trace
