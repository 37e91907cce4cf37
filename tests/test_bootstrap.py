"""Bootstrapping primitive tests on tiny parameters (noise-free mode)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.helpers import centered, lwe_encrypt, rlwe_decrypt_coeff, rlwe_encrypt_coeff

from tfhe_omr.core.keygen import SecretKeyPack
from tfhe_omr.core.lut import first_level_lut
from tfhe_omr.core.params import OmrParameters
from tfhe_omr.ops.bootstrap import (
    extract_constant_lwe,
    init_accumulator,
    lwe_modulus_switch,
    make_blind_rotate,
    make_lwe_keyswitch,
    make_trace,
)


@pytest.fixture(scope="module")
def nf_pack():
    """Noise-free tiny secret key pack + detection key."""
    params = OmrParameters.tiny(noise_free=True)
    skp = SecretKeyPack(params, rng=7)
    dk = skp.generate_detection_key()
    return skp, dk


def test_blind_rotate_lut1(nf_pack, rng):
    """BR1 of LWE(m) under the clue key must output LUT1(m) in slot 0."""
    skp, dk = nf_pack
    ctx = skp.ctx
    p = skp.params
    n1, q1 = p.n1, p.q1
    q0 = p.clue_params.cipher_modulus
    t0 = p.clue_params.plain_modulus
    delta0 = q0 // t0
    lut = first_level_lut(p)
    t_out = p.intermediate_lwe.plain_modulus
    delta1 = ((q1 >> (t_out.bit_length() - 2)) + 1) >> 1
    expected_by_m = {0: delta1, 4: q1 - delta1}

    br = make_blind_rotate(ctx.f1, ctx.ntt1, ctx.gadget_br1, paired=True)
    lut1_ext = jnp.asarray(ctx.lut1_ext)

    ms, avecs, bs = [], [], []
    for m in range(t0):
        a, b = lwe_encrypt(skp.clue_sk, q0, delta0, m, rng)
        ms.append(m)
        avecs.append(a)
        bs.append(b)
    avecs = np.stack(avecs)  # (8, n0)
    bs = np.asarray(bs)

    acc = init_accumulator(ctx.f1, lut1_ext, jnp.asarray(bs), n1)
    acc = br(acc, jnp.asarray(avecs.T), dk.bsk1, dk.bsk1_sh)
    acc_np = np.asarray(acc)  # (N1, 2, 8)

    for i, m in enumerate(ms):
        dec = rlwe_decrypt_coeff(
            ctx, 1, skp.z1_ntt, acc_np[:, 0, i], acc_np[:, 1, i]
        )
        got = int(dec[0])
        want = int(expected_by_m.get(m, 0))
        err = centered(got - want, q1)
        assert abs(err) < q1 // (4 * t_out * 2), (m, got, want, err)


def test_extract_and_keyswitch(nf_pack, rng):
    """Extract slot-0 LWE from an RLWE ct and key switch to s2."""
    skp, dk = nf_pack
    ctx = skp.ctx
    p = skp.params
    q1 = p.q1
    n1 = p.n1
    mu = np.zeros(n1, dtype=np.int64)
    msg = 123456 % q1
    mu[0] = msg
    mu[5] = 999  # garbage in another slot must not leak into slot 0
    a, b = rlwe_encrypt_coeff(ctx, 1, skp.z1_ntt, mu, rng)

    acc = jnp.stack(
        [jnp.asarray(a)[:, None], jnp.asarray(b)[:, None]], axis=1
    )  # (N1, 2, 1)
    a_vec, b0 = extract_constant_lwe(ctx.f1, acc)
    # direct LWE decrypt under z1 coefficients
    phase = np.mod(
        int(b0[0]) - np.asarray(a_vec)[:, 0] @ np.mod(skp.z1, q1), q1
    )
    assert phase == msg

    ks = make_lwe_keyswitch(
        ctx.f1, p.first_level_ks.digits, p.first_level_ks.out_dimension
    )
    ks_a, ks_b = ks(a_vec.T, b0, dk.ksk_limbs)
    phase2 = np.mod(
        int(ks_b[0]) - np.asarray(ks_a)[0] @ skp.inter_sk, q1
    )
    err = centered(phase2 - msg, q1)
    assert abs(err) < 1000, err


def test_modulus_switch(nf_pack, rng):
    skp, _ = nf_pack
    ctx = skp.ctx
    q1 = skp.params.q1
    x = rng.integers(0, q1, size=1000, dtype=np.int64)
    y = np.asarray(lwe_modulus_switch(ctx.f1, jnp.asarray(x), 1024))
    want = np.mod((x * 1024 * 2 + q1) // (2 * q1), 1024)
    np.testing.assert_array_equal(y, want)


def test_blind_rotate_lut2_and_trace(nf_pack, rng):
    """BR2 + N^-1 + trace: output encrypts bit only in slot 0."""
    skp, dk = nf_pack
    ctx = skp.ctx
    p = skp.params
    n2, q2 = p.n2, p.q2
    q_i = p.intermediate_lwe.cipher_modulus
    t_i = p.intermediate_lwe.plain_modulus
    delta_i = q_i // t_i
    pmod = p.output_plain_modulus
    delta2 = (2 * q2 + pmod) // (2 * pmod)

    br = make_blind_rotate(ctx.f2, ctx.ntt2, ctx.gadget_br2, paired=True)
    trace = make_trace(ctx.f2, ctx.ntt2, ctx.gadget_trace, ctx.trace_autos)
    lut2_ext = jnp.asarray(ctx.lut2_ext)

    msgs = [2 * p.clue_count, 5, 0]  # 14 -> bit 1; others -> 0
    avecs, bs = [], []
    for m in msgs:
        a, b = lwe_encrypt(skp.inter_sk, q_i, delta_i, m, rng)
        avecs.append(a)
        bs.append(b)
    avecs = np.stack(avecs)
    bs = np.asarray(bs)

    acc = init_accumulator(ctx.f2, lut2_ext, jnp.asarray(bs), n2)
    acc = br(acc, jnp.asarray(avecs.T), dk.bsk2, dk.bsk2_sh)

    n2_inv = ctx.f2.inv(n2)
    acc = ctx.f2.mul_shoup(
        acc, jnp.int64(n2_inv), jnp.int64(int(ctx.f2.shoup(n2_inv)))
    )
    acc = trace(acc, dk.trace_k, dk.trace_k_sh)
    acc_np = np.asarray(acc)

    for i, m in enumerate(msgs):
        dec = rlwe_decrypt_coeff(
            ctx, 2, skp.z2_ntt, acc_np[:, 0, i], acc_np[:, 1, i]
        )
        bit = 1 if m == 2 * p.clue_count else 0
        err0 = centered(int(dec[0]) - bit * delta2, q2)
        assert abs(err0) < q2 // (4 * pmod), (m, err0)
        # all other slots must be ~0 (that is the point of the trace)
        rest = centered(dec[1:], q2)
        assert np.abs(rest).max() < q2 // (4 * pmod), np.abs(rest).max()
