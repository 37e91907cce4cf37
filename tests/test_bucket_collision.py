"""Forced bucket-collision decode: the multi-ciphertext accumulation loop.

With many pertinent messages and few buckets, two messages drawing the same
bucket in a segment wipe each other's flag slot (flag sums to 2, not 1), so
one index-digest ciphertext is insufficient and the retriever must
accumulate across the redundant digests — reference ``retriever.rs:200-204``
(the ``decode_pertinent_indices`` loop in ``decode_digest``) and the retry
accumulation here at ``retriever.py`` ``decode_digest``. Also exercises the
``IndexDecodeError`` failure path when the supplied digests don't suffice.

Pertinency ciphertexts are built directly as noise-free RLWE encryptions
(a = 0, b = NTT(Delta * bit) = Delta * bit in every slot) so the test
exercises the encoder + accumulation loop without paying for bootstrapping.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_omr.core.errors import IndexDecodeError
from tfhe_omr.core.keygen import SecretKeyPack
from tfhe_omr.core.params import OmrParameters, RetrievalParams
from tfhe_omr.core.payload import random_payloads

# Seed chosen so the FIRST index ciphertext recovers only 23/24 indices
# (one bucket collision in every segment for that message) and the second
# completes the set — verified by the assertions below, which would fail
# on a seed without a forced collision.
SEED = 1
COUNT, PERTINENT = 64, 24


def _setup():
    params = OmrParameters.tiny(noise_free=True)
    skp = SecretKeyPack(params, rng=3)
    det = skp.generate_detector()
    q2 = skp.ctx.f2.q
    p = params.output_plain_modulus
    delta = (2 * q2 + p) // (2 * p)
    rp = RetrievalParams.for_params(params, COUNT, PERTINENT)

    rng = np.random.default_rng(SEED)
    pert = np.zeros(COUNT, dtype=bool)
    pert[:PERTINENT] = True
    rng.shuffle(pert)
    b = jnp.asarray(
        np.repeat(
            (delta * pert.astype(np.int64))[:, None], rp.polynomial_size, 1
        )
    )
    pert_cts = jnp.stack([jnp.zeros_like(b), b], axis=1)  # (B, 2, N2)
    index_cts = [
        det.encode_pertinent_indices(rp, pert_cts, rng)
        for _ in range(rp.max_encode_indices_cipher_count)
    ]
    true_idx = sorted(np.nonzero(pert)[0].tolist())
    return skp, det, rp, pert_cts, index_cts, true_idx, rng


def test_first_ciphertext_insufficient_second_completes():
    skp, det, rp, pert_cts, index_cts, true_idx, rng = _setup()
    retr = skp.generate_retriever(COUNT, PERTINENT)
    # first digest alone must NOT complete (forced collision)
    assert not retr.decode_pertinent_indices(np.asarray(index_cts[0]))
    assert len(retr.pertinent_indices_set) < PERTINENT
    # the redundant digest resolves the collided message
    assert retr.decode_pertinent_indices(np.asarray(index_cts[1]))
    assert sorted(retr.pertinent_indices_set) == true_idx


def test_decode_digest_accumulates_across_ciphertexts():
    skp, det, rp, pert_cts, index_cts, true_idx, rng = _setup()
    payloads = random_payloads(rng, COUNT, rp.payload_length)
    seed_digest = 987
    payload_cts = det.encode_pertinent_payloads(
        rp, pert_cts, payloads, seed_digest
    )
    retr = skp.generate_retriever(COUNT, PERTINENT)
    indices, solved = retr.decode_digest(
        index_cts, payload_cts, seed_digest
    )
    assert indices == true_idx
    np.testing.assert_array_equal(solved, payloads[true_idx])


def test_insufficient_digests_raise_index_decode_error():
    skp, det, rp, pert_cts, index_cts, true_idx, rng = _setup()
    payloads = random_payloads(rng, COUNT, rp.payload_length)
    payload_cts = det.encode_pertinent_payloads(rp, pert_cts, payloads, 5)
    retr = skp.generate_retriever(COUNT, PERTINENT)
    with pytest.raises(IndexDecodeError):
        retr.decode_digest(index_cts[:1], payload_cts, 5)
