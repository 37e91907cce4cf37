"""Sharded detection/digest must be bit-identical to single-device results.

The digest reduction is exact modular addition, so sharding can change
nothing (SURVEY.md §4 test plan). Runs on the 8 virtual CPU devices forced
by conftest.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_omr.core.keygen import SecretKeyPack
from tfhe_omr.core.params import OmrParameters
from tfhe_omr.core.sender import ClueBatch
from tfhe_omr.parallel import ShardedDetector, make_data_mesh


@pytest.fixture(scope="module")
def setup():
    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=21)
    rng = np.random.default_rng(22)
    sender = skp.generate_sender()
    detector = skp.generate_detector()
    clues = sender.gen_clues(16, rng)
    return params, skp, detector, clues


def test_mesh_has_devices():
    assert len(jax.devices()) == 8


def test_sharded_detect_matches_single(setup):
    params, skp, detector, clues = setup
    mesh = make_data_mesh()
    sharded = ShardedDetector(detector, mesh)

    single = np.asarray(detector.detect(clues))
    multi = np.asarray(sharded.detect(clues))
    np.testing.assert_array_equal(single, multi)


def test_sharded_detect_pads_ragged_batches(setup):
    """A batch not divisible by the device count zero-pads internally."""
    params, skp, detector, clues = setup
    sharded = ShardedDetector(detector, make_data_mesh())
    ragged = ClueBatch(clues.a[:11], clues.b7[:11])
    single = np.asarray(detector.detect(ragged))
    multi = np.asarray(sharded.detect(ragged))
    assert multi.shape[0] == 11
    np.testing.assert_array_equal(single, multi)


def test_sharded_full_digest_matches_single(setup):
    """encode_pertinent_indices / encode_pertinent_payloads through the
    psum path == the single-device encoders (same rng streams)."""
    from tfhe_omr.core.payload import random_payloads

    params, skp, detector, clues = setup
    sharded = ShardedDetector(detector, make_data_mesh())
    pv = detector.detect(clues)
    rp = skp.generate_retriever(16, 4).params

    s_idx = detector.encode_pertinent_indices(
        rp, pv, np.random.default_rng(7), chunk=8
    )
    m_idx = sharded.encode_pertinent_indices(
        rp, pv, np.random.default_rng(7), chunk=8
    )
    np.testing.assert_array_equal(np.asarray(s_idx), np.asarray(m_idx))

    payloads = random_payloads(np.random.default_rng(8), 16,
                               rp.payload_length)
    s_pay = detector.encode_pertinent_payloads(rp, pv, payloads, 9, chunk=8)
    m_pay = sharded.encode_pertinent_payloads(rp, pv, payloads, 9, chunk=8)
    np.testing.assert_array_equal(np.asarray(s_pay), np.asarray(m_pay))


@pytest.mark.slow
def test_sharded_default_params_matches_single():
    """Bit-equality of sharded vs single-device detect AND both digest
    encoders at the REFERENCE parameter set (small batch, 8-device CPU
    mesh) — the psum shape at real parameters, counterpart of reference
    ``detector.rs:333-336,445-449``. The digest layout is the production
    D=65536 one (130 buckets x 25 segments, 5 index cts, 28 payload cts)
    even though only 16 messages are detected."""
    from tfhe_omr.core.payload import random_payloads

    params = OmrParameters.default()
    skp = SecretKeyPack(params, rng=51)
    detector = skp.generate_detector()
    sender = skp.generate_sender()
    rng = np.random.default_rng(52)
    clues = sender.gen_clues(16, rng)
    sharded = ShardedDetector(detector, make_data_mesh())

    single = detector.detect(clues)
    multi = sharded.detect(clues)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(multi))

    # production digest layout: retrieval params for D=65536, k=50
    rp = skp.generate_retriever(65536, 50).params
    assert rp.max_encode_indices_cipher_count == 5
    s_idx = detector.encode_pertinent_indices(
        rp, single, np.random.default_rng(7), chunk=8
    )
    m_idx = sharded.encode_pertinent_indices(
        rp, multi, np.random.default_rng(7), chunk=8
    )
    np.testing.assert_array_equal(np.asarray(s_idx), np.asarray(m_idx))

    payloads = random_payloads(np.random.default_rng(8), 16,
                               rp.payload_length)
    s_pay = detector.encode_pertinent_payloads(
        rp, single, payloads, 9, chunk=8
    )
    m_pay = sharded.encode_pertinent_payloads(
        rp, multi, payloads, 9, chunk=8
    )
    np.testing.assert_array_equal(np.asarray(s_pay), np.asarray(m_pay))


def test_sharded_encode_matches_single(setup):
    params, skp, detector, clues = setup
    mesh = make_data_mesh()
    sharded = ShardedDetector(detector, mesh)

    pv = detector.detect(clues)
    retr = skp.generate_retriever(16, 4)
    rp = retr.params
    rng = np.random.default_rng(5)
    plain = detector.build_index_plaintexts(rp, 16, rng)

    single = np.asarray(
        detector._encode_chunk_jit(
            pv, jnp.asarray(plain),
            jnp.zeros((2, params.n2), dtype=jnp.int64),
        )
    )
    multi = np.asarray(sharded.encode_chunk(pv, plain))
    np.testing.assert_array_equal(single, multi)
