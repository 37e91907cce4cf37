"""The omd correctness oracle: the framework's primary end-to-end check.

Counterpart of reference ``omr_core/examples/omd.rs``: detect one pertinent
clue (encrypted under the recipient's key) and one non-pertinent clue
(another recipient's key), decrypt the pertinency ciphertexts, and assert
they decode to [1, 0, ..., 0] and all-zeros respectively (``omd.rs:48-58``).
"""

import numpy as np
import pytest

from tfhe_omr.core.keygen import SecretKeyPack
from tfhe_omr.core.params import OmrParameters
from tfhe_omr.core.sender import ClueBatch


def run_omd(params, seed=3):
    skp = SecretKeyPack(params, rng=seed)
    skp2 = SecretKeyPack(params, rng=seed + 1)
    rng = np.random.default_rng(seed + 2)

    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()

    clues = sender.gen_clues(2, rng)  # pertinent
    clues2 = sender2.gen_clues(2, rng)  # not pertinent
    batch = ClueBatch.concat([clues, clues2])

    result = detector.detect(batch)  # (4, 2, N2)
    dec = skp.decrypt_rlwe2_ntt(result)

    q = params.q2
    t = params.output_plain_modulus
    decoded = np.mod((dec * (2 * t) + q) // (2 * q), t)
    return decoded


@pytest.mark.parametrize("noise_free", [True, False])
def test_omd_tiny(noise_free):
    params = OmrParameters.tiny(noise_free=noise_free)
    decoded = run_omd(params)
    # pertinent messages decode to [1, 0, ..., 0]
    for i in (0, 1):
        assert decoded[i, 0] == 1, decoded[i, :8]
        assert not decoded[i, 1:].any()
    # non-pertinent messages decode to all zeros
    assert not decoded[2:].any()


def test_omd_device_clues():
    """The omd oracle with ON-DEVICE clue generation (Sender
    .gen_clues_device): device-sampled masks/noise must decrypt exactly
    like the host path (counterpart of ``examples/omr.rs:126-135``)."""
    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=3)
    skp2 = SecretKeyPack(params, rng=4)
    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()
    batch = ClueBatch.concat(
        [sender.gen_clues_device(2, seed=7), sender2.gen_clues_device(2, seed=8)]
    )
    dec = skp.decrypt_rlwe2_ntt(detector.detect(batch))
    q = params.q2
    t = params.output_plain_modulus
    decoded = np.mod((dec * (2 * t) + q) // (2 * q), t)
    for i in (0, 1):
        assert decoded[i, 0] == 1, decoded[i, :8]
        assert not decoded[i, 1:].any()
    assert not decoded[2:].any()


def test_device_clues_chunking_consistency():
    """Chunked device clue generation is deterministic per seed and
    count-prefix-consistent: chunks are keyed by fold_in(chunk index), so
    requesting more clues must extend — not reshuffle — the stream (a
    regression here would silently change which messages a fixed-seed
    experiment marks pertinent)."""
    params = OmrParameters.tiny()
    sender = SecretKeyPack(params, rng=3).generate_sender()
    small = sender.gen_clues_device(5, seed=11)
    again = sender.gen_clues_device(5, seed=11)
    np.testing.assert_array_equal(small.a, again.a)
    np.testing.assert_array_equal(small.b7, again.b7)
    # crosses a chunk boundary -> exercises multi-chunk concatenation
    big = sender.gen_clues_device(sender.CHUNK + 7, seed=11)
    np.testing.assert_array_equal(big.a[:5], small.a)
    np.testing.assert_array_equal(big.b7[:5], small.b7)
    assert big.a.shape[0] == sender.CHUNK + 7


@pytest.mark.slow
def test_omd_default_params():
    """The reference parameter set end-to-end (slow on CPU)."""
    params = OmrParameters.default()
    decoded = run_omd(params)
    for i in (0, 1):
        assert decoded[i, 0] == 1, decoded[i, :8]
        assert not decoded[i, 1:].any()
    assert not decoded[2:].any()
