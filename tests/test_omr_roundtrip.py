"""Full OMR round trip: clues -> detect -> digest -> decode -> payloads.

Counterpart of the end-to-end verification in reference
``omr_core/examples/omr.rs:222-232`` (decoded payloads must equal the
originals byte-wise) and the index assertions of
``examples/omr_time_analyze.rs:215-235``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_omr.core.keygen import SecretKeyPack
from tfhe_omr.core.params import OmrParameters, RetrievalParams
from tfhe_omr.core.payload import random_payloads
from tfhe_omr.core.sender import ClueBatch


def run_omr(params, all_count, pertinent_count, seed=11):
    skp = SecretKeyPack(params, rng=seed)
    skp2 = SecretKeyPack(params, rng=seed + 1)
    rng = np.random.default_rng(seed + 2)

    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()

    pertinent = np.zeros(all_count, dtype=bool)
    pertinent[:pertinent_count] = True
    rng.shuffle(pertinent)
    true_indices = sorted(np.nonzero(pertinent)[0].tolist())

    own = sender.gen_clues(int(pertinent.sum()), rng)
    other = sender2.gen_clues(int((~pertinent).sum()), rng)
    a = np.zeros((all_count, own.a.shape[1]), dtype=np.int64)
    b7 = np.zeros((all_count, own.b7.shape[1]), dtype=np.int64)
    a[pertinent], b7[pertinent] = own.a, own.b7
    a[~pertinent], b7[~pertinent] = other.a, other.b7
    clues = ClueBatch(a, b7)

    payloads = random_payloads(rng, all_count, params.payload_length)

    pertinency = detector.detect(clues)

    retriever = skp.generate_retriever(all_count, pertinent_count)
    rp = retriever.params

    index_cts = [
        detector.encode_pertinent_indices(rp, pertinency, rng)
        for _ in range(rp.max_encode_indices_cipher_count)
    ]
    seed_digest = rng.integers(0, 2**63)
    payload_cts = detector.encode_pertinent_payloads(
        rp, pertinency, payloads, seed_digest
    )

    indices, solved = retriever.decode_digest(index_cts, payload_cts, seed_digest)
    return true_indices, indices, payloads, solved


def test_roundtrip_tiny():
    params = OmrParameters.tiny()
    true_indices, indices, payloads, solved = run_omr(params, 48, 6)
    assert indices == true_indices
    np.testing.assert_array_equal(solved, payloads[indices])


def test_roundtrip_tiny_all_pertinent():
    params = OmrParameters.tiny()
    true_indices, indices, payloads, solved = run_omr(params, 8, 8)
    assert indices == true_indices
    np.testing.assert_array_equal(solved, payloads[indices])


def test_roundtrip_with_protocol_false_positive():
    """A clue-collision false positive is NOT a failure: the detector flags
    the message (by design, rate t^-clue_count — reference
    ``detector.rs:479-503``), its index decodes as an extra, and its payload
    still decodes byte-exactly. The verification oracle is the reference's
    own subset assertion (``examples/omr_time_analyze.rs:215-235``) plus
    byte-exact payloads for ALL decoded indices; decrypt_compact_clue then
    confirms the mechanism per-event (all clues decrypt to LUT1's accept
    value 0)."""
    params = OmrParameters.tiny()
    all_count, pertinent_count = 48, 6
    skp = SecretKeyPack(params, rng=31)
    skp2 = SecretKeyPack(params, rng=32)
    rng = np.random.default_rng(33)

    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()

    pertinent = np.zeros(all_count, dtype=bool)
    pertinent[:pertinent_count] = True
    rng.shuffle(pertinent)
    true_indices = sorted(np.nonzero(pertinent)[0].tolist())

    # a "collision" message: ground-truth NON-pertinent, but its clues are
    # valid encryptions of zero under the recipient's key — exactly what an
    # 8^-7 clue collision looks like to the detector
    fp_index = int(np.nonzero(~pertinent)[0][3])

    own = sender.gen_clues(pertinent_count + 1, rng)
    other = sender2.gen_clues(all_count - pertinent_count - 1, rng)
    a = np.zeros((all_count, own.a.shape[1]), dtype=np.int64)
    b7 = np.zeros((all_count, own.b7.shape[1]), dtype=np.int64)
    own_rows = np.zeros(all_count, dtype=bool)
    own_rows[np.nonzero(pertinent)[0]] = True
    own_rows[fp_index] = True
    a[own_rows], b7[own_rows] = own.a, own.b7
    a[~own_rows], b7[~own_rows] = other.a, other.b7
    clues = ClueBatch(a, b7)

    payloads = random_payloads(rng, all_count, params.payload_length)
    pertinency = detector.detect(clues)

    retriever = skp.generate_retriever(all_count, pertinent_count)
    rp = retriever.params
    index_cts = [
        detector.encode_pertinent_indices(rp, pertinency, rng)
        for _ in range(rp.max_encode_indices_cipher_count)
    ]
    seed_digest = rng.integers(0, 2**63)
    payload_cts = detector.encode_pertinent_payloads(
        rp, pertinency, payloads, seed_digest
    )
    indices, solved = retriever.decode_digest(
        index_cts, payload_cts, seed_digest
    )

    # subset + extras semantics
    assert set(true_indices) <= set(indices)
    extras = [i for i in indices if i not in set(true_indices)]
    assert extras == [fp_index]
    # the FP's payload decodes byte-exactly too — the run is correct
    np.testing.assert_array_equal(solved, payloads[indices])

    # per-event mechanism confirmation: every clue of the FP decrypts to 0
    vals = skp.decrypt_compact_clue(a[fp_index], b7[fp_index])
    assert (vals == 0).all()
    # ... and a genuine non-pertinent message's clues do not
    genuine = int(np.nonzero(~own_rows)[0][0])
    vals2 = skp.decrypt_compact_clue(a[genuine], b7[genuine])
    assert (vals2 != 0).any()


def test_device_encoders_match_host_plaintext_path():
    """The on-device plaintext builders (encode_pertinent_indices /
    encode_pertinent_payloads) must produce EXACTLY the ciphertexts of the
    host-plaintext path (build_index_plaintexts + _encode_chunk_jit) —
    same rng stream, exact modular arithmetic on both sides."""
    from tfhe_omr.core.detector import sample_weights

    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=21)
    detector = skp.generate_detector()
    sender = skp.generate_sender()
    rng = np.random.default_rng(22)
    count = 24
    clues = sender.gen_clues(count, rng)
    pert = detector.detect(clues)
    retriever = skp.generate_retriever(count, 4)
    rp = retriever.params

    # index digest: same bucket stream for both paths
    rng_a = np.random.default_rng(7)
    rng_b = np.random.default_rng(7)
    dev = detector.encode_pertinent_indices(rp, pert, rng_a, chunk=16)
    host = jnp.zeros_like(dev)
    for s in range(0, count, 16):
        c = min(16, count - s)
        plain = detector.build_index_plaintexts(rp, c, rng_b, start_index=s)
        host = detector._encode_chunk_jit(
            pert[s : s + c], jnp.asarray(plain), host
        )
    np.testing.assert_array_equal(np.asarray(dev), np.asarray(host))

    # payload digest
    payloads = random_payloads(rng, count, params.payload_length)
    seed = 12345
    dev_p = detector.encode_pertinent_payloads(
        rp, pert, payloads, seed, chunk=16
    )
    weights = sample_weights(rp, seed)
    w_all = weights.reshape(rp.cmb_cipher_count, rp.cmb_count_per_cipher, -1)
    for k in range(rp.cmb_cipher_count):
        acc = jnp.zeros_like(dev_p[k])
        for s in range(0, count, 16):
            c = min(16, count - s)
            plain = detector.build_payload_plaintexts(
                rp, payloads[s : s + c], w_all[k][:, s : s + c]
            )
            acc = detector._encode_chunk_jit(
                pert[s : s + c], jnp.asarray(plain), acc
            )
        np.testing.assert_array_equal(np.asarray(dev_p[k]), np.asarray(acc))
