"""Aux subsystems: timers, CSV records, size accounting, noise telemetry."""

import csv
import os

import numpy as np

from tfhe_omr.utils.timing import StageTimer, TimingRecord, write_csv


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        x = sum(range(1000))
    assert "a" in t.stages and t.stages["a"] >= 0
    out = t.time("b", lambda: np.arange(10))
    assert out.shape == (10,) and "b" in t.stages


def test_write_csv(tmp_path):
    path = os.path.join(tmp_path, "bench.csv")
    write_csv(path, [TimingRecord(device_count=1, payload_count=4,
                                  detect_time=1.5)])
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    assert rows[0]["payload_count"] == "4"
    assert float(rows[0]["detect_time"]) == 1.5


def test_key_size_accounting(tiny_skp):
    det = tiny_skp.generate_detector()
    size = det.detect_key_size()
    assert size > 0
    # dtype-aware: must equal the sum of nbytes of every shipped array
    expect = sum(
        a.size * a.dtype.itemsize for a in det.key if a is not None
    )
    assert size == expect
    sender = tiny_skp.generate_sender()
    assert sender.clue_key_size() > 0


def test_payload_ring_ops(rng):
    """Payload add/sub/mul_scalar mod p (reference payload.rs:53-103)."""
    from tfhe_omr.core.payload import (
        payload_add,
        payload_mul_scalar,
        payload_sub,
        random_payloads,
    )

    p = 257
    a = random_payloads(rng, 4)
    b = random_payloads(rng, 4)
    s = int(rng.integers(0, p))
    assert np.array_equal(payload_add(a, b, p), (a + b) % p)
    assert np.array_equal(payload_sub(a, b, p), (a - b) % p)
    assert np.array_equal(payload_mul_scalar(a, s, p), (a * s) % p)
    # add then sub round-trips
    assert np.array_equal(payload_sub(payload_add(a, b, p), b, p), a % p)
    # per-message scalar broadcast (the digest-weight shape)
    w = rng.integers(0, p, size=(4, 1))
    assert np.array_equal(payload_mul_scalar(a, w, p), (a * w) % p)


def test_noise_sigma_info(tiny_skp, rng):
    """NoiseSigmaInfo counterpart: decoded-noise stats from payload cts."""
    import jax.numpy as jnp

    skp = tiny_skp
    params = skp.params
    q = params.q2
    p = params.output_plain_modulus
    delta = (2 * q + p) // (2 * p)
    retr = skp.generate_retriever(8, 2)
    # craft noise-free ciphertexts encrypting delta*v and check stats
    n2 = params.n2
    vals = rng.integers(0, p, size=(1, n2), dtype=np.int64)
    from tests.helpers import rlwe_encrypt_coeff

    mu = np.mod(vals[0] * delta, q)
    a, b = rlwe_encrypt_coeff(skp.ctx, 2, skp.z2_ntt, mu, rng)
    ct = jnp.stack(
        [skp.ctx.ntt2.fwd_last(jnp.asarray(a)[None]),
         skp.ctx.ntt2.fwd_last(jnp.asarray(b)[None])], axis=1
    )  # (1, 2, N)
    info = retr.noise_sigma_info(ct, expected_sigma=100.0)
    assert info["observed_sigma"] < 260  # rounding of delta only
    assert 0.0 <= info["sigma_hist"][6] <= 1.0
