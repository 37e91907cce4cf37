"""Timing sweep over payload counts -> benchmark.csv.

Counterpart of reference ``omr_core/examples/omr_time_analyze.rs``: sweeps
D in powers of two, records per-stage times in a CSV with the same schema
(device count replaces thread count), and asserts decode correctness at each
point (``omr_time_analyze.rs:215-235``).

Usage: python examples/omr_time_analyze.py [--tiny] [--cpu] [--max-d 256]
"""

import argparse
import logging
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

log = logging.getLogger("omr_time_analyze")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--max-d", type=int, default=256)
    ap.add_argument("--out", type=str, default="benchmark.csv")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.core.payload import random_payloads
    from tfhe_omr.core.sender import ClueBatch
    from tfhe_omr.utils.timing import TimingRecord, write_csv

    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    n_dev = len(jax.devices())

    skp = SecretKeyPack(params, rng=np.random.default_rng())
    skp2 = SecretKeyPack(params, rng=np.random.default_rng())
    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()
    rng = np.random.default_rng()

    records = []
    d = 1
    while d <= args.max_d:
        rec = TimingRecord(device_count=n_dev, payload_count=d)
        pertinent_count = min(d, 8 if args.tiny else 50)
        pertinent = np.zeros(d, dtype=bool)
        pertinent[:pertinent_count] = True
        rng.shuffle(pertinent)
        true_indices = sorted(np.nonzero(pertinent)[0].tolist())

        t0 = time.perf_counter()
        own = sender.gen_clues(int(pertinent.sum()), rng)
        other = sender2.gen_clues(int((~pertinent).sum()), rng)
        a = np.zeros((d, own.a.shape[1]), dtype=np.int64)
        b7 = np.zeros((d, own.b7.shape[1]), dtype=np.int64)
        a[pertinent], b7[pertinent] = own.a, own.b7
        if (~pertinent).any():
            a[~pertinent], b7[~pertinent] = other.a, other.b7
        rec.gen_clues_time = time.perf_counter() - t0

        t0 = time.perf_counter()
        payloads = random_payloads(rng, d, params.payload_length)
        rec.gen_payloads_time = time.perf_counter() - t0

        t0 = time.perf_counter()
        pv = detector.detect(ClueBatch(a, b7))
        jax.block_until_ready(pv)
        rec.detect_time = time.perf_counter() - t0
        rec.detect_time_per_message = rec.detect_time / d

        retriever = skp.generate_retriever(d, pertinent_count)
        rp = retriever.params

        t0 = time.perf_counter()
        index_cts = [
            detector.encode_pertinent_indices(rp, pv, rng)
            for _ in range(rp.max_encode_indices_cipher_count)
        ]
        rec.encode_indices_time = time.perf_counter() - t0

        seed = int(rng.integers(0, 2**63))
        t0 = time.perf_counter()
        payload_cts = detector.encode_pertinent_payloads(rp, pv, payloads, seed)
        jax.block_until_ready(payload_cts)
        rec.encode_payloads_time = time.perf_counter() - t0

        t0 = time.perf_counter()
        indices, solved = retriever.decode_digest(index_cts, payload_cts, seed)
        rec.decode_time = time.perf_counter() - t0

        assert indices == true_indices, (d, indices, true_indices)
        assert np.array_equal(solved, payloads[indices]), d

        rec.total_time = (
            rec.gen_clues_time + rec.detect_time + rec.encode_indices_time
            + rec.encode_payloads_time + rec.decode_time
        )
        log.info(
            "D=%d: detect %.3fs (%.2f ms/msg) encode %.3fs+%.3fs decode %.3fs",
            d, rec.detect_time, 1e3 * rec.detect_time_per_message,
            rec.encode_indices_time, rec.encode_payloads_time, rec.decode_time,
        )
        records.append(rec)
        d *= 2

    write_csv(args.out, records)
    log.info("wrote %s (%d records)", args.out, len(records))


if __name__ == "__main__":
    main()
