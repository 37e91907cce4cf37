"""Timing sweep of compress/combine/retrieve only (detect done once, outside).

Counterpart of reference ``omr_core/examples/omr_time_analyze2.rs``: the
pertinency vector is computed once outside the sweep so only digest encoding
and retrieval are timed (``omr_time_analyze2.rs:81-117``); writes
``benchmark_compress_and_retrieve.csv``.

Usage: python examples/omr_time_analyze2.py [--tiny] [--cpu] [--max-d 256]
"""

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

log = logging.getLogger("omr_time_analyze2")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--max-d", type=int, default=256)
    ap.add_argument("--out", type=str, default="benchmark_compress_and_retrieve.csv")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

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

    # detect once at max D; sweeps reuse prefixes of the pertinency vector
    d_max = args.max_d
    pertinent_count_max = min(d_max, 8 if args.tiny else 50)
    pertinent = np.zeros(d_max, dtype=bool)
    pertinent[:pertinent_count_max] = True
    rng.shuffle(pertinent)
    own = sender.gen_clues(int(pertinent.sum()), rng)
    other = sender2.gen_clues(int((~pertinent).sum()), rng)
    a = np.zeros((d_max, own.a.shape[1]), dtype=np.int64)
    b7 = np.zeros((d_max, own.b7.shape[1]), dtype=np.int64)
    a[pertinent], b7[pertinent] = own.a, own.b7
    if (~pertinent).any():
        a[~pertinent], b7[~pertinent] = other.a, other.b7
    payloads_all = random_payloads(rng, d_max, params.payload_length)
    log.info("detecting %d messages once (outside the sweep)...", d_max)
    pv_all = detector.detect(ClueBatch(a, b7))
    jax.block_until_ready(pv_all)

    records = []
    d = 1
    while d <= d_max:
        pert_d = pertinent[:d]
        k = int(pert_d.sum())
        if k == 0:
            d *= 2
            continue
        rec = TimingRecord(device_count=n_dev, payload_count=d)
        retriever = skp.generate_retriever(d, k)
        rp = retriever.params
        pv = pv_all[:d]
        payloads = payloads_all[:d]
        true_indices = sorted(np.nonzero(pert_d)[0].tolist())

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
            rec.encode_indices_time + rec.encode_payloads_time + rec.decode_time
        )
        log.info("D=%d: encode %.3fs+%.3fs decode %.3fs", d,
                 rec.encode_indices_time, rec.encode_payloads_time,
                 rec.decode_time)
        records.append(rec)
        d *= 2

    write_csv(args.out, records)
    log.info("wrote %s (%d records)", args.out, len(records))


if __name__ == "__main__":
    main()
