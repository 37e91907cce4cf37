"""OMR operation micro-benchmarks.

Counterpart of reference ``omr_core/benches/omr.rs`` (criterion benches:
clue generation :23-25, detect :29-31, encode_pertinent_indices :72-79,
decode_pertinent_indices :83-89). Prints one JSON object.

Usage: python benches/omr_bench.py [--batch 128] [--tiny] [--cpu] [--reps 3]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters

    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    skp = SecretKeyPack(params, rng=0)
    sender = skp.generate_sender()
    detector = skp.generate_detector()
    rng = np.random.default_rng(1)
    B = args.batch
    results = {"batch": B}

    # clue generation
    t0 = time.perf_counter()
    clues = sender.gen_clues(B, rng)
    results["gen_clues_ms"] = 1e3 * (time.perf_counter() - t0) / B

    # detect (warm up compile first)
    out = detector.detect(clues)
    jax.block_until_ready(out)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = detector.detect(clues)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    results["detect_ms"] = 1e3 * min(times) / B
    results["detect_msgs_per_sec"] = B / min(times)

    # stage split
    _, st = detector.detect_with_time_info(clues)
    results["stage_first_level_ms"] = 1e3 * st.first_level_bootstrapping_time / B
    results["stage_second_level_ms"] = (
        1e3 * st.second_level_bootstrapping_time / B
    )
    results["stage_trace_ms"] = 1e3 * st.trace_time / B

    # encode / decode pertinent indices
    pertinent_count = min(B, 8 if args.tiny else 50)
    retr = skp.generate_retriever(B, pertinent_count)
    rp = retr.params
    ct = detector.encode_pertinent_indices(rp, out, rng)  # warm
    jax.block_until_ready(ct)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        ct = detector.encode_pertinent_indices(rp, out, rng)
        jax.block_until_ready(ct)
        times.append(time.perf_counter() - t0)
    results["encode_indices_ms_per_ct"] = 1e3 * min(times)

    times = []
    for _ in range(args.reps):
        retr.pertinent_indices_set.clear()
        t0 = time.perf_counter()
        retr.decode_pertinent_indices(ct)
        times.append(time.perf_counter() - t0)
    results["decode_indices_ms_per_ct"] = 1e3 * min(times)

    results["device"] = str(jax.devices()[0])
    print(json.dumps(results))


if __name__ == "__main__":
    main()
