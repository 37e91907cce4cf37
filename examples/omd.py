"""Oblivious message detection correctness check.

Counterpart of reference ``omr_core/examples/omd.rs``: detect one pertinent
and one non-pertinent clue, decrypt, assert [1,0,...,0] vs all zeros.

Usage: python examples/omd.py [--tiny] [--cpu]
"""

import argparse
import logging
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

log = logging.getLogger("omd")


def omd_check(params, seed=None, batch: int = 2) -> None:
    """Detect one pertinent and one non-pertinent clue under ``params``;
    raise unless they decode to [1, 0, ..., 0] and all zeros. ``batch``
    pads the detect call with zero clues to that many rows, so that it
    runs the programs compiled for a larger batch."""
    import jax

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.sender import ClueBatch

    rng = np.random.default_rng(seed)

    log.debug("generating secret key packs...")
    skp = SecretKeyPack(params, rng=rng)
    skp2 = SecretKeyPack(params, rng=rng)

    log.debug("generating sender and detector...")
    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()

    log.debug("generating clues...")
    clues = sender.gen_clues(1, rng)
    clues2 = sender2.gen_clues(1, rng)

    log.debug("detecting...")
    t0 = time.perf_counter()
    pad = batch - 2
    zeros = ClueBatch(np.zeros((pad, clues.a.shape[1]), np.int64),
                      np.zeros((pad, clues.b7.shape[1]), np.int64))
    result = detector.detect(ClueBatch.concat([clues, clues2, zeros]))
    jax.block_until_ready(result)
    log.debug("detect done in %.2fs (includes compile)", time.perf_counter() - t0)

    dec = skp.decrypt_rlwe2_ntt(result)
    q, t = params.q2, params.output_plain_modulus
    decoded = np.mod((dec * (2 * t) + q) // (2 * q), t)

    if decoded[0, 0] != 1 or decoded[0, 1:].any():
        raise AssertionError(f"pertinent clue decoded to {decoded[0, :8]}")
    if decoded[1].any():
        raise AssertionError(
            f"non-pertinent clue decoded to {decoded[1, :8]} (not zeros)"
        )
    log.info("omd check passed: [1,0,...,0] for pertinent, zeros otherwise")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    logging.basicConfig(level=logging.DEBUG,
                        format="%(asctime)s %(levelname)s %(message)s")

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tfhe_omr.core.params import OmrParameters

    omd_check(OmrParameters.tiny() if args.tiny else OmrParameters.default())


if __name__ == "__main__":
    main()
