"""Prove the FP-rate probe's accept predicate IS the detector's.

Crafts compact clue ciphertexts with CONTROLLED phases (b_i = a.W_i +
delta_i, so clue i decrypts to exactly delta_i), runs them through the
REAL ``Detector.detect`` pipeline (two-level blind rotation + trace), and
compares the decrypted pertinency bit against the analytic criterion used
by benches/fp_rate_probe.py:

    accept(delta) == all_i round_half_up(delta_i * t / q0) mod t == 0
                  == all_i delta_i in [0, q0/2t) U [q0 - q0/2t, q0)

Sweeps ALL q0 = 2048 phase values at clue position 0 and the window
boundaries at every position, with noise-free keys so the decision is
exactly deterministic (the LUT window map v -> LUT1[v] is key- and
noise-independent; ``detector.rs:457-503``). Zero mismatches means the
rate probe measures exactly the detector's acceptance event.

Writes artifacts/fp_criterion.json (git-ignored).

Usage: python benches/fp_criterion_probe.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from benches.fp_rate_probe import extraction_weights


def main():
    import jax

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.core.sender import ClueBatch

    params = OmrParameters.default(noise_free=True)
    cp = params.clue_params
    q0, t, c = cp.cipher_modulus, cp.plain_modulus, params.clue_count
    n = cp.dimension
    half_win = q0 // (2 * t)  # 128

    t0 = time.perf_counter()
    skp = SecretKeyPack(params, rng=11)
    detector = skp.generate_detector()
    w = extraction_weights(skp)
    print(json.dumps({"keygen_s": round(time.perf_counter() - t0, 1)}),
          flush=True)

    # message list: (position, delta) cases
    cases = [(0, v) for v in range(q0)]
    boundary = [0, half_win - 1, half_win, half_win + 1,
                q0 - half_win - 1, q0 - half_win, q0 - 1]
    for pos in range(1, c):
        cases += [(pos, v) for v in boundary]
    total = len(cases)
    batch = 1024
    pad = (-total) % batch
    cases += [(0, 0)] * pad

    rng = np.random.default_rng(13)
    a = rng.integers(0, q0, size=(len(cases), n), dtype=np.int64)
    base = np.mod(a @ w, q0)  # (M, c): b values giving phase 0 everywhere
    b7 = base.copy()
    for m, (pos, v) in enumerate(cases):
        b7[m, pos] = (base[m, pos] + v) % q0

    accepts = np.zeros(len(cases), dtype=bool)
    t0 = time.perf_counter()
    for s in range(0, len(cases), batch):
        out = detector.detect(ClueBatch(a[s:s + batch], b7[s:s + batch]))
        dec = skp.decrypt_rlwe2_ntt(out)
        q2 = params.q2
        tp = params.output_plain_modulus
        decoded = np.mod((dec * (2 * tp) + q2) // (2 * q2), tp)
        assert not decoded[:, 1:].any()  # trace kills non-constant slots
        accepts[s:s + batch] = decoded[:, 0] == 1
        print(json.dumps({"done": min(s + batch, total)}), flush=True)
    wall = time.perf_counter() - t0

    mismatches = []
    for m in range(total):
        pos, v = cases[m]
        predicted = v < half_win or v >= q0 - half_win
        if bool(accepts[m]) != predicted:
            mismatches.append({"position": pos, "delta": int(v),
                               "detector": bool(accepts[m]),
                               "criterion": predicted})
    result = {
        "cases": total,
        "full_sweep_position0": q0,
        "boundary_positions": list(range(1, c)),
        "accept_window": [0, half_win - 1, q0 - half_win, q0 - 1],
        "mismatches": mismatches,
        "mismatch_count": len(mismatches),
        "detect_wall_s": round(wall, 1),
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(result), flush=True)
    out_p = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "artifacts", "fp_criterion.json",
    )
    os.makedirs(os.path.dirname(out_p), exist_ok=True)
    with open(out_p, "w") as fh:
        json.dump(result, fh, indent=1)
    print(f"wrote {out_p}", flush=True)


if __name__ == "__main__":
    main()
