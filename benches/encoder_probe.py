"""Decompose the digest-encoder wall time into its phases.

This probe times each phase of the encoder calls separately on the device,
repeated, so a difference between the benchmark's encoder time and the
end-to-end run's gets a cause instead of two competing headlines.

Usage: python benches/encoder_probe.py [--d 65536] [--reps 3]
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
    ap.add_argument("--d", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters

    params = OmrParameters.default()
    skp = SecretKeyPack(params, rng=0)
    detector = skp.generate_detector()
    rp = skp.generate_retriever(args.d, 50).params
    n2 = rp.polynomial_size
    q2 = skp.ctx.f2.q

    hi = jax.random.randint(
        jax.random.PRNGKey(0), (args.d, 2, n2), 0, 1 << 31, dtype=jnp.int64
    )
    pert = jax.block_until_ready(hi % q2)
    rng = np.random.default_rng(7)
    payloads = rng.integers(
        0, 256, size=(args.d, rp.payload_length)
    )  # int64, as bench.py makes them


    def stamp(label, fn, reps=args.reps):
        out = fn()  # warm (load + compile leftovers)
        jax.block_until_ready(out)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:8])
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:8])
            ts.append(time.perf_counter() - t0)
        print(
            json.dumps({"phase": label, "s": [round(t, 3) for t in ts]}),
            flush=True,
        )
        return out

    # ---- index encoder, single call
    stamp("idx_1ct", lambda: detector.encode_pertinent_indices(rp, pert, rng))

    # ---- index encoder, 5 back-to-back dispatches, one sync (e2e shape)
    def idx5():
        return [
            detector.encode_pertinent_indices(rp, pert, rng) for _ in range(5)
        ]

    stamp("idx_5ct_stream", idx5, reps=2)

    # ---- payload encoder phases
    from tfhe_omr.core.detector import sample_weights

    def pay_host_prep():
        w = sample_weights(rp, 9)
        p16 = np.asarray(payloads, dtype=np.int16)
        return w, p16

    t0 = time.perf_counter()
    w, p16 = pay_host_prep()
    host_s = time.perf_counter() - t0
    print(json.dumps({"phase": "pay_host_prep", "s": [round(host_s, 3)]}),
          flush=True)

    w_all = w.reshape(rp.cmb_cipher_count, rp.cmb_count_per_cipher, -1)
    t0 = time.perf_counter()
    p16_d = jax.block_until_ready(jnp.asarray(p16))
    w_d = jax.block_until_ready(jnp.asarray(w_all))
    up_s = time.perf_counter() - t0
    print(json.dumps({"phase": "pay_upload", "s": [round(up_s, 3)],
                      "mb": round((p16.nbytes + w_all.nbytes) / 1e6, 1)}),
          flush=True)

    # device-resident-arg scan call (pure compute)
    accs = jnp.zeros((rp.cmb_cipher_count, 2, n2), dtype=jnp.int64)

    def pay_scan():
        return detector._encode_pay_scan_jit(
            pert, p16_d, w_d, accs, rp.payload_length, 2048
        )

    stamp("pay_scan_device_args", pay_scan)

    # the full public call as bench.py times it (host prep + upload + scan)
    stamp(
        "pay_full_call",
        lambda: detector.encode_pertinent_payloads(rp, pert, payloads, 9),
    )


if __name__ == "__main__":
    main()
