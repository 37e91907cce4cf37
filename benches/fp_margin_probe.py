"""Intermediate-LWE noise margin vs the detection false-positive design.

The protocol's designed per-message false-positive rate is 8^-7 ≈ 4.8e-7
(all 7 uniform clue values landing in LUT1's accept chunk — reference
``detector.rs:479-503``, SURVEY.md §3.3). A FRAMEWORK defect would show up
as an elevated rate via the only other mechanism: intermediate noise
pushing a slot-sum of 13 across the Δ/2 = 64 boundary of the q=4096
second-level input (sum chunk 13 -> 14).

This probe decrypts the stage-1 output (the mod-switched LWE under
``inter_sk``) for B pertinent and B non-pertinent clues and reports:

* the residual sigma around the nearest 128-quantum chunk center — the
  margin is 64/sigma; measured 11.8 -> 5.4 sigma, P(cross) ~ 3e-8/msg,
  times P(sum=13) ≈ 2e-5 -> noise-driven FP ~ 6e-13/msg, negligible;
* chunk placement: pertinent messages must ALL land in chunk 14
  (2 * clue_count); non-pertinent sums distribute around 7.

Run: python benches/fp_margin_probe.py
(an earlier record: pertinent 1024/1024 in chunk 14, sigma 11.8,
max |residual| 49 of 64; non-pertinent sigma 11.1. The noise is a property
of the keys and parameters, not of the device.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(batch: int = 1024):
    import jax.numpy as jnp

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters

    params = OmrParameters.default()
    skp = SecretKeyPack(params, rng=0)
    skp2 = SecretKeyPack(params, rng=1)
    det = skp.generate_detector()
    rng = np.random.default_rng(2)
    own = skp.generate_sender().gen_clues(batch, rng)
    other = skp2.generate_sender().gen_clues(batch, rng)

    key, tbl = det.key, det.tables
    q_inter = params.intermediate_lwe.cipher_modulus
    delta = q_inter // params.intermediate_lwe.plain_modulus
    s = np.asarray(skp.inter_sk, dtype=np.int64)
    target = 2 * params.clue_count  # 14

    ok = True
    for name, cl in (("pertinent", own), ("non-pertinent", other)):
        ms_a, ms_b = det._stage1_jit(
            jnp.asarray(cl.a), jnp.asarray(cl.b7),
            key.bsk1, key.bsk1_sh, key.ksk_limbs, tbl,
        )
        m = np.mod(np.asarray(ms_b) - np.asarray(ms_a) @ s, q_inter)
        k = np.round(m / delta).astype(np.int64) % (q_inter // delta)
        resid = m - np.round(m / delta) * delta
        sigma = float(resid.std())
        print(
            f"{name}: sigma={sigma:.2f} margin={delta // 2}"
            f" ({delta / 2 / sigma:.2f} sigma)"
            f" max|resid|={int(np.abs(resid).max())}"
        )
        if name == "pertinent":
            in14 = int((k == target).sum())
            print(f"  chunk {target}: {in14}/{batch}")
            ok &= in14 == batch
        else:
            vals, cnts = np.unique(k, return_counts=True)
            print("  sum distribution:",
                  {int(v): int(c) for v, c in zip(vals, cnts)})
            ok &= not (k == target).any() or batch > 10**5
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
