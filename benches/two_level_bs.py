"""Per-stage bootstrap micro-benchmarks.

Counterpart of reference ``omr_core/benches/two_level_bs.rs`` (criterion
benches for: first-level blind rotation :47-53, key switch :62-73,
second-level blind rotation :124-130, trace :143-145) and of the tfhe-rs
comparison crate ``omr_core2/benches/two_level_bs.rs`` (the same three
bootstrap shapes measured on a second implementation for the paper's cost
table) — here both roles are served by measuring this framework's own stages.

Prints one JSON object per stage with per-message amortised times.

Usage: python benches/two_level_bs.py [--batch 64] [--tiny] [--cpu] [--reps 3]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench(fn, reps):
    import jax

    out = fn()
    jax.block_until_ready(out)  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.ops.bootstrap import (
        init_accumulator,
        make_blind_rotate,
        make_lwe_keyswitch,
        make_trace,
    )

    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    skp = SecretKeyPack(params, rng=0)
    dk = skp.generate_detection_key()
    ctx = skp.ctx
    rng = np.random.default_rng(1)
    B = args.batch
    results = {}

    # ---- first-level blind rotation (one clue per message)
    n0 = params.clue_params.dimension
    q0 = params.clue_params.cipher_modulus
    a1 = jnp.asarray(rng.integers(0, q0, size=(n0, B), dtype=np.int64))
    b1 = jnp.asarray(rng.integers(0, q0, size=(B,), dtype=np.int64))
    br1 = make_blind_rotate(ctx.f1, ctx.ntt1, ctx.gadget_br1, paired=True)
    lut1 = jnp.asarray(ctx.lut1_ext)

    @jax.jit
    def run_br1(a, b, bsk, bsk_sh):
        acc = init_accumulator(ctx.f1, lut1, b, params.n1)
        return br1(acc, a, bsk, bsk_sh)

    t = bench(lambda: run_br1(a1, b1, dk.bsk1, dk.bsk1_sh), args.reps)
    results["first_level_blind_rotation_ms"] = 1e3 * t / B

    # ---- key switch (1024 -> 670)
    q1 = params.q1
    av = jnp.asarray(rng.integers(0, q1, size=(B, params.n1), dtype=np.int64))
    bv = jnp.asarray(rng.integers(0, q1, size=(B,), dtype=np.int64))
    ks = make_lwe_keyswitch(
        ctx.f1, params.first_level_ks.digits, params.first_level_ks.out_dimension
    )
    ks_j = jax.jit(lambda a, b, k: ks(a, b, k))
    t = bench(lambda: ks_j(av, bv, dk.ksk_limbs), args.reps)
    results["key_switch_ms"] = 1e3 * t / B

    # ---- second-level blind rotation
    n_int = params.intermediate_lwe.dimension
    qi = params.intermediate_lwe.cipher_modulus
    a2 = jnp.asarray(rng.integers(0, qi, size=(n_int, B), dtype=np.int64))
    b2 = jnp.asarray(rng.integers(0, qi, size=(B,), dtype=np.int64))
    br2 = make_blind_rotate(ctx.f2, ctx.ntt2, ctx.gadget_br2, paired=True)
    lut2 = jnp.asarray(ctx.lut2_ext)

    @jax.jit
    def run_br2(a, b, bsk, bsk_sh):
        acc = init_accumulator(ctx.f2, lut2, b, params.n2)
        return br2(acc, a, bsk, bsk_sh)

    t = bench(lambda: run_br2(a2, b2, dk.bsk2, dk.bsk2_sh), args.reps)
    results["second_level_blind_rotation_ms"] = 1e3 * t / B

    # ---- homomorphic trace
    q2 = params.q2
    acc2 = jnp.asarray(
        rng.integers(0, q2, size=(params.n2, 2, B), dtype=np.int64)
    )
    trace = make_trace(ctx.f2, ctx.ntt2, ctx.gadget_trace, ctx.trace_autos)
    trace_j = jax.jit(lambda acc, k, ksh: trace(acc, k, ksh))
    t = bench(lambda: trace_j(acc2, dk.trace_k, dk.trace_k_sh), args.reps)
    results["trace_ms"] = 1e3 * t / B

    results["batch"] = B
    results["device"] = str(jax.devices()[0])
    print(json.dumps(results))


if __name__ == "__main__":
    main()
