"""Generate the pipeline-level interchange fixtures:

* ``docs/interchange/transcript.json`` — a FULL noise-free single-message
  detect transcript: every intermediate of reference
  ``detector.rs:505-639`` (extraction, per-clue L1 blind rotation, sum,
  sample extraction, key switch, modulus switch, L2 blind rotation,
  N2^-1 + trace, NTT-domain output) plus one index-digest ciphertext and
  its decode, together with the seeded secrets that generated them.
* ``docs/interchange/key_switch.json`` — standalone LWE key-switch
  pin (reference ``detector.rs:560-563``): random input ciphertexts under
  z1-as-LWE and their switched outputs under s2. With sigma = 0 and the
  exact binary basis (log_basis = 1, 27 digits >= ceil(log q1)) the phase
  b - a.s is preserved EXACTLY, which is the cross-implementation
  invariant (ciphertext bytes depend on each library's key-mask sampling
  and cannot match).

Everything uses ``OmrParameters.default(noise_free=True)``: same
dimensions/moduli/gadgets as the reference set, all sigmas 0, seeded — so
a Rust-side verifier can inject the recorded secrets into primus-fhe
types and replay each arrow. ``tests/test_interchange.py`` verifies every
recorded step by independent big-int math.

The tool cross-checks itself: the re-derived stage outputs must be
bit-identical to ``Detector._stage*_jit`` / ``Detector.detect`` — the
transcript records the REAL pipeline, not a parallel reimplementation.

Usage: python tools/make_transcript_fixture.py   (~2-6 min on CPU)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs", "interchange",
)

SEED = 20260821


def ints(a):
    return [int(v) for v in np.asarray(a).ravel()]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.ops.bootstrap import (
        extract_constant_lwe,
        init_accumulator,
        lwe_modulus_switch,
        make_blind_rotate,
        make_lwe_keyswitch,
        make_trace,
    )

    os.makedirs(OUT, exist_ok=True)
    params = OmrParameters.default(noise_free=True)
    skp = SecretKeyPack(params, rng=SEED)
    sender = skp.generate_sender()
    detector = skp.generate_detector()
    key = detector.key
    ctx = skp.ctx
    f1, f2 = ctx.f1, ctx.f2
    p = params
    n0, c, q0 = p.clue_params.dimension, p.clue_count, \
        p.clue_params.cipher_modulus
    q_i = p.intermediate_lwe.cipher_modulus
    t_i = p.intermediate_lwe.plain_modulus

    clue = sender.gen_clues(1, np.random.default_rng(SEED + 1))
    a_row = np.asarray(clue.a[0], dtype=np.int64)
    b7_row = np.asarray(clue.b7[0], dtype=np.int64)

    # -- extraction (``extract_all``, detector.rs:505-531; the mod switch
    # to 2N1 at :521 is a no-op at these parameters)
    idx, neg = ctx.clue_extract_tables
    a_ext = np.mod(np.where(neg == 1, -a_row[idx], a_row[idx]), q0)

    # -- per-clue L1 blind rotation (detector.rs:533-557), XLA ops path
    # (bit-equal to the fused kernels, tests/test_fused_cmux.py)
    br1 = make_blind_rotate(f1, ctx.ntt1, ctx.gadget_br1, paired=True)
    acc0 = init_accumulator(
        f1, jnp.asarray(ctx.lut1_ext), jnp.asarray(b7_row), p.n1
    )
    acc = br1(acc0, jnp.asarray(a_ext.T), key.bsk1, key.bsk1_sh)  # (N,2,c)
    acc_np = np.asarray(acc)
    acc_sum = f1.mod_sum(acc.reshape(p.n1, 2, 1, c), axis=3)  # (N,2,1)

    # -- sample extraction + key switch + mod switch (detector.rs:560-594)
    a_vec, b0 = extract_constant_lwe(f1, acc_sum)
    ks = make_lwe_keyswitch(
        f1, p.first_level_ks.digits, p.first_level_ks.out_dimension
    )
    ks_a, ks_b = ks(a_vec.T, b0, key.ksk_limbs)
    ms_a = lwe_modulus_switch(f1, ks_a, q_i)
    ms_b = lwe_modulus_switch(f1, ks_b, q_i)
    ms_b = (ms_b + c * (q_i // t_i)) & (q_i - 1)

    # cross-check: identical to the shipped stage-1 program
    s1a, s1b = detector._stage1_jit(
        jnp.asarray(clue.a), jnp.asarray(clue.b7), key.bsk1, key.bsk1_sh,
        key.ksk_limbs, detector.tables,
    )
    np.testing.assert_array_equal(np.asarray(ms_a), np.asarray(s1a))
    np.testing.assert_array_equal(np.asarray(ms_b), np.asarray(s1b))

    # -- L2 blind rotation (detector.rs:599-624)
    acc2 = detector._stage2_jit(
        ms_a, ms_b, key.bsk2, key.bsk2_sh, detector.tables
    )  # (N2, 2, 1)

    # -- N2^-1 + trace (detector.rs:626-639), coefficient domain
    n2_inv = f2.inv(p.n2)
    acc2s = f2.mul_shoup(
        acc2, np.int64(n2_inv), np.int64(int(f2.shoup(n2_inv)))
    )
    trace_fn = make_trace(f2, ctx.ntt2, ctx.gadget_trace, ctx.trace_autos)
    tr = trace_fn(acc2s, key.trace_k, key.trace_k_sh)

    out = detector._stage3_jit(acc2, key.trace_k, key.trace_k_sh)  # (1, 2, N2) NTT domain
    np.testing.assert_array_equal(
        np.asarray(ctx.ntt2.fwd(tr).transpose(2, 1, 0)), np.asarray(out)
    )
    full = detector.detect(clue)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(out))

    # -- one index-digest ciphertext + decode (detector.rs:223-339 /
    # retriever.rs:63-130) at the production D=65536 layout
    retr = skp.generate_retriever(65536, 50)
    rp = retr.params
    rng_d = np.random.default_rng(SEED + 2)
    buckets = np.random.default_rng(SEED + 2).integers(
        0, rp.bucket_count_per_segment, size=(1, rp.segment_per_cipher),
        dtype=np.int64,
    )
    idx_ct = detector.encode_pertinent_indices(rp, full, rng_d)
    retr.decode_pertinent_indices(np.asarray(idx_ct))
    decoded = sorted(retr.pertinent_indices_set)
    assert decoded == [0], decoded
    # cross-check: the RECORDED buckets must reproduce the recorded ct
    # exactly (guards the twin-rng assumption against any future change
    # in the encoder's draw order/shape/dtype)
    expect_plain = np.zeros((1, p.n2), dtype=np.int64)
    for s in range(rp.segment_per_cipher):
        base = s * rp.slots_per_segment + int(buckets[0, s]) * \
            rp.slots_per_bucket
        expect_plain[0, base + rp.index_slots_per_bucket] = 1  # flag
    recheck = detector._encode_chunk_jit(
        full, jnp.asarray(expect_plain),
        jnp.zeros((2, p.n2), dtype=jnp.int64),
    )
    np.testing.assert_array_equal(np.asarray(recheck), np.asarray(idx_ct))

    transcript = {
        "params": "OmrParameters.default(noise_free=True)",
        "seed": SEED,
        "secrets": {
            "clue_sk": ints(skp.clue_sk),
            "z1": ints(skp.z1),          # signed ternary
            "s2": ints(skp.inter_sk),
            "z2": ints(skp.z2),
        },
        "clue": {"a": ints(a_row), "b7": ints(b7_row), "q0": q0},
        "extracted": {"a_ext": [ints(a_ext[i]) for i in range(c)]},
        "l1_acc_per_clue": [
            {"a": ints(acc_np[:, 0, i]), "b": ints(acc_np[:, 1, i])}
            for i in range(c)
        ],
        "l1_sum": {
            "a": ints(np.asarray(acc_sum)[:, 0, 0]),
            "b": ints(np.asarray(acc_sum)[:, 1, 0]),
        },
        "extracted_lwe": {
            "a": ints(np.asarray(a_vec)[:, 0]),
            "b": int(np.asarray(b0)[0]),
        },
        "key_switched": {
            "a": ints(np.asarray(ks_a)[0]), "b": int(np.asarray(ks_b)[0]),
        },
        "mod_switched": {
            "a": ints(np.asarray(ms_a)[0]), "b": int(np.asarray(ms_b)[0]),
            "q": q_i,
            "b_offset": c * (q_i // t_i),
        },
        "l2_acc": {
            "a": ints(np.asarray(acc2)[:, 0, 0]),
            "b": ints(np.asarray(acc2)[:, 1, 0]),
        },
        "trace_out": {
            "a": ints(np.asarray(tr)[:, 0, 0]),
            "b": ints(np.asarray(tr)[:, 1, 0]),
        },
        "ntt_out": {
            "a": ints(np.asarray(out)[0, 0]), "b": ints(np.asarray(out)[0, 1]),
        },
        "digest": {
            "layout": {
                "slots_per_segment": rp.slots_per_segment,
                "slots_per_bucket": rp.slots_per_bucket,
                "index_slots_per_bucket": rp.index_slots_per_bucket,
                "bucket_count_per_segment": rp.bucket_count_per_segment,
                "segment_per_cipher": rp.segment_per_cipher,
            },
            "buckets": ints(buckets),
            "index_ct": {
                "a": ints(np.asarray(idx_ct)[0]),
                "b": ints(np.asarray(idx_ct)[1]),
            },
            "decoded_indices": decoded,
        },
    }
    with open(os.path.join(OUT, "transcript.json"), "w") as fp:
        json.dump(transcript, fp)

    # ---- standalone key-switch fixture ---------------------------------
    rng_k = np.random.default_rng(SEED + 3)
    kn = 4
    a_in = rng_k.integers(0, f1.q, size=(kn, p.n1), dtype=np.int64)
    b_in = rng_k.integers(0, f1.q, size=(kn,), dtype=np.int64)
    ko_a, ko_b = ks(jnp.asarray(a_in), jnp.asarray(b_in), key.ksk_limbs)
    ks_fix = {
        "params": "OmrParameters.default(noise_free=True)",
        "seed": SEED,
        "q": int(f1.q),
        "n_in": p.n1,
        "n_out": p.first_level_ks.out_dimension,
        "digits": p.first_level_ks.digits,
        "secrets": {"z1": ints(skp.z1), "s2": ints(skp.inter_sk)},
        "inputs": [
            {"a": ints(a_in[i]), "b": int(b_in[i])} for i in range(kn)
        ],
        "outputs": [
            {"a": ints(np.asarray(ko_a)[i]), "b": int(np.asarray(ko_b)[i])}
            for i in range(kn)
        ],
        "invariant": (
            "b_out - a_out . s2 == b_in - a_in . z1 (mod q), exactly "
            "(sigma = 0, exact binary basis)"
        ),
    }
    with open(os.path.join(OUT, "key_switch.json"), "w") as fp:
        json.dump(ks_fix, fp)

    sizes = {
        f: os.path.getsize(os.path.join(OUT, f))
        for f in ("transcript.json", "key_switch.json")
    }
    print(json.dumps({"written": sizes}))


if __name__ == "__main__":
    main()
