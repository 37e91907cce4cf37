"""Golden regression vectors: bit-exact pins for every ciphertext-math layer.

The reference workspace has no committed test vectors (its only oracle is the
noise-tolerant omd example, ``omr_core/examples/omd.rs``), and this
framework's gadget-decomposition convention is self-defined (primus-fhe's
``NonPowOf2ApproxSignedBasis`` is not vendored — see ops/decompose.py and
README "Decomposition convention"). These fixtures pin the EXACT bits of
every layer so any kernel refactor that silently changes ciphertext values
fails CI instead of only (maybe) shifting the omd noise margin:

  * modular mul in both fields (q1 = 2^27-2047, q2 = 2^50-16383)
  * signed gadget digits (L1 B=2^5 d=4, L2 B=2^7 d=6, trace B=2^2 exact)
  * negacyclic NTT/INTT outputs, both rings (N1=1024, N2=2048)
  * one paired (BMMP) CMUX step, both levels
  * the LWE key switch and the homomorphic trace
  * a full detect ciphertext + index/payload digests at the tiny preset
    (seeded, noise-free) — the whole-protocol pin

All inputs are regenerated from fixed seeds; only outputs are stored in
``tests/golden/golden_vectors.npz``. Regenerate (ONLY when a change is a
deliberate, reviewed break of ciphertext compatibility) with:

    python -m tests.test_golden --regenerate
"""

import os

import numpy as np
import pytest

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden", "golden_vectors.npz"
)

SEED = 20250817


def compute_vectors():
    """Recompute every pinned output from fixed seeds on the default device
    (the CPU here; chip_smoke.py runs it on the GPU). Each layer runs as one
    jitted program (integer arithmetic: jit changes no bit, and spares a
    GPU one compile per eager op)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from tfhe_omr.core.context import OmrContext
    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.core.sender import ClueBatch
    from tfhe_omr.ops.bootstrap import (
        make_blind_rotate,
        make_lwe_keyswitch,
        make_trace,
    )

    params = OmrParameters.default()
    ctx = OmrContext(params)
    f1, f2 = ctx.f1, ctx.f2
    ntt1, ntt2 = ctx.ntt1, ctx.ntt2
    rng = np.random.default_rng(SEED)
    out = {}

    # ---- 1. field multiplication spot vectors
    for name, f in (("q1", f1), ("q2", f2)):
        a = rng.integers(0, f.q, size=256, dtype=np.int64)
        b = rng.integers(0, f.q, size=256, dtype=np.int64)
        out[f"mul_{name}"] = np.asarray(
            jax.jit(f.mul)(jnp.asarray(a), jnp.asarray(b))
        )

    # ---- 2. signed gadget digits (the convention the BSKs are built with)
    for name, g in (
        ("g1", ctx.gadget_br1),
        ("g2", ctx.gadget_br2),
        ("gtr", ctx.gadget_trace),
    ):
        x = rng.integers(0, g.field.q, size=256, dtype=np.int64)
        out[f"dig_{name}"] = np.asarray(
            jax.jit(partial(g.decompose, axis=0))(jnp.asarray(x))
        )

    # ---- 3. negacyclic NTT / INTT, both rings
    for name, ntt, f in (("ntt1", ntt1, f1), ("ntt2", ntt2, f2)):
        x = rng.integers(0, f.q, size=(ntt.n, 2), dtype=np.int64)
        xj = jnp.asarray(x)
        out[f"{name}_fwd"] = np.asarray(jax.jit(ntt.fwd)(xj))
        out[f"{name}_inv"] = np.asarray(jax.jit(ntt.inv)(xj))

    # ---- 4. one paired CMUX step per level (synthetic seeded RGSW rows)
    for name, f, ntt, g in (
        ("cmux1", f1, ntt1, ctx.gadget_br1),
        ("cmux2", f2, ntt2, ctx.gadget_br2),
    ):
        br = jax.jit(make_blind_rotate(f, ntt, g, paired=True))
        n = ntt.n
        acc = rng.integers(0, f.q, size=(n, 2, 4), dtype=np.int64)
        amounts = rng.integers(0, 2 * n, size=(2, 4), dtype=np.int64)
        bsk = rng.integers(0, f.q, size=(3, n, g.d, 2, 2), dtype=np.int64)
        out[name] = np.asarray(
            br(
                jnp.asarray(acc),
                jnp.asarray(amounts),
                jnp.asarray(bsk),
                jnp.asarray(f.shoup(bsk)),
            )
        )

    # ---- 5. LWE key switch (synthetic int8 limb planes)
    ksp = params.first_level_ks
    ks = jax.jit(make_lwe_keyswitch(f1, ksp.digits, ksp.out_dimension))
    limbs = -(-f1.bits // 7)
    ksk = rng.integers(
        0, 128,
        size=(limbs, params.n1 * ksp.digits, ksp.out_dimension + 1),
        dtype=np.int8,
    )
    a_vec = rng.integers(0, f1.q, size=(4, params.n1), dtype=np.int64)
    b = rng.integers(0, f1.q, size=(4,), dtype=np.int64)
    ks_a, ks_b = ks(jnp.asarray(a_vec), jnp.asarray(b), jnp.asarray(ksk))
    out["ks_a"] = np.asarray(ks_a)
    out["ks_b"] = np.asarray(ks_b)

    # ---- 6. homomorphic trace (synthetic seeded trace key)
    trace = jax.jit(make_trace(f2, ntt2, ctx.gadget_trace, ctx.trace_autos))
    rounds = len(ctx.trace_autos)
    tk = rng.integers(
        0, f2.q, size=(rounds, params.n2, ctx.gadget_trace.d, 2),
        dtype=np.int64,
    )
    acc2 = rng.integers(0, f2.q, size=(params.n2, 2, 4), dtype=np.int64)
    out["trace"] = np.asarray(
        trace(jnp.asarray(acc2), jnp.asarray(tk), jnp.asarray(f2.shoup(tk)))
    )

    # ---- 7. full protocol at the tiny preset (seeded, noise-free)
    tparams = OmrParameters.tiny(noise_free=True)
    skp = SecretKeyPack(tparams, rng=SEED)
    skp2 = SecretKeyPack(tparams, rng=SEED + 1)
    crng = np.random.default_rng(SEED + 2)
    sender, sender2 = skp.generate_sender(), skp2.generate_sender()
    detector = skp.generate_detector()
    batch = ClueBatch.concat(
        [sender.gen_clues(2, crng), sender2.gen_clues(2, crng)]
    )
    pert = detector.detect(batch)
    out["detect_tiny"] = np.asarray(pert)
    rp = skp.generate_retriever(4, 2).params
    out["digest_idx_tiny"] = np.asarray(
        detector.encode_pertinent_indices(
            rp, pert, np.random.default_rng(SEED + 3)
        )
    )
    from tfhe_omr.core.payload import random_payloads

    payloads = random_payloads(
        np.random.default_rng(SEED + 4), 4, rp.payload_length
    )
    out["digest_pay_tiny"] = np.asarray(
        detector.encode_pertinent_payloads(rp, pert, payloads, SEED + 5)
    )
    return out


def test_golden_vectors():
    if not os.path.exists(GOLDEN_PATH):
        pytest.fail(
            "tests/golden/golden_vectors.npz missing — run "
            "`python -m tests.test_golden --regenerate` and commit it"
        )
    golden = np.load(GOLDEN_PATH)
    got = compute_vectors()
    assert set(golden.files) == set(got), (
        sorted(golden.files), sorted(got)
    )
    for k in golden.files:
        assert np.array_equal(golden[k], got[k]), (
            f"golden vector {k!r} changed: "
            f"{int((golden[k] != got[k]).sum())} of {golden[k].size} "
            "elements differ — a ciphertext-math change; if deliberate, "
            "regenerate and document it"
        )


if __name__ == "__main__":
    import sys

    # vectors are defined on the CPU backend (the suite's conftest forces
    # it too); chip_smoke.py checks that the GPU reproduces them exactly
    import jax

    jax.config.update("jax_platforms", "cpu")

    if "--regenerate" in sys.argv:
        os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
        vecs = compute_vectors()
        np.savez_compressed(GOLDEN_PATH, **vecs)
        total = sum(v.nbytes for v in vecs.values())
        print(
            f"wrote {GOLDEN_PATH}: {len(vecs)} arrays, "
            f"{total / 1024:.0f} KiB raw, "
            f"{os.path.getsize(GOLDEN_PATH) / 1024:.0f} KiB compressed"
        )
    else:
        print(__doc__)
