"""Generate the Rust-interchange fixture files (docs/interchange/*.json).

The environment this framework was built in has no Rust toolchain and no
network, so bit-exactness against the reference crate
(xiangxiecrypto/tfhe-omr + primus-fhe branch omr2) cannot be verified here.
These fixtures + docs/INTERCHANGE.md turn that check into a ~10-minute task
for anyone with a toolchain: every layer whose convention this framework had
to self-define gets a deterministic input/output pin and a recipe for the
matching primus-fhe call.

Usage: python tools/make_interchange_fixtures.py   (writes docs/interchange/)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs", "interchange",
)

SEED = 20260821


def ints(a):
    return [int(v) for v in np.asarray(a).ravel()]


def main():
    from tfhe_omr.core.context import OmrContext
    from tfhe_omr.core.lut import first_level_lut, second_level_lut
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.ops.bootstrap import lwe_modulus_switch
    from tfhe_omr.ops.decompose import SignedGadget

    import jax.numpy as jnp

    os.makedirs(OUT, exist_ok=True)
    params = OmrParameters.default()
    ctx = OmrContext(params)
    rng = np.random.default_rng(SEED)

    # ---- 1. field + NTT conventions ------------------------------------
    # Our NTT is evaluation at psi^orders[i] (odd exponents of the 2N-th
    # root psi); primus-fhe's table uses its own slot order. The fixture
    # records psi and the exponent per output slot so the Rust check can
    # compare values point-by-point regardless of ordering.
    ntt_fix = {}
    for lvl, (f, ntt) in (("l1", (ctx.f1, ctx.ntt1)), ("l2", (ctx.f2, ctx.ntt2))):
        n = ntt.n
        poly = rng.integers(0, f.q, size=n, dtype=np.int64)
        out = np.asarray(ntt.fwd(jnp.asarray(poly)[:, None]))[:, 0]
        ntt_fix[lvl] = {
            "q": int(f.q),
            "n": n,
            "psi": int(ntt.psi),  # primitive 2N-th root of unity mod q
            "orders": ints(ntt.orders),  # out[i] = poly(psi**orders[i])
            "poly": ints(poly),
            "ntt_out": ints(out),
        }
    with open(os.path.join(OUT, "ntt.json"), "w") as fp:
        json.dump(ntt_fix, fp)

    # ---- 2. gadget decomposition (the self-defined convention) ---------
    gad_fix = {}
    for name, (f, log_b, d) in (
        ("br1", (ctx.f1, params.first_level_br.log_basis,
                 params.first_level_br.basis_len)),
        ("br2", (ctx.f2, params.second_level_br.log_basis,
                 params.second_level_br.basis_len)),
        ("trace", (ctx.f2, params.trace.log_basis,
                   (ctx.f2.bits + params.trace.log_basis - 1)
                   // params.trace.log_basis)),
    ):
        g = SignedGadget(f, log_b, d)
        xs = np.concatenate(
            [
                np.array([0, 1, f.q - 1, f.q // 2, f.q // 2 + 1],
                         dtype=np.int64),
                rng.integers(0, f.q, size=27, dtype=np.int64),
            ]
        )
        digs = np.asarray(g.decompose(jnp.asarray(xs)[:, None]))[..., 0]
        h = ints(g.gadget_values())
        recon = np.zeros_like(xs)
        for j in range(d):
            recon = (recon + digs[j] * h[j]) % f.q
        gad_fix[name] = {
            "q": int(f.q),
            "log_b": log_b,
            "digits": d,
            "gadget_values": h,  # h_j = round(q * B**j / B**d) (approx mode)
            "inputs": ints(xs),
            "digit_rows": [ints(digs[j]) for j in range(d)],
            "reconstruction_mod_q": ints(recon),
            "max_abs_error_bound": int(
                (f.q >> (log_b * d)) // 2 + d * (1 << log_b) // 4 + 1
            )
            if log_b * d < f.bits
            else 0,
        }
    with open(os.path.join(OUT, "gadget.json"), "w") as fp:
        json.dump(gad_fix, fp)

    # ---- 3. LUT polynomials (pure function of params) ------------------
    with open(os.path.join(OUT, "lut.json"), "w") as fp:
        json.dump(
            {
                "first_level_lut": ints(first_level_lut(params)),
                "second_level_lut": ints(second_level_lut(params)),
            },
            fp,
        )

    # ---- 4. modulus switch ---------------------------------------------
    xs = np.concatenate(
        [
            np.array([0, 1, ctx.f1.q - 1], dtype=np.int64),
            rng.integers(0, ctx.f1.q, size=29, dtype=np.int64),
        ]
    )
    ms = np.asarray(
        lwe_modulus_switch(
            ctx.f1, jnp.asarray(xs), params.intermediate_lwe.cipher_modulus
        )
    )
    with open(os.path.join(OUT, "mod_switch.json"), "w") as fp:
        json.dump(
            {
                "q_from": int(ctx.f1.q),
                "q_to": int(params.intermediate_lwe.cipher_modulus),
                "inputs": ints(xs),
                "outputs": ints(ms),
            },
            fp,
        )

    # ---- 5. clue extraction index map ----------------------------------
    idx, neg = ctx.clue_extract_tables
    with open(os.path.join(OUT, "extract_map.json"), "w") as fp:
        json.dump(
            {
                "clue_count": params.clue_count,
                "n0": params.clue_params.dimension,
                "index": [ints(idx[i]) for i in range(params.clue_count)],
                "negate": [ints(neg[i]) for i in range(params.clue_count)],
            },
            fp,
        )

    # ---- 6. trace automorphism tables ----------------------------------
    autos = [
        {"g": int(g), "gidx": ints(gi), "gsign": ints(gs)}
        for (g, gi, gs) in ctx.trace_autos
    ]
    with open(os.path.join(OUT, "trace_autos.json"), "w") as fp:
        json.dump({"n2": params.n2, "rounds": autos}, fp)

    sizes = {
        f: os.path.getsize(os.path.join(OUT, f))
        for f in sorted(os.listdir(OUT))
        if f.endswith(".json")
    }
    print(json.dumps({"written": sizes}))


if __name__ == "__main__":
    main()
