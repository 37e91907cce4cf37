"""Client-decode microbench (host-side, no accelerator needed).

Times the retriever path stage by stage at the reference's flagship scale
(D = 65536, k = 50): index-ct decrypt + bucket scan, payload-ct decrypt,
and the k x k mod-257 solve — counterpart of the criterion decode benches
(reference ``omr_core/benches/omr.rs:83-89``) and the decode baseline of
``README.md:125`` (305.53 ms on the authors' AVX-512 box).

Run: JAX_PLATFORMS=cpu python benches/decode_bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from tfhe_omr.core.context import OmrContext
from tfhe_omr.core.matrix import solve_matrix, solve_matrix_numpy
from tfhe_omr.core.params import OmrParameters, RetrievalParams
from tfhe_omr.core.retriever import Retriever


def timeit(fn, reps=10):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def main():
    params = OmrParameters.default()
    ctx = OmrContext(params)
    rp = RetrievalParams.for_params(params, 65536, 50)
    rng = np.random.default_rng(0)
    q2 = ctx.f2.q
    z2 = jnp.asarray(rng.integers(0, q2, size=(params.n2,), dtype=np.int64))
    retr = Retriever(rp, ctx, z2)
    t0 = time.perf_counter()
    retr.warm()
    warm_s = time.perf_counter() - t0

    idx_ct = rng.integers(0, q2, size=(2, params.n2), dtype=np.int64)
    pay_cts = rng.integers(
        0, q2, size=(rp.cmb_cipher_count, 2, params.n2), dtype=np.int64
    )
    m = rng.integers(
        0, rp.index_modulus,
        size=(rp.combination_count, rp.pertinent_count), dtype=np.int64,
    )
    rhs = rng.integers(
        0, rp.index_modulus,
        size=(rp.combination_count, rp.payload_length), dtype=np.int64,
    )
    p = int(rp.index_modulus)

    res = {
        "warm_setup_s": round(warm_s, 3),
        "index_decode_ms": round(
            1e3 * timeit(lambda: retr.decode_pertinent_indices(idx_ct)), 3
        ),
        "payload_decrypt_ms": round(
            1e3 * timeit(lambda: retr.decode_combined_payloads(pay_cts)), 3
        ),
        "solve_native_ms": round(
            1e3 * timeit(lambda: solve_matrix(m, rhs, p)), 3
        ),
        "solve_numpy_ms": round(
            1e3 * timeit(lambda: solve_matrix_numpy(m, rhs, p)), 3
        ),
        "ref_decode_ms": 305.53,
    }
    res["decode_total_ms"] = round(
        res["index_decode_ms"]
        + res["payload_decrypt_ms"]
        + res["solve_native_ms"],
        3,
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
