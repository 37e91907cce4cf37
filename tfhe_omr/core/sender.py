"""Sender: batched clue generation.

Counterpart of reference ``omr_core/src/sender.rs`` + ``key_gen/clue.rs``:
``gen_clues`` encrypts ``clue_count`` zeros into one compact ciphertext
(``clue.rs:26-34`` via ``LwePublicKeyRlweMode::encrypt_multi_messages``).

Design difference: clues for a whole batch of messages are generated with
one integer matmul per key (the compact ciphertext is (a(X), b[0..7)) where
a = u*pk_a + e_a and b = u*pk_b + e_b with binary u), instead of the
reference's per-message rayon loop (``examples/omr.rs:126-135``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tfhe_omr.core.keygen import ClueKey
from tfhe_omr.core.params import OmrParameters


class ClueBatch(NamedTuple):
    """Compact multi-message LWE ciphertexts for a batch of messages.

    Counterpart of ``CmLweCiphertext<u16>``: ring mask ``a`` (B, n0) plus the
    ``clue_count`` masked coefficients ``b7`` (B, clue_count), mod q0.
    """

    a: np.ndarray
    b7: np.ndarray

    @staticmethod
    def concat(batches):
        return ClueBatch(
            np.concatenate([x.a for x in batches]),
            np.concatenate([x.b7 for x in batches]),
        )


def clue_chunk_body(key, lo, hi, *, cnt: int, n: int, clue_count: int,
                    noise_std: float, q0: int):
    """Jittable body of one device clue-generation chunk.

    Returns a (cnt, n + clue_count) uint16 array of compact clue
    ciphertexts (columns a | b7) mod q0. Single source of truth for the
    generator: both :meth:`Sender._build_device` and the false-positive
    rate probe (benches/fp_rate_probe.py) run exactly this program, so the
    probe measures the rate of the REAL clue distribution
    (``clue.rs:26-34`` semantics).
    """
    import jax
    import jax.numpy as jnp

    ku, ka, kb = jax.random.split(key, 3)
    u = jax.random.bernoulli(ku, 0.5, (cnt, n)).astype(jnp.int8)
    dots = [
        jax.lax.dot_general(
            u, pv, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        for pv in (lo, hi)
    ]
    r = dots[0] + (dots[1] << 7)
    if noise_std > 0.0:
        e_a = jnp.round(
            noise_std * jax.random.normal(ka, (cnt, n))
        ).astype(jnp.int32)
        e_b = jnp.round(
            noise_std * jax.random.normal(kb, (cnt, clue_count))
        ).astype(jnp.int32)
        e = jnp.concatenate([e_a, e_b], axis=1)
        r = r + e
    # q0 is a power of two < 2**16 (CmLweCiphertext<u16>, ``clue.rs``):
    # store uint16, a quarter of the bytes of int64
    return (r & (q0 - 1)).astype(jnp.uint16)


class Sender:
    def __init__(self, clue_key: ClueKey, params: OmrParameters):
        self.clue_key = clue_key
        self.params = params
        self._device_prog = None

    def gen_clues(self, count: int, rng: np.random.Generator) -> ClueBatch:
        """Encrypt ``count`` all-zero clue vectors under this sender's key."""
        k = self.clue_key
        n = k.mat_a.shape[0]
        q0 = k.q0
        u = rng.integers(0, 2, size=(count, n), dtype=np.int64)
        e_a = np.rint(rng.normal(0, k.noise_std, size=(count, n))).astype(np.int64)
        e_b = np.rint(
            rng.normal(0, k.noise_std, size=(count, k.clue_count))
        ).astype(np.int64)
        a = np.mod(u @ k.mat_a + e_a, q0)
        b7 = np.mod(u @ k.mat_b7 + e_b, q0)
        # messages are all zero -> no Delta*m term (``clue.rs:27-34``)
        return ClueBatch(a=a, b7=b7)

    # --------------------------------------------------------- device path
    #: fixed device-program chunk: ONE compiled shape serves every count
    #: (no fresh compile per board size; padding small counts up to 8192
    #: rows is cheap)
    CHUNK = 8192

    def _build_device(self):
        """One-time: jitted chunked clue generation on the accelerator.

        The host path is a (D, n) x (n, n) int64 numpy matmul — no BLAS
        kernel exists for int64, so at D=65536 it is slow on the host while
        the device idles. Here the masks u are threefry-sampled
        in-graph, the public-key matmul runs as two int8 plane dots
        (entries < 2**11 = lo 7 + hi 4 bits; binary u is one plane), and
        the rounded Gaussian noise is added mod q0. Same ciphertext
        distribution as the host path (``clue.rs:26-34``); a clue decrypts
        to 0 + noise under the clue secret either way.
        """
        import jax

        k = self.clue_key
        n = k.mat_a.shape[0]
        q0 = k.q0
        cnt = self.CHUNK
        noise_std = float(k.noise_std)
        mat = np.concatenate([k.mat_a, k.mat_b7], axis=1)  # (n, n + c)
        mat_lo = (mat & 127).astype(np.int8)
        mat_hi = (mat >> 7).astype(np.int8)

        @jax.jit
        def prog(key, lo, hi):
            return clue_chunk_body(
                key, lo, hi, cnt=cnt, n=n, clue_count=k.clue_count,
                noise_std=noise_std, q0=q0,
            )

        lo_d = jax.device_put(mat_lo)
        hi_d = jax.device_put(mat_hi)
        return lambda key: prog(key, lo_d, hi_d)

    def gen_clues_device_resident(self, count: int, seed: int):
        """Device-RESIDENT batched clue generation: a (count, n + clue_count)
        uint16 jnp array (columns = a | b7), never fetched to host.

        The server-side pipeline (examples/omr.py) consumes clues straight
        into detect, so fetching them to the host and back is pure waste.
        """
        import jax
        import jax.numpy as jnp

        if count <= 0:
            # all-pertinent boards request 0 decoy clues (examples/omr.py
            # with -p >= D); keep the static-shape contract of returning a
            # (0, n + clue_count) batch instead of indexing an empty list
            n = self.clue_key.mat_a.shape[0]
            return jnp.zeros((0, n + self.clue_key.clue_count), jnp.uint16)
        if self._device_prog is None:
            self._device_prog = self._build_device()
        base = jax.random.PRNGKey(seed)
        outs_d = [
            self._device_prog(jax.random.fold_in(base, i))
            for i in range(-(-count // self.CHUNK))
        ]
        out = jnp.concatenate(outs_d) if len(outs_d) > 1 else outs_d[0]
        return out[:count]

    def gen_clues_device(self, count: int, seed: int) -> ClueBatch:
        """Batched clue generation on the accelerator (jitted, chunked).

        Counterpart of the reference's rayon-parallel gen_clues loop
        (``examples/omr.rs:126-135``) on the device; returns host arrays in
        the same ClueBatch layout as :meth:`gen_clues`. (Server pipelines
        should prefer :meth:`gen_clues_device_resident` — see there.)
        """
        out = np.asarray(
            self.gen_clues_device_resident(count, seed)
        ).astype(np.int64)
        n = self.clue_key.mat_a.shape[0]
        return ClueBatch(a=out[:, :n], b7=out[:, n:])

    def clue_key_size(self) -> int:
        """Bytes of the public key (counterpart of ``Size`` accounting)."""
        n = self.clue_key.mat_a.shape[0]
        return 2 * n * 2  # (pk_a, pk_b) of u16 coefficients
