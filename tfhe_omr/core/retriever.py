"""Retriever: client-side decoding of digests into indices and payloads.

Counterpart of reference ``omr_core/src/retriever.rs``:

* ``decode_pertinent_indices`` (``:63-130``): decrypt b - a*z in the NTT
  domain, inverse-NTT, round each coefficient by p/q (the reference uses
  BigDecimal half-up rounding at ``:79-91``; here exact int64 arithmetic),
  scan buckets whose flag slot decodes to exactly 1.
* ``decode_digest`` (``:188-260``): loop index ciphertexts until all indices
  decode, regenerate the weight matrix from the shared seed, decrypt combined
  payloads and solve the k x k linear system mod p.
* ``NoiseSigmaInfo`` (``:390-560``): decoded-noise sigma telemetry.

This is light host-side work (NumPy + a jitted decrypt), exactly like the
reference's client.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tfhe_omr.core.context import OmrContext
from tfhe_omr.core.detector import sample_weights
from tfhe_omr.core.errors import IndexDecodeError, InvertibleMatrixError
from tfhe_omr.core.matrix import solve_matrix
from tfhe_omr.core.params import RetrievalParams
from tfhe_omr.utils.devices import host_math


class Retriever:
    def __init__(
        self, params: RetrievalParams, ctx: OmrContext, z2_ntt: jnp.ndarray
    ):
        self.params = params
        self.ctx = ctx
        self._z2_ntt = z2_ntt
        self.pertinent_indices_set: set[int] = set()
        f2, ntt2 = ctx.f2, ctx.ntt2

        def decrypt(ct):
            """NTT-domain (..., 2, N) -> coefficient-domain phase b - a*z."""
            phase = f2.sub(ct[..., 1, :], f2.mul(ct[..., 0, :], z2_ntt))
            return ntt2.inv_last(phase)

        self._decrypt_jit = jax.jit(decrypt)

    def warm(self):
        """Pre-compile the client decrypt programs + build the C++ decoder.

        One-time setup cost, separated from decode latency exactly like the
        reference's ahead-of-time-compiled Rust client (its ``decode_digest``
        timings never include codegen): compiles the (2, N) index-ct and
        (cmb_cipher_count, 2, N) payload-ct decrypt programs on the host
        backend and triggers the g++ build of the native scan/solve library.
        """
        rp = self.params
        n2 = rp.polynomial_size
        zero1 = jnp.zeros((2, n2), dtype=jnp.int64)
        zero2 = jnp.zeros((rp.cmb_cipher_count, 2, n2), dtype=jnp.int64)
        with host_math():
            jax.block_until_ready(self._decrypt_jit(zero1))
            jax.block_until_ready(self._decrypt_jit(zero2))
        try:
            from tfhe_omr.native import get_lib

            get_lib()
        except ImportError:
            pass
        return self

    # ------------------------------------------------------------- decoding
    def _round_to_p(self, coeffs: np.ndarray) -> np.ndarray:
        """round_half_up(c * p / q) mod p, exactly (``retriever.rs:79-91``)."""
        q = self.ctx.f2.q
        p = int(self.params.index_modulus)
        t = (coeffs * (2 * p) + q) // (2 * q)
        return np.where(t >= p, t - p, t)

    def decode_pertinent_indices(self, ct) -> bool:
        """Accumulate indices from one index-digest ct; True when complete.

        Counterpart of ``decode_pertinent_indices`` (``retriever.rs:63-130``,
        with the flag==1 bucket scan at ``:93-123``).
        """
        rp = self.params
        # the retriever is the CLIENT: its decrypts are tiny and run on
        # the host backend
        with host_math():
            dec = np.asarray(self._decrypt_jit(jnp.asarray(np.asarray(ct))))
        decoded = self._round_to_p(dec)
        sps = rp.slots_per_segment
        spb = rp.slots_per_bucket
        nd = rp.index_slots_per_bucket
        n_seg = rp.segment_per_cipher
        n_buckets = rp.bucket_count_per_segment
        found = None
        try:
            from tfhe_omr.native import scan_buckets_native

            found = scan_buckets_native(
                decoded[: n_seg * sps],
                n_seg,
                sps,
                spb,
                n_buckets,
                int(rp.index_modulus),
                rp.all_payloads_count,
            )
        except ImportError:
            pass
        if found is not None:
            self.pertinent_indices_set.update(int(i) for i in found)
            return len(self.pertinent_indices_set) == rp.pertinent_count
        usable = decoded[: n_seg * sps].reshape(n_seg, -1)
        buckets = usable[:, : n_buckets * spb].reshape(n_seg, -1, spb)
        flags = buckets[..., -1]
        hit_seg, hit_bkt = np.nonzero(flags == 1)
        for s, b in zip(hit_seg, hit_bkt):
            digits = buckets[s, b, :nd]
            index = 0
            for d in digits[::-1]:
                index = index * rp.index_modulus + int(d)
            if index < rp.all_payloads_count:
                self.pertinent_indices_set.add(index)
        return len(self.pertinent_indices_set) == rp.pertinent_count

    def decode_combined_payloads(self, combination_cts) -> np.ndarray:
        """(cmb_cipher_count, 2, N) cts -> (combination_count, payload_len).

        Counterpart of ``decode_combined_payloads`` (``retriever.rs:318-362``).
        """
        rp = self.params
        with host_math():
            dec = np.asarray(
                self._decrypt_jit(jnp.asarray(np.asarray(combination_cts)))
            )
        vals = self._round_to_p(dec)  # (cc, N)
        plen = rp.payload_length
        per = rp.cmb_count_per_cipher
        out = np.zeros((rp.combination_count, plen), dtype=np.int64)
        for i in range(rp.combination_count):
            cipher, slot = divmod(i, per)
            out[i] = vals[cipher, slot * plen : (slot + 1) * plen]
        return out

    def decode_digest(self, index_cts, combination_cts, seed):
        """Full digest decode (counterpart of ``decode_digest``,
        ``retriever.rs:188-260``). Returns (sorted indices, payloads)."""
        rp = self.params
        for ct in index_cts:
            if self.decode_pertinent_indices(ct):
                break
        indices = sorted(self.pertinent_indices_set)
        if len(indices) < rp.pertinent_count:
            raise IndexDecodeError(
                f"recovered {len(indices)}/{rp.pertinent_count} indices"
            )
        weights = sample_weights(rp, seed)[: rp.combination_count]
        matrix = weights[:, indices]  # (combination_count, pertinent)
        combined = self.decode_combined_payloads(combination_cts)
        payloads = solve_matrix(matrix, combined, int(rp.index_modulus))
        return indices, payloads

    # ------------------------------------------------------------ telemetry
    def noise_sigma_info(self, combination_cts, expected_sigma: float):
        """Decoded-noise statistics (counterpart of ``NoiseSigmaInfo``,
        ``retriever.rs:390-560``): observed sigma + 1..6-sigma histogram."""
        rp = self.params
        q = self.ctx.f2.q
        p = int(rp.index_modulus)
        delta = (2 * q + p) // (2 * p)
        with host_math():
            dec = np.asarray(
                self._decrypt_jit(jnp.asarray(np.asarray(combination_cts)))
            )
        vals = self._round_to_p(dec)
        noise = np.mod(dec - vals * delta, q)
        signed = np.where(noise > q // 2, noise - q, noise).astype(np.float64)
        observed = float(np.sqrt(np.mean(signed**2)))
        hist = {
            k: float(np.mean(np.abs(signed) <= k * expected_sigma))
            for k in range(1, 7)
        }
        return {"expected_sigma": expected_sigma, "observed_sigma": observed,
                "sigma_hist": hist}
