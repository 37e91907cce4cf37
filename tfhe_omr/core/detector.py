"""Detector: batched two-layer bootstrapping + trace + digest encoders.

Counterpart of reference ``omr_core/src/detector.rs``. The per-message
pipeline (``detect``, lines 135-166) —

    extract clues & mod-switch (``:505-531``)
    -> 7x first-level blind rotation + sum (``:533-557``)
    -> key switch z1 -> s2 (``:560-563``)
    -> mod switch q1 -> 4096, b += 7*Delta (``:571-594``)
    -> second-level blind rotation (``:599-624``)
    -> x N^-1, homomorphic trace, to NTT domain (``:626-639``)

— is here ONE jitted program batched over a message axis; scaling across
messages is vmap-free wide vector arithmetic instead of the reference's
rayon par_iter (``examples/omr.rs:160-164``). Digest encoders
(``encode_pertinent_indices`` ``:223-339``, ``encode_pertinent_payloads``
``:341-453``) become NTT + pointwise-MAC + exact modular tree reductions —
the ``psum`` shape used by the sharded runner in tfhe_omr.parallel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from tfhe_omr.core.context import OmrContext
from tfhe_omr.core.keygen import DetectionKey
from tfhe_omr.core.params import RetrievalParams
from tfhe_omr.core.sender import ClueBatch
from tfhe_omr.ops.bootstrap import (
    extract_constant_lwe,
    init_accumulator,
    lwe_modulus_switch,
    make_blind_rotate,
    make_init_accumulator,
    make_lwe_keyswitch,
    make_trace,
)


def index_poly_device(base_addr, idx, nd: int, segs: int, n2v: int,
                      idx_p: int, q2: int):
    """On-device index plaintext polys (B, N2), centred mod q.

    For each message: write the ``nd`` base-p digits of ``idx`` (LSB first)
    and a flag 1 into the drawn bucket's slots per segment (counterpart of
    ``detector.rs:271-323``); shared by the single-device and sharded
    (psum) encoders."""
    half_p = (idx_p + 1) >> 1
    ar = jnp.arange(n2v, dtype=jnp.int64)
    poly = jnp.zeros((idx.shape[0], n2v), dtype=jnp.int64)
    v = idx
    for k in range(nd + 1):
        if k < nd:
            dv = v % idx_p
            v = v // idx_p
            val = jnp.where(dv < half_p, dv, q2 - idx_p + dv)
        else:
            val = jnp.ones_like(idx)  # flag slot
        for s in range(segs):
            hit = base_addr[:, s : s + 1] + k == ar[None, :]
            poly = poly + hit * val[:, None]
    return poly


def payload_plain_device(payloads, weights_k, plen: int, n2v: int,
                         idx_p: int, q2: int):
    """On-device weighted-payload plaintext polys (B, N2), centred mod q,
    for ONE combination ciphertext (slot layout of ``detector.rs:412-433``).
    weights_k: (cmb, B)."""
    cmb = weights_k.shape[0]
    half_p = (idx_p + 1) >> 1
    pad = jnp.zeros((payloads.shape[0], n2v - cmb * plen), dtype=jnp.int64)
    wp = (payloads[None, :, :] * weights_k[:, :, None]) % idx_p
    centred = jnp.where(wp < half_p, wp, q2 - idx_p + wp)
    return jnp.concatenate(
        [centred[c] for c in range(cmb)] + [pad], axis=1
    )


@dataclass
class DetectStageTimes:
    """Per-stage timings (counterpart of ``DetectTimeInfo``,
    reference ``detector.rs:42-80``), filled by ``detect_with_time_info``."""

    detect_time: float = 0.0
    first_level_bootstrapping_time: float = 0.0
    second_level_bootstrapping_time: float = 0.0
    trace_time: float = 0.0

    def __add__(self, other):
        return DetectStageTimes(
            self.detect_time + other.detect_time,
            self.first_level_bootstrapping_time
            + other.first_level_bootstrapping_time,
            self.second_level_bootstrapping_time
            + other.second_level_bootstrapping_time,
            self.trace_time + other.trace_time,
        )


class Detector:
    """The server. Holds the detection key and jitted device programs."""

    def __init__(self, detection_key: DetectionKey, ctx: OmrContext):
        self.key = detection_key
        self.ctx = ctx
        p = ctx.params
        self._c = p.clue_count
        self._n0 = p.clue_params.dimension
        self._build_programs()

    # ------------------------------------------------------------- programs
    def _build_programs(self):
        ctx = self.ctx
        p = ctx.params
        f1, f2 = ctx.f1, ctx.f2
        ntt1, ntt2 = ctx.ntt1, ctx.ntt2
        n1, n2 = p.n1, p.n2
        clue_count = p.clue_count
        q_inter = p.intermediate_lwe.cipher_modulus
        t_inter = p.intermediate_lwe.plain_modulus
        # b += clue_count * Delta_inter (reference ``detector.rs:580-594``)
        inter_offset = clue_count * (q_inter // t_inter)

        # Both levels use the pairwise (BMMP) CMUX: one decomposition and
        # forward NTT per two LWE coefficients, so half the CMUX steps.
        br1 = make_blind_rotate(f1, ntt1, ctx.gadget_br1, paired=True)
        br2 = make_blind_rotate(f2, ntt2, ctx.gadget_br2, paired=True)
        ks = make_lwe_keyswitch(f1, p.first_level_ks.digits, p.first_level_ks.out_dimension)
        trace = make_trace(f2, ntt2, ctx.gadget_trace, ctx.trace_autos)

        # gather-free LUT rotations (one-hot int8 dots)
        init_acc1 = make_init_accumulator(f1, ctx.lut1_ext, n1)
        init_acc2 = make_init_accumulator(f2, ctx.lut2_ext, n2)
        ex_idx, ex_neg = ctx.clue_extract_tables
        q0 = p.clue_params.cipher_modulus
        # clue sample extraction as ONE signed one-hot int8 dot
        n0 = self._n0
        ext_np = np.zeros((n0, clue_count * n0), dtype=np.int8)
        for ci in range(clue_count):
            for j in range(n0):
                ext_np[ex_idx[ci, j], ci * n0 + j] = (
                    -1 if ex_neg[ci, j] else 1
                )
        n2_inv = ctx.f2.inv(n2)
        n2_inv_j = np.int64(n2_inv)
        n2_inv_sh = np.int64(int(f2.shoup(n2_inv)))

        # ---- table pytree: the big precomputed one-hot tables ride the
        # stage programs as device-resident ARGUMENTS rather than as HLO
        # constants baked into every executable. jax.jit prunes unused
        # args, so every program takes the whole dict.
        host_tables = {
            "ext": ext_np,
            "init1": init_acc1.planes,
            "init2": init_acc2.planes,
        }
        #: device-resident copies, uploaded once here
        self.tables = jax.tree_util.tree_map(jax.device_put, host_tables)

        assert q0 == 2 * n1, "clue modulus must equal 2*N1"
        assert q_inter == 2 * n2

        def stage1(clue_a, clue_b7, bsk1, bsk1_sh, ksk_limbs, tbl):
            """Extract + first-level bootstrapping + key switch + mod switch.

            Counterpart of ``extract_clues_and_modulus_switch`` +
            ``first_level_bootstrapping`` (reference ``detector.rs:505-597``;
            the mod-switch-to-2N1 guard at ``:521`` is a no-op here).
            """
            bsz = clue_a.shape[0]
            # signed one-hot extraction dot; clue values < 2**11 ride two
            # 7-bit int8 planes (counterpart of the extract_all index map)
            pl0 = (clue_a & 127).astype(jnp.int8)
            pl1 = (clue_a >> 7).astype(jnp.int8)
            dots = [
                jax.lax.dot_general(
                    pv, tbl["ext"], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                )
                for pv in (pl0, pl1)
            ]
            r_ext = dots[0] + (dots[1] << 7)  # (B, c*n0), value or -value
            a_ext = (r_ext + q0 * (r_ext < 0)).astype(jnp.int64)
            amounts1 = a_ext.reshape(bsz * clue_count, self._n0).T  # (n0, M)
            b1 = clue_b7.reshape(bsz * clue_count)

            acc = init_acc1(b1, tbl["init1"])
            acc = br1(acc, amounts1, bsk1, bsk1_sh)
            # sum the 7 per-clue results (``detector.rs:556``)
            acc = f1.mod_sum(acc.reshape(n1, 2, bsz, clue_count), axis=3)

            a_vec, b0 = extract_constant_lwe(f1, acc)
            ks_a, ks_b = ks(a_vec.T, b0, ksk_limbs)
            ms_a = lwe_modulus_switch(f1, ks_a, q_inter)
            ms_b = lwe_modulus_switch(f1, ks_b, q_inter)
            ms_b = (ms_b + inter_offset) & (q_inter - 1)
            return ms_a, ms_b

        def stage2(ms_a, ms_b, bsk2, bsk2_sh, tbl):
            """Second-level blind rotation (``detector.rs:599-624``; the
            mod-switch-to-2N2 guard at ``:612`` is a no-op here)."""
            acc2 = init_acc2(ms_b, tbl["init2"])
            return br2(acc2, ms_a.T, bsk2, bsk2_sh)

        def stage3(acc2, trace_k, trace_k_sh):
            """x N^-1, homomorphic trace, to NTT domain
            (``detector.rs:626-639``)."""
            acc2 = f2.mul_shoup(acc2, n2_inv_j, n2_inv_sh)
            acc2 = trace(acc2, trace_k, trace_k_sh)
            out = ntt2.fwd(acc2)  # to NTT domain (``to_ntt_rlwe``)
            return out.transpose(2, 1, 0)  # (B, 2, N2)

        self._stage1_jit = jax.jit(stage1)
        self._stage2_jit = jax.jit(stage2)
        self._stage3_jit = jax.jit(stage3)

        def detect(clue_a, clue_b7, key: DetectionKey, tbl):
            ms_a, ms_b = stage1(
                clue_a, clue_b7, key.bsk1, key.bsk1_sh, key.ksk_limbs, tbl,
            )
            acc2 = stage2(ms_a, ms_b, key.bsk2, key.bsk2_sh, tbl)
            return stage3(acc2, key.trace_k, key.trace_k_sh)

        self._detect_fn = detect

        def encode_chunk(pert, plain, acc):
            """One digest-accumulation chunk.

            pert: (B, 2, N2) NTT-domain pertinency cts; plain: (B, N2)
            plaintext polys (centred mod q); acc: (2, N2) running ct.
            Counterpart of the chunked map in ``detector.rs:256-337``.
            """
            pn = ntt2.fwd(plain.T)  # (N2, B)
            prod = f2.mul(pert.transpose(1, 2, 0), pn[None])  # (2, N2, B)
            return f2.add(acc, f2.mod_sum(prod, axis=2))

        self._encode_chunk_jit = jax.jit(encode_chunk)

        q2 = f2.q
        idx_p = p.output_plain_modulus
        half_p = (idx_p + 1) >> 1

        def encode_idx_chunk(pert, base_addr, idx, acc, nd, segs):
            """Index-digest chunk with ON-DEVICE plaintext construction.

            pert (B, 2, N2); base_addr (B, segs) start slots; idx (B,)
            message indices; acc (2, N2). The host only uploads the bucket
            draws — the (B, N2) centred poly (reference ``detector.rs:
            271-323``) is built here from 3*segs slot comparisons.
            """
            poly = index_poly_device(
                base_addr, idx, nd, segs, pert.shape[2], idx_p, q2
            )
            return encode_chunk(pert, poly, acc)

        self._encode_idx_chunk_jit = jax.jit(
            encode_idx_chunk, static_argnums=(4, 5)
        )

        def encode_pay_chunk(pert, payloads, weights, accs, plen):
            """Payload-digest chunk for ALL combination cts at once.

            pert (B, 2, N2); payloads (B, plen) int64; weights
            (kct, cmb, B) int16 mod p, widened here (< 257 — shipping
            int64 quadrupled the upload); accs (kct, 2, N2). The
            weighted slot
            layout (reference ``detector.rs:412-433``) is built on device;
            the payload bytes upload once per chunk instead of once per
            combination ciphertext.
            """
            kct, cmb, bsz2 = weights.shape
            weights = weights.astype(jnp.int64)
            n2v = pert.shape[2]
            pert_t = pert.transpose(1, 2, 0)
            out = []
            for k in range(kct):
                plain = payload_plain_device(
                    payloads, weights[k], plen, n2v, idx_p, q2
                )
                pn = ntt2.fwd(plain.T)
                prod = f2.mul(pert_t, pn[None])
                out.append(f2.add(accs[k], f2.mod_sum(prod, axis=2)))
            return jnp.stack(out)

        self._encode_pay_chunk_jit = jax.jit(
            encode_pay_chunk, static_argnums=(4,)
        )

        def encode_idx_scan(pert, base_addr, idx, acc, nd, segs, chunk):
            """Whole-digest index encoder as ONE device program.

            lax.scan over chunk-sized blocks of the (device-resident)
            pertinency stack — replaces the per-chunk host round trip
            (bucket draw + dispatch every 2048 messages) of the chunked
            path; bucket draws arrive pre-generated for the whole run.
            """
            nc = pert.shape[0] // chunk
            pr = pert.reshape((nc, chunk) + pert.shape[1:])
            ba = base_addr.reshape(nc, chunk, segs)
            ix = idx.reshape(nc, chunk)

            def body(carry, xs):
                p, b, i = xs
                return encode_idx_chunk(p, b, i, carry, nd, segs), None

            out, _ = jax.lax.scan(body, acc, (pr, ba, ix))
            return out

        self._encode_idx_scan_jit = jax.jit(
            encode_idx_scan, static_argnums=(4, 5, 6)
        )

        def encode_pay_scan(pert, payloads, weights, accs, plen, chunk):
            """Whole-digest payload encoder as ONE device program (all
            combination ciphertexts; payload bytes upload once as int16)."""
            nc = pert.shape[0] // chunk
            pr = pert.reshape((nc, chunk) + pert.shape[1:])
            pl = payloads.astype(jnp.int64).reshape(nc, chunk, -1)
            weights = weights.astype(jnp.int64)  # ships int16 (< 257)
            wt = weights.reshape(weights.shape[0], weights.shape[1], nc, chunk)
            wt = wt.transpose(2, 0, 1, 3)  # (nc, kct, cmb, chunk)

            def body(carry, xs):
                p, pay, w = xs
                return encode_pay_chunk(p, pay, w, carry, plen), None

            out, _ = jax.lax.scan(body, accs, (pr, pl, wt))
            return out

        self._encode_pay_scan_jit = jax.jit(
            encode_pay_scan, static_argnums=(4, 5)
        )

    # --------------------------------------------------------------- detect
    def detect(self, clues: ClueBatch) -> jnp.ndarray:
        """Detect a batch; returns pertinency ciphertexts (B, 2, N2).

        Each row is an NTT-domain RLWE ct encrypting Delta2 * pertinency_bit
        in the constant slot (counterpart of ``Detector::detect``).
        """
        key = self.key
        tbl = self.tables
        ms_a, ms_b = self._stage1_jit(
            jnp.asarray(clues.a), jnp.asarray(clues.b7),
            key.bsk1, key.bsk1_sh, key.ksk_limbs, tbl,
        )
        acc2 = self._stage2_jit(ms_a, ms_b, key.bsk2, key.bsk2_sh, tbl)
        return self._stage3_jit(acc2, key.trace_k, key.trace_k_sh)

    def detect_with_time_info(self, clues: ClueBatch):
        """Per-stage timed detect (counterpart of ``detect_with_time_info``,
        reference ``detector.rs:169-221``)."""
        import time

        key = self.key
        tbl = self.tables
        t0 = time.perf_counter()
        ms_a, ms_b = self._stage1_jit(
            jnp.asarray(clues.a), jnp.asarray(clues.b7),
            key.bsk1, key.bsk1_sh, key.ksk_limbs, tbl,
        )
        jax.block_until_ready((ms_a, ms_b))
        t1 = time.perf_counter()
        acc2 = self._stage2_jit(ms_a, ms_b, key.bsk2, key.bsk2_sh, tbl)
        jax.block_until_ready(acc2)
        t2 = time.perf_counter()
        out = self._stage3_jit(acc2, key.trace_k, key.trace_k_sh)
        jax.block_until_ready(out)
        t3 = time.perf_counter()
        return out, DetectStageTimes(
            detect_time=t3 - t0,
            first_level_bootstrapping_time=t1 - t0,
            second_level_bootstrapping_time=t2 - t1,
            trace_time=t3 - t2,
        )

    # ------------------------------------------------------- digest encoder
    def build_index_plaintexts(
        self,
        retrieval_params: RetrievalParams,
        count: int,
        rng: np.random.Generator,
        start_index: int = 0,
    ) -> np.ndarray:
        """Host: per-message index plaintext polys (count, N2), centred mod q.

        For each message and each segment in the ciphertext: pick a random
        bucket, write the base-p digits of the message index (LSB first) into
        the bucket's index slots and 1 into its flag slot
        (counterpart of ``detector.rs:271-323``).
        """
        rp = retrieval_params
        q = self.ctx.f2.q
        p = rp.index_modulus
        half_p = (p + 1) >> 1
        n2 = rp.polynomial_size
        spb = rp.slots_per_bucket
        sps = rp.slots_per_segment
        segs = rp.segment_per_cipher
        nd = rp.index_slots_per_bucket

        idx = np.arange(start_index, start_index + count, dtype=np.int64)
        buckets = rng.integers(
            0, rp.bucket_count_per_segment, size=(count, segs), dtype=np.int64
        )
        base_addr = np.arange(segs, dtype=np.int64)[None, :] * sps + buckets * spb
        polys = np.zeros((count, n2), dtype=np.int64)
        rows = np.arange(count)[:, None]
        v = idx.copy()
        digs = []
        for _ in range(nd):
            digs.append(v % p)
            v //= p
        for k in range(nd):
            dv = digs[k]
            centred = np.where(dv < half_p, dv, q - p + dv)
            polys[rows, base_addr + k] = centred[:, None]
        polys[rows, base_addr + nd] = 1  # flag slot
        return polys

    def encode_pertinent_indices(
        self,
        retrieval_params: RetrievalParams,
        pertinency: jnp.ndarray,
        rng: np.random.Generator,
        chunk: int = 2048,
    ) -> jnp.ndarray:
        """One index-digest ciphertext (2, N2) from the full pertinency stack.

        Counterpart of ``Detector::encode_pertinent_indices``
        (``detector.rs:223-339``); call ``max_encode_indices_cipher_count``
        times for the redundant digests (``examples/omr.rs:180-183``).
        """
        rp = retrieval_params
        n2 = rp.polynomial_size
        total = pertinency.shape[0]
        acc = jnp.zeros((2, n2), dtype=jnp.int64)
        # all bucket draws up front (identical numpy stream to per-chunk
        # draws: Generator.integers consumes bits in element order), so the
        # encode loop is ONE scan dispatch instead of a host round trip per
        # 2048 messages
        buckets = rng.integers(
            0, rp.bucket_count_per_segment,
            size=(total, rp.segment_per_cipher), dtype=np.int64,
        )
        base_addr = (
            np.arange(rp.segment_per_cipher, dtype=np.int64)[None, :]
            * rp.slots_per_segment
            + buckets * rp.slots_per_bucket
        )
        idx = np.arange(total, dtype=np.int64)
        main = (total // chunk) * chunk
        if main:
            acc = self._encode_idx_scan_jit(
                pertinency[:main],
                jnp.asarray(base_addr[:main]),
                jnp.asarray(idx[:main]),
                acc,
                rp.index_slots_per_bucket,
                rp.segment_per_cipher,
                chunk,
            )
        if main != total:  # ragged tail: one chunk call
            acc = self._encode_idx_chunk_jit(
                pertinency[main:],
                jnp.asarray(base_addr[main:]),
                jnp.asarray(idx[main:]),
                acc,
                rp.index_slots_per_bucket,
                rp.segment_per_cipher,
            )
        return acc

    def build_payload_plaintexts(
        self,
        retrieval_params: RetrievalParams,
        payloads: np.ndarray,
        weights: np.ndarray,
    ) -> np.ndarray:
        """Host: weighted-payload plaintext polys (B, N2), centred mod q.

        payloads: (B, payload_length); weights: (cmb_count_per_cipher, B).
        Slot layout: combination c occupies slots
        [c*payload_length, (c+1)*payload_length) (``detector.rs:412-433``).
        """
        rp = retrieval_params
        q = self.ctx.f2.q
        p = rp.index_modulus
        half_p = (p + 1) >> 1
        n2 = rp.polynomial_size
        plen = rp.payload_length
        bsz = payloads.shape[0]
        polys = np.zeros((bsz, n2), dtype=np.int64)
        for c in range(weights.shape[0]):
            wp = np.mod(payloads * weights[c][:, None], p)
            polys[:, c * plen : (c + 1) * plen] = np.where(
                wp < half_p, wp, q - p + wp
            )
        return polys

    def encode_pertinent_payloads(
        self,
        retrieval_params: RetrievalParams,
        pertinency: jnp.ndarray,
        payloads: np.ndarray,
        seed,
        chunk: int = 2048,
    ) -> jnp.ndarray:
        """All combination-digest ciphertexts (cmb_cipher_count, 2, N2).

        Counterpart of ``Detector::encode_pertinent_payloads``
        (``detector.rs:341-453``). ``seed`` drives the shared weight stream
        that the retriever regenerates (``examples/omr.rs:194-203``).
        """
        rp = retrieval_params
        n2 = rp.polynomial_size
        total = pertinency.shape[0]
        weights = sample_weights(rp, seed)
        w_all = weights.reshape(rp.cmb_cipher_count, rp.cmb_count_per_cipher, -1)
        accs = jnp.zeros((rp.cmb_cipher_count, 2, n2), dtype=jnp.int64)
        main = (total // chunk) * chunk
        if main:
            # payload bytes (< 256) ship once as int16 (4x smaller upload)
            accs = self._encode_pay_scan_jit(
                pertinency[:main],
                jnp.asarray(np.asarray(payloads[:main], dtype=np.int16)),
                jnp.asarray(np.asarray(w_all[:, :, :main], np.int16)),
                accs,
                rp.payload_length,
                chunk,
            )
        if main != total:
            accs = self._encode_pay_chunk_jit(
                pertinency[main:],
                jnp.asarray(payloads[main:].astype(np.int64)),
                jnp.asarray(np.asarray(w_all[:, :, main:], np.int16)),
                accs,
                rp.payload_length,
            )
        return accs

    def detect_key_size(self) -> int:
        """Byte-size accounting of everything the detector actually holds in
        device memory (counterpart of the ``Size`` trait, reference
        ``key_gen/detection.rs:81-89``), dtype-aware: every field of the
        DetectionKey, Shoup tables included, is charged at its real
        ``nbytes``."""
        return sum(arr.size * arr.dtype.itemsize for arr in self.key)


def sample_weights(rp: RetrievalParams, seed) -> np.ndarray:
    """The shared detector/retriever weight stream.

    (combination_count_padded, all_payloads_count) uniform in [0, p); rows
    beyond combination_count are zero (the reference sizes the buffer by
    cmb_cipher_count * cmb_count_per_cipher but only fills
    combination_count * D entries — ``detector.rs:376-389``).
    """
    rng = np.random.default_rng(seed)
    padded = rp.cmb_cipher_count * rp.cmb_count_per_cipher
    w = np.zeros((padded, rp.all_payloads_count), dtype=np.int64)
    filled = rng.integers(
        0,
        rp.index_modulus,
        size=(rp.combination_count, rp.all_payloads_count),
        dtype=np.int64,
    )
    w[: rp.combination_count] = filled
    return w
