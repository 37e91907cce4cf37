"""Key generation: secrets, clue (public) key, detection key, trace key.

Counterpart of reference ``omr_core/src/key_gen/`` (``SecretKeyPack`` at
``secret.rs:23-209``, ``ClueKey`` at ``clue.rs``, ``DetectionKey`` at
``detection.rs``). Differences by design:

* fully seeded & optionally noise-free (deterministic test mode) — the
  reference uses ``thread_rng`` with no deterministic mode (SURVEY.md §4);
* all heavy polynomial math (RGSW encryptions for the bootstrapping keys)
  runs batched through the same jnp NTT kernels used by the detector, so key
  generation itself is device-accelerated;
* keys are stored in the layouts the detector programs consume directly:
  NTT domain, poly axis major, with Shoup companions precomputed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from tfhe_omr.core.context import OmrContext
from tfhe_omr.core.params import OmrParameters
from tfhe_omr.ops.modmath import PrimeField
from tfhe_omr.ops.ntt import NegacyclicNtt
from tfhe_omr.utils.devices import host_math, to_accelerator


class DetectionKey(NamedTuple):
    """Device arrays for the detector (counterpart of ``DetectionKey``,
    reference ``key_gen/detection.rs:9-16``). All NTT-domain, poly-major."""

    bsk1: jnp.ndarray  # (3*n0/2, N1, d1, 2, 2) int32 paired (small field)
    bsk1_sh: jnp.ndarray
    ksk_limbs: jnp.ndarray  # (limbs, N1*ks_digits, n_int+1) int8
    bsk2: jnp.ndarray  # (3*n_int/2, N2, d2, 2, 2) int64 paired
    bsk2_sh: jnp.ndarray
    trace_k: jnp.ndarray  # (rounds, N2, d_tr, 2) int64
    trace_k_sh: jnp.ndarray


class ClueKey(NamedTuple):
    """Sender-facing LWE public key in RLWE mode (counterpart of
    ``LwePublicKeyRlweMode``; reference ``key_gen/clue.rs``).

    ``mat_a[i, k]`` is coefficient k of ``X^i * pk_a`` (negacyclic), so clue
    encryption is a single (B, n) x (n, n) integer matmul; ``mat_b7`` keeps
    only the ``clue_count`` output coefficients that form the compact
    ciphertext.
    """

    mat_a: np.ndarray  # (n0, n0) int64 mod q0
    mat_b7: np.ndarray  # (n0, clue_count) int64 mod q0
    q0: int
    noise_std: float
    clue_count: int


def _gen_secret(rng: np.random.Generator, kind: str, n: int) -> np.ndarray:
    if kind == "binary":
        return rng.integers(0, 2, size=n, dtype=np.int64)
    if kind == "ternary":
        return rng.integers(-1, 2, size=n, dtype=np.int64)
    raise ValueError(kind)


def _device_uniform(key, shape, q: int):
    """Uniform field elements on device. q < 2**50 needs two 32-bit draws
    with rejection-free bias < 2**-14 avoided by 63-bit draws + modulo:
    bias <= q / 2**63 < 2**-13 per element — cryptographically this matches
    the reference's use of ``rand_distr`` uniform-by-modulo semantics."""
    import jax

    hi = jax.random.randint(key, shape, 0, 1 << 31, dtype=jnp.int64)
    lo = jax.random.randint(
        jax.random.fold_in(key, 1), shape, 0, 1 << 32, dtype=jnp.int64
    )
    return ((hi << 32) | lo) % q


def _device_gaussian(key, shape, sigma: float, q: int):
    """Rounded Gaussian noise on device, mapped into [0, q) (counterpart of
    primus-fhe ``DiscreteGaussian``; sigma == 0 -> noise-free)."""
    import jax

    if sigma == 0.0:
        return jnp.zeros(shape, dtype=jnp.int64)
    e = jnp.rint(sigma * jax.random.normal(key, shape, dtype=jnp.float32))
    return jnp.mod(e.astype(jnp.int64), q)


def _device_shoup(field: PrimeField, w):
    """Shoup companion ``floor((w << shift) / q)`` on device — same chunked
    long division as PrimeField.shoup, in int64 lanes."""
    q = field.q
    quot = jnp.zeros_like(w)
    rem = w
    shift = field.shoup_shift
    while shift > 0:
        step = min(13, shift)
        shift -= step
        rem = rem << step
        quot = (quot << step) + rem // q
        rem = rem % q
    return quot


class _BskPrograms:
    """Jitted device programs for detection-key generation.

    Each key derives in ONE jitted program on the default backend: uniform
    masks and Gaussian noise from a seeded threefry stream, NTTs through the
    same transforms the detector uses, Shoup companions computed in-graph.
    Counterpart of ``BlindRotationKey::generate`` / ``TraceKey::new``
    (reference ``secret.rs:124-165``)."""

    def __init__(self, field, ntt, gadget, noise_std: float):
        import jax

        self.field = field
        self.ntt = ntt
        self.gadget = gadget
        self.noise_std = float(noise_std)

        f = field
        q = f.q
        d = gadget.d
        h = np.asarray(gadget.gadget_values(), dtype=np.int64)

        def bsk_prog(s_msgs, z_f, z_ntt, seed):
            """s_msgs (n,) int64 messages; returns NTT-domain RGSW stack
            (n, N, d, 2, 2) and its Shoup planes."""
            n = s_msgs.shape[0]
            big_n = z_f.shape[0]
            key = jax.random.PRNGKey(seed)
            ka, ke = jax.random.split(key)
            shape = (n, 2, d, big_n)
            a = _device_uniform(ka, shape, q)
            e = _device_gaussian(ke, shape, self.noise_std, q)
            hs = (h[None, :] * s_msgs[:, None]) % q  # (n, d)
            # c=0 rows: mu = (-h_j s_i) * z (poly); c=1 rows: h_j s_i * X^0
            mu_c0 = f.mul(((q - hs) % q)[:, :, None], z_f[None, None, :])
            mu_c1 = jnp.zeros((n, d, big_n), jnp.int64).at[:, :, 0].set(hs)
            mu = jnp.stack([mu_c0, mu_c1], axis=1)
            payload = ntt.fwd_last(f.add(mu, e))
            b = f.add(f.mul(a, z_ntt[None, None, None, :]), payload)
            # (n, c, d, N, o) -> (n, N, d, c, o)
            kst = jnp.stack([a, b], axis=-1).transpose(0, 3, 2, 1, 4)
            return (kst.astype(f.storage_dtype),
                    _device_shoup(f, kst).astype(f.storage_dtype))

        self._bsk_prog = jax.jit(bsk_prog)

    def __call__(self, s_msgs, z_f, z_ntt, seed: int):
        args = (
            jnp.asarray(np.asarray(s_msgs, dtype=np.int64)),
            jnp.asarray(np.asarray(z_f, dtype=np.int64)),
            z_ntt,
            jnp.int64(seed),
        )
        return self._bsk_prog(*args)


class SecretKeyPack:
    """All four secrets plus derivation of every public/evaluation key.

    Counterpart of ``SecretKeyPack`` (reference ``key_gen/secret.rs:23-209``).
    """

    def __init__(
        self,
        params: OmrParameters,
        rng: np.random.Generator | int | None = None,
        ctx: OmrContext | None = None,
    ):
        if rng is None or isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(rng)
        self.rng = rng
        self.params = params
        self.ctx = ctx if ctx is not None else OmrContext(params)
        c = self.ctx

        p = params
        # clue LWE secret s (binary, n=512) — ``secret.rs:50``
        self.clue_sk = _gen_secret(rng, p.clue_params.secret_type, p.clue_params.dimension)
        # intermediate LWE secret s2 (binary, 670) — ``secret.rs:51-52``
        self.inter_sk = _gen_secret(
            rng, p.intermediate_lwe.secret_type, p.intermediate_lwe.dimension
        )
        # ring secrets z1 (ternary, N1) and z2 (ternary, N2) — ``secret.rs:55-82``
        self.z1 = _gen_secret(rng, p.first_level_br.secret_type, p.n1)
        self.z2 = _gen_secret(rng, p.second_level_br.secret_type, p.n2)
        self.z1_f = np.mod(self.z1, c.f1.q).astype(np.int64)
        self.z2_f = np.mod(self.z2, c.f2.q).astype(np.int64)
        import jax

        from tfhe_omr.utils.devices import accelerator_device, cpu_device

        # the two z NTTs are tiny (one poly each) — jit them on the CPU
        # backend and ship the results to the accelerator, where the
        # bsk/trace programs consume them
        with jax.default_device(cpu_device()):
            z1n = jax.jit(c.ntt1.fwd_last)(jnp.asarray(self.z1_f))
            z2n = jax.jit(c.ntt2.fwd_last)(jnp.asarray(self.z2_f))
        dev = accelerator_device()
        z1n_host = np.asarray(z1n)
        z2n_host = np.asarray(z2n)
        self.z1_ntt = jax.device_put(z1n_host, dev)
        self.z2_ntt = jax.device_put(z2n_host, dev)
        # host copy: the retriever's CPU-jitted decrypt closes over z2
        self.z2_ntt_host = z2n_host

    # ------------------------------------------------------------- clue key
    def generate_clue_key(self) -> ClueKey:
        """LWE public key in RLWE mode (``secret.rs:98-106``)."""
        p = self.params.clue_params
        n, q0 = p.dimension, p.cipher_modulus
        rng = self.rng
        pk_a = rng.integers(0, q0, size=n, dtype=np.int64)
        e = np.rint(rng.normal(0, p.noise_std, size=n)).astype(np.int64)
        s = self.clue_sk
        # b(X) = a(X) * s(X) + e(X) in Z_q0[X]/(X^n + 1)
        conv = _negacyclic_matrix(pk_a, q0)
        pk_b = np.mod(s @ conv + e, q0)
        mat_a = _negacyclic_matrix(pk_a, q0)
        mat_b = _negacyclic_matrix(pk_b, q0)
        return ClueKey(
            mat_a=mat_a,
            mat_b7=mat_b[:, : self.params.clue_count].copy(),
            q0=q0,
            noise_std=p.noise_std,
            clue_count=self.params.clue_count,
        )

    # -------------------------------------------------------- detection key
    def generate_detection_key(self) -> DetectionKey:
        """BSK1, KSK, BSK2 and trace key (``secret.rs:118-178``).

        Each key derives in one jitted device program (see _BskPrograms);
        only the tiny KSK is built on the host."""
        c = self.ctx
        p = self.params
        rng = self.rng

        bsk1, bsk1_sh = self._gen_bsk(
            self._pair_bits(self.clue_sk), self.z1_f, self.z1_ntt,
            c.f1, c.ntt1, c.gadget_br1, p.first_level_br.noise_std, rng,
        )
        with host_math():
            ksk_limbs = self._gen_ksk(rng)
        bsk2, bsk2_sh = self._gen_bsk(
            self._pair_bits(self.inter_sk), self.z2_f, self.z2_ntt,
            c.f2, c.ntt2, c.gadget_br2, p.second_level_br.noise_std, rng,
        )
        trace_k, trace_k_sh = self._gen_trace_key(rng)
        return to_accelerator(DetectionKey(
            bsk1=bsk1,
            bsk1_sh=bsk1_sh,
            ksk_limbs=ksk_limbs,
            bsk2=bsk2,
            bsk2_sh=bsk2_sh,
            trace_k=trace_k,
            trace_k_sh=trace_k_sh,
        ))

    def _gen_bsk(
        self, lwe_sk, z_f, z_ntt, field, ntt, gadget, noise_std, rng,
    ):
        """RGSW encryptions of each LWE secret bit under the ring key.

        Counterpart of ``BlindRotationKey::generate``
        (``secret.rs:124-131,149-156``), with the pairwise (BMMP16) layout:
        for each secret-bit pair (s0, s1) THREE messages are encrypted —
        m10 = s0(1-s1), m01 = s1(1-s0), m11 = s0*s1 — so one CMUX step
        handles two LWE coefficients with a single decomposition+NTT:

          X^(a0 s0 + a1 s1) = 1 + (X^a0 - 1) m10 + (X^a1 - 1) m01
                                + (X^(a0+a1) - 1) m11.

        The "lwe_sk" passed here is therefore the derived 3-message vector
        (length 3*n/2) built by ``_pair_bits``. RGSW(m) components:
        c=0 rows encrypt -h_j * z * m (paired with a-part digits),
        c=1 rows encrypt  h_j * m      (paired with b-part digits).
        Output layout (n, N, d, c, o) for the detector MAC; runs as one
        jitted device program seeded from the pack's rng stream.
        """
        prog = _BskPrograms(field, ntt, gadget, noise_std)
        seed = int(rng.integers(0, 1 << 62))
        return prog(lwe_sk, z_f, z_ntt, seed)

    @staticmethod
    def _pair_bits(sk: np.ndarray) -> np.ndarray:
        """(n,) binary secret -> (3*n/2,) pair messages [m10, m01, m11]."""
        assert len(sk) % 2 == 0
        s0 = sk[0::2]
        s1 = sk[1::2]
        return np.stack(
            [s0 * (1 - s1), s1 * (1 - s0), s0 * s1], axis=1
        ).reshape(-1)

    def _gen_ksk(self, rng):
        """LWE key switch z1 (as 1024-dim LWE secret) -> s2, binary digits.

        Counterpart of ``NonPowOf2LweKeySwitchingKey::generate``
        (``secret.rs:133-147``): input secret is the RLWE key z1 reinterpreted
        for constant-coefficient extraction, i.e. exactly the coefficient
        vector of z1 under this framework's extraction convention
        (see OmrContext.clue_extract_tables docstring).
        Output: int8 limb planes of the combined (in*digits, out+1) matrix
        whose last column is the b-row, ready for int8 matmuls.
        """
        c = self.ctx
        p = self.params
        ks = p.first_level_ks
        f = c.f1
        q = f.q
        n_in, n_out, digits = ks.in_dimension, ks.out_dimension, ks.digits
        assert ks.log_basis == 1, "key switch uses binary digits"
        s_in = np.mod(self.z1, q).astype(np.int64)  # (n_in,)
        s_out = np.asarray(self.inter_sk, dtype=np.int64)  # (n_out,)

        a = rng.integers(0, q, size=(n_in, digits, n_out), dtype=np.int64)
        e = f.gaussian(rng, ks.noise_std, (n_in, digits))
        h = (np.int64(1) << np.arange(digits, dtype=np.int64)) % q
        # b[i,j] = <a[i,j], s2> + e + h_j * s_in[i]
        asum = np.mod(a.reshape(-1, n_out) @ s_out, q).reshape(n_in, digits)
        b = np.mod(asum + e + np.mod(h[None, :] * s_in[:, None], q), q)
        # DIGIT-MAJOR row order (j*n_in + i), matching the key switch's
        # cheap (B, digits, n_in) bit-expansion layout
        mat = np.concatenate(
            [
                a.transpose(1, 0, 2).reshape(digits * n_in, n_out),
                b.T.reshape(digits * n_in, 1),
            ],
            axis=1,
        )
        limbs = -(-f.bits // 7)
        planes = np.stack(
            [((mat >> (7 * k)) & 127).astype(np.int8) for k in range(limbs)]
        )
        return jnp.asarray(planes)

    def _gen_trace_key(self, rng):
        """Automorphism key-switch keys for EvalTr (``secret.rs:158-165``).

        For each round's Galois element g: gadget RLWE encryptions of
        h_j * sigma_g(z2) under z2. Layout (rounds, N, d, o); one jitted
        device program.
        """
        import jax

        c = self.ctx
        f = c.f2
        ntt = c.ntt2
        gadget = c.gadget_trace
        q = f.q
        noise_std = float(self.params.trace.noise_std)
        h = np.asarray(gadget.gadget_values(), dtype=np.int64)
        d = gadget.d

        # sigma_g(z2) rows via the static per-round gather convention (host:
        # (rounds, N) is tiny)
        sig = np.stack(
            [
                np.mod(gsign * self.z2_f[gidx], q).astype(np.int64)
                for _g, gidx, gsign in c.trace_autos
            ]
        )
        def trace_prog(sig_z, z_ntt, seed):
            rounds, big_n = sig_z.shape
            key = jax.random.PRNGKey(seed)
            ka, ke = jax.random.split(key)
            shape = (rounds, d, big_n)
            a = _device_uniform(ka, shape, q)
            e = _device_gaussian(ke, shape, noise_std, q)
            mu = f.mul(h[None, :, None], sig_z[:, None, :])
            payload = ntt.fwd_last(f.add(mu, e))
            b = f.add(f.mul(a, z_ntt[None, None, :]), payload)
            kst = jnp.stack([a, b], axis=-1).transpose(0, 2, 1, 3)
            return kst, _device_shoup(f, kst)

        seed = int(rng.integers(0, 1 << 62))
        return jax.jit(trace_prog)(
            jnp.asarray(sig), self.z2_ntt, jnp.int64(seed)
        )

    # ------------------------------------------------------------ factories
    def generate_sender(self):
        from tfhe_omr.core.sender import Sender

        return Sender(self.generate_clue_key(), self.params)

    def generate_detector(self):
        from tfhe_omr.core.detector import Detector

        return Detector(self.generate_detection_key(), self.ctx)

    def generate_retriever(self, all_payloads_count: int, pertinent_count: int):
        from tfhe_omr.core.params import RetrievalParams
        from tfhe_omr.core.retriever import Retriever

        rp = RetrievalParams.for_params(
            self.params, all_payloads_count, pertinent_count
        )
        return Retriever(rp, self.ctx, self.z2_ntt_host)

    # ---------------------------------------------------------- decryption
    def size_bytes(self) -> int:
        """Secret material byte count (counterpart of the ``Size`` impl,
        reference ``key_gen/secret.rs:279-289``: clue + z1 + s2 + z2)."""
        p = self.params
        return (
            p.clue_params.dimension * 2
            + p.n1 * 4
            + p.intermediate_lwe.dimension * 2
            + p.n2 * 8
        )

    def z2_size(self) -> int:
        """z2 key size in bytes (``secret.rs`` ``z2_size``)."""
        return self.params.n2 * 8

    def decrypt_clue(self, a_vec: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Decrypt extracted clue LWE ciphertext(s) to Z_t (tests only)."""
        p = self.params.clue_params
        q0, t = p.cipher_modulus, p.plain_modulus
        phase = np.mod(b - a_vec @ self.clue_sk, q0)
        return np.mod((phase * t * 2 + q0) // (2 * q0), t)

    def decrypt_compact_clue(self, a_row: np.ndarray,
                             b7_row: np.ndarray) -> np.ndarray:
        """Extract + decrypt all ``clue_count`` LWE samples of ONE compact
        clue ciphertext; returns their plaintexts mod t.

        Counterpart of ``CmLweCiphertext::extract_all`` + ``decrypt``
        (reference ``detector.rs:505-531``, ``key_gen/secret.rs:266-270``).
        This is the deterministic per-event false-positive oracle: LUT1 maps
        a clue value to +1 iff it decrypts to 0 (``detector.rs:457-476``)
        and LUT2 accepts iff all ``clue_count`` clues did
        (``detector.rs:479-503``), so the detector flags a message iff every
        value returned here equals 0.
        """
        idx, neg = self.ctx.clue_extract_tables
        q0 = self.params.clue_params.cipher_modulus
        a_row = np.asarray(a_row, dtype=np.int64)
        a_ext = np.mod(
            np.where(neg == 1, -a_row[idx], a_row[idx]), q0
        )  # (clue_count, n)
        return self.decrypt_clue(a_ext, np.asarray(b7_row, dtype=np.int64))

    def decrypt_rlwe2_ntt(self, ct) -> np.ndarray:
        """Decrypt an NTT-domain second-level RLWE ct (B, 2, N2) -> plaintext
        coefficients mod q2 (message*Delta + noise). Tests/retriever helper."""
        c = self.ctx
        with host_math():
            ct = jnp.asarray(np.asarray(ct))
            z2 = jnp.asarray(self.z2_ntt_host)
            phase = c.f2.sub(ct[..., 1, :], c.f2.mul(ct[..., 0, :], z2))
            return np.asarray(c.ntt2.inv_last(phase))


def _negacyclic_matrix(poly: np.ndarray, q: int) -> np.ndarray:
    """M[i, k] = coefficient k of X^i * poly mod (X^n + 1, q)."""
    n = len(poly)
    m = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        m[i, i:] = poly[: n - i]
        if i:
            m[i, :i] = np.mod(-poly[n - i :], q)
    return m


class KeyGen:
    """Entry point (counterpart of ``KeyGen``, reference ``key_gen/mod.rs``)."""

    @staticmethod
    def generate_secret_key(
        params: OmrParameters, rng=None, ctx: OmrContext | None = None
    ) -> SecretKeyPack:
        return SecretKeyPack(params, rng, ctx)
