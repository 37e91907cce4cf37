"""Cryptographic + retrieval-layout parameters.

Counterparts of reference ``omr_core/src/parameters/mod.rs`` (the single
hard-coded parameter set, lines 39-105) and
``omr_core/src/parameters/retrieval_params.rs`` (digest layout math).

``OmrParameters.default()`` reproduces the reference constants exactly
(SURVEY.md §2.3). ``OmrParameters.tiny()`` is a fast self-consistent test set
(no counterpart in the reference, which has no test parameters).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from functools import lru_cache

from tfhe_omr.core.payload import PAYLOAD_LENGTH


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@lru_cache(maxsize=None)
def find_ntt_prime(bits: int, two_n: int) -> int:
    """A Solinas-like prime q = 2**b - eps with two_n | q-1, b >= bits.

    Searches upward from the requested width if no such prime exists at it.
    """
    for b in range(bits, bits + 4):
        top = 1 << b
        eps_limit = 1 << (b // 2)
        for eps in range(1, eps_limit):
            q = top - eps
            if (q - 1) % two_n == 0 and _is_prime(q):
                return q
    raise ValueError(f"no NTT prime near {bits} bits for 2N={two_n}")


@dataclass(frozen=True)
class LweParams:
    """Counterpart of ``LweParameters`` (pow-2 cipher modulus)."""

    dimension: int
    plain_modulus: int
    cipher_modulus: int  # power of two
    secret_type: str  # "binary" | "ternary"
    noise_std: float

    def __post_init__(self):
        assert self.cipher_modulus & (self.cipher_modulus - 1) == 0
        assert self.secret_type in ("binary", "ternary")


@dataclass(frozen=True)
class GadgetRlweParams:
    """Counterpart of ``GadgetRlweParameters`` + ``NonPowOf2ApproxSignedBasis``."""

    dimension: int
    modulus: int
    secret_type: str
    noise_std: float
    log_basis: int
    basis_len: int  # number of digits (None in reference == full length)


@dataclass(frozen=True)
class KeySwitchParams:
    """Counterpart of ``KeySwitchingParameters``
    (reference ``parameters/mod.rs:58-66``)."""

    in_dimension: int
    out_dimension: int
    log_modulus: int
    log_basis: int
    noise_std: float

    @property
    def digits(self) -> int:
        return -(-self.log_modulus // self.log_basis)


@dataclass(frozen=True)
class OmrParameters:
    clue_params: LweParams
    clue_count: int
    first_level_br: GadgetRlweParams
    first_level_ks: KeySwitchParams
    intermediate_lwe: LweParams
    second_level_br: GadgetRlweParams
    trace: GadgetRlweParams
    output_plain_modulus: int
    payload_length: int = PAYLOAD_LENGTH
    # digest layout knobs (reference hard-codes these at
    # ``key_gen/secret.rs:195-203``)
    bucket_count_per_segment: int = 130
    segment_count: int = 25
    cmb_count_per_cipher: int = 2

    # ----------------------------------------------------------- properties
    @property
    def n1(self) -> int:
        return self.first_level_br.dimension

    @property
    def q1(self) -> int:
        return self.first_level_br.modulus

    @property
    def n2(self) -> int:
        return self.second_level_br.dimension

    @property
    def q2(self) -> int:
        return self.second_level_br.modulus

    # ------------------------------------------------------------- presets
    @staticmethod
    def default(noise_free: bool = False) -> "OmrParameters":
        """The reference parameter set (``parameters/mod.rs:39-105``).

        ``noise_free=True`` keeps every dimension/modulus/gadget constant
        but sets all noise sigmas to 0 — the deterministic interchange mode
        (the reference has no such mode, SURVEY.md §4; fixtures generated
        this way are exactly reproducible from the recorded secrets).
        """
        q1 = 134215681  # == 2**27 - 2047, reference FirstLevelField
        q2 = 1125899906826241  # == 2**50 - 16383, reference SecondLevelField
        z = lambda s: 0.0 if noise_free else s
        return OmrParameters(
            clue_params=LweParams(512, 8, 2048, "binary", z(0.8293)),
            clue_count=7,
            first_level_br=GadgetRlweParams(
                1024, q1, "ternary", z(3.1859), 5, 4
            ),
            first_level_ks=KeySwitchParams(
                1024, 670, 27, 1, z(2.0329 * (2.0**10))
            ),
            intermediate_lwe=LweParams(670, 32, 4096, "binary", z(10.3260)),
            second_level_br=GadgetRlweParams(
                2048, q2, "ternary", z(0.3908), 7, 6
            ),
            trace=GadgetRlweParams(2048, q2, "ternary", z(0.3908), 2, 25),
            output_plain_modulus=257,
        )

    @staticmethod
    def tiny(noise_free: bool = False) -> "OmrParameters":
        """Small self-consistent set for fast tests (framework addition)."""
        q1 = find_ntt_prime(24, 512)
        q2 = find_ntt_prime(38, 1024)
        s = 0.0 if noise_free else 0.5
        return OmrParameters(
            clue_params=LweParams(64, 8, 512, "binary", 0.0 if noise_free else 0.5),
            clue_count=7,
            first_level_br=GadgetRlweParams(256, q1, "ternary", s, 4, 5),
            first_level_ks=KeySwitchParams(
                256, 96, q1.bit_length(), 1, 0.0 if noise_free else 32.0
            ),
            intermediate_lwe=LweParams(96, 32, 1024, "binary", s),
            second_level_br=GadgetRlweParams(512, q2, "ternary", s, 5, 7),
            trace=GadgetRlweParams(
                512, q2, "ternary", s, 2, -(-q2.bit_length() // 2)
            ),
            output_plain_modulus=257,
            payload_length=100,
            bucket_count_per_segment=16,
            segment_count=32,
        )


@dataclass(frozen=True)
class RetrievalParams:
    """Digest layout (counterpart of ``RetrievalParams<F>``,
    reference ``parameters/retrieval_params.rs:47-113``)."""

    index_modulus: int
    polynomial_size: int
    all_payloads_count: int
    pertinent_count: int
    bucket_count_per_segment: int
    segment_count: int
    cmb_count_per_cipher: int
    payload_length: int = PAYLOAD_LENGTH

    @property
    def index_slots_per_bucket(self) -> int:
        p, d = self.index_modulus, self.all_payloads_count
        if p & (p - 1) == 0:
            dbits = max(1, (max(d, 2) - 1).bit_length())
            pb = p.bit_length() - 1
            return -(-dbits // pb)
        pow_ = 1
        while p**pow_ < d:
            pow_ += 1
        return pow_

    @property
    def slots_per_bucket(self) -> int:
        return self.index_slots_per_bucket + 1  # +1 flag slot

    @property
    def slots_per_segment(self) -> int:
        return self.slots_per_bucket * self.bucket_count_per_segment

    @property
    def segment_per_cipher(self) -> int:
        return self.polynomial_size // self.slots_per_segment

    @property
    def max_encode_indices_cipher_count(self) -> int:
        return self.segment_count // self.segment_per_cipher

    @property
    def combination_count(self) -> int:
        # reference ``retrieval_params.rs:85-89``
        if self.index_modulus & (self.index_modulus - 1) == 0:
            return self.pertinent_count + 10
        return self.pertinent_count + 5

    @property
    def cmb_cipher_count(self) -> int:
        return -(-self.combination_count // self.cmb_count_per_cipher)

    @staticmethod
    def for_params(
        params: OmrParameters, all_payloads_count: int, pertinent_count: int
    ) -> "RetrievalParams":
        """Counterpart of ``SecretKeyPack::generate_retriever``
        (reference ``key_gen/secret.rs:189-209``)."""
        return RetrievalParams(
            index_modulus=params.output_plain_modulus,
            polynomial_size=params.n2,
            all_payloads_count=all_payloads_count,
            pertinent_count=pertinent_count,
            bucket_count_per_segment=params.bucket_count_per_segment,
            segment_count=params.segment_count,
            cmb_count_per_cipher=params.cmb_count_per_cipher,
            payload_length=params.payload_length,
        )
