"""Negacyclic LUT ("test polynomial") builders for functional bootstrapping.

Counterpart of reference ``omr_core/src/lut.rs`` (negacyclic_lut: chunk size
``half_delta = N >> log_t`` with values interleaved v0,v1,v1,v2,v2,... so each
plaintext value owns a full Δ-window centred on its encoding) and of the two
concrete LUTs at ``omr_core/src/detector.rs:457-503``.
"""

from __future__ import annotations

import numpy as np

from tfhe_omr.core.params import OmrParameters


def negacyclic_lut(values, coeff_count: int, log_t: int) -> np.ndarray:
    """Build the negacyclic LUT polynomial (int64 numpy, length coeff_count).

    Mirrors ``lut.rs:29-44``: chunks of ``half_delta = N >> log_t`` filled
    with the sequence v0, v1, v1, v2, v2, ... (interleave of values with
    values[1:]), truncated to ``2**log_t`` chunks. ``values`` may also be a
    callable f(i) -> value over i in [0, 2**log_t) (counterpart of the
    ``Fn(usize)`` impl at ``lut.rs:46-65``).
    """
    half_delta = coeff_count >> log_t
    n_chunks = 1 << log_t
    seq = []
    if callable(values):
        values = [values(i) for i in range(n_chunks)]
    vals = list(values)
    tail = vals[1:]
    for i in range(max(len(vals), len(tail)) * 2):
        src = vals if i % 2 == 0 else tail
        j = i // 2
        if j < len(src):
            seq.append(src[j])
    seq = seq[:n_chunks]
    lut = np.zeros(coeff_count, dtype=np.int64)
    for c, v in enumerate(seq):
        lut[c * half_delta : (c + 1) * half_delta] = v
    return lut


def first_level_lut(params: OmrParameters) -> np.ndarray:
    """Homomorphic-decryption LUT: clue value 0 -> +Δ1, 4 -> -Δ1, else 0.

    Mirrors ``detector.rs:457-476``: with t_out = 32,
    ``scale_one = ((q >> (log2(t_out)-1)) + 1) >> 1`` (== round(q/32)).
    """
    q = params.q1
    t_in = params.clue_params.plain_modulus
    t_out = params.intermediate_lwe.plain_modulus
    log = t_out.bit_length() - 2
    scale_one = ((q >> log) + 1) >> 1
    values = [scale_one, 0, 0, 0, q - scale_one]
    return negacyclic_lut(values, params.n1, t_in.bit_length() - 1)


def second_level_lut(params: OmrParameters) -> np.ndarray:
    """Homomorphic-equality LUT: sum == 2*clue_count -> Δ2, else 0.

    Mirrors ``detector.rs:479-503``: for non-pow-2 p, Δ2 = round_half_up(q/p).
    """
    q = params.q2
    p = params.output_plain_modulus
    t_in = params.intermediate_lwe.plain_modulus
    if p & (p - 1) == 0:
        log = p.bit_length() - 2
        scale_one = ((q >> log) + 1) >> 1
    else:
        scale_one = (2 * q + p) // (2 * p)  # round half-up of q/p
    data = [0] * t_in
    data[params.clue_count * 2] = scale_one
    return negacyclic_lut(data, params.n2, t_in.bit_length() - 1)
