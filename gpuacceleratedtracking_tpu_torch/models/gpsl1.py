"""GPS L1 C/A Gold-code generation (IS-GPS-200 §3.3.2.3).

A numpy copy of `gpuacceleratedtracking_tpu.models.gpsl1`: the 1023-chip C/A
Gold codes from the G1/G2 LFSR definition, as a ``[code_length, num_prns]``
float32 matrix of +/-1 chips. It is copied rather than imported because the
JAX package's ``models`` imports jax; the table is bit-equal to the JAX one.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023           # chips per primary period
CODE_FREQUENCY = 1.023e6     # chips / s
CENTER_FREQUENCY = 1.57542e9  # Hz

# G2 phase-select taps per PRN (IS-GPS-200 Table 3-Ia, PRN 1..37; 1-indexed stages).
_G2_TAPS = [
    (2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9), (3, 10),
    (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10), (1, 4), (2, 5),
    (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6), (5, 7), (6, 8), (7, 9),
    (8, 10), (1, 6), (2, 7), (3, 8), (4, 9), (5, 10), (4, 10), (1, 7), (2, 8),
    (4, 10),
]

NUM_PRNS = len(_G2_TAPS)


def _ca_code_bits(prn: int) -> np.ndarray:
    """Return the 1023-bit C/A code for ``prn`` (1-based) as a uint8 {0,1} array."""
    if not 1 <= prn <= NUM_PRNS:
        raise ValueError(f"PRN must be in 1..{NUM_PRNS}, got {prn}")
    t1, t2 = _G2_TAPS[prn - 1]
    g1 = np.ones(10, dtype=np.uint8)
    g2 = np.ones(10, dtype=np.uint8)
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = g1[9] ^ g2[t1 - 1] ^ g2[t2 - 1]
        # G1 feedback: x^10 + x^3 + 1 ; G2 feedback: x^10+x^9+x^8+x^6+x^3+x^2+1
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = np.concatenate(([fb1], g1[:9]))
        g2 = np.concatenate(([fb2], g2[:9]))
    return out


@functools.lru_cache(maxsize=1)
def code_table() -> np.ndarray:
    """``[1023, 37]`` float32 matrix of +/-1 chips, one column per PRN.

    Bit 1 maps to +1.0 and bit 0 to -1.0 (BPSK chips); the EPL golden values
    are invariant to the global sign convention.
    """
    table = np.stack([_ca_code_bits(p) for p in range(1, NUM_PRNS + 1)], axis=1)
    return (table.astype(np.float32) * 2.0 - 1.0)


def first_chips_octal(prn: int) -> int:
    """First 10 chips of the code as an octal int (IS-GPS-200 Table 3-Ia check)."""
    bits = _ca_code_bits(prn)[:10]
    return int(oct(int("".join(map(str, bits)), 2))[2:])
