"""BeiDou B1I ranging codes (BDS-SIS-ICD-2.0 §5.2.2).

A numpy copy of `gpuacceleratedtracking_tpu.models.beidou_b1i`, copied rather
than imported because the JAX package's ``models`` imports jax; the table is
bit-equal to the JAX one.

The CB1I codes are register-generated: two 11-stage Fibonacci LFSRs,

  G1(X) = 1 + X + X^7 + X^8 + X^9 + X^10 + X^11
  G2(X) = 1 + X + X^2 + X^3 + X^4 + X^5 + X^8 + X^9 + X^11

both initialised to ``01010101010`` (stage 1 -> 11). A chip is
``G1[11] XOR (G2[i] XOR G2[j])`` with the per-satellite phase-assignment pair
``(i, j)`` of ICD Table 5-2, and the natural 2047-chip period is truncated to
2046 chips. 2046 chips at 2.046 Mchip/s = 1 ms: GPS L1 C/A's block cadence at
twice its transition density.

The D1 navigation message (MEO/IGSO satellites, PRN >= 6) carries the 20-bit
Neuman-Hofman secondary code, one sign per primary period: the same NH20
sequence as GPS L5's Q5 pilot (``gpsl5.NH20_BITS``). GEO satellites (PRN
1..5) broadcast D2 without an overlay: ``BeiDouB1I(with_secondary=False)``.

Constants transcribed from the public ICD; verify them against an
authoritative ICD copy before live-sky use.
"""

from __future__ import annotations

import functools

import numpy as np

from . import gpsl5

CODE_LENGTH = 2046            # chips per primary period (1 ms)
CODE_FREQUENCY = 2.046e6      # chips / s
CENTER_FREQUENCY = 1.561098e9  # Hz (B1I carrier)

# G2 phase-assignment pairs per satellite (ICD Table 5-2, PRN 1..37;
# 1-indexed register stages). The only stage-2 / stage-7 pair is (2, 7);
# (1, 2) and (1, 7) are absent.
_G2_TAPS = [
    (1, 3), (1, 4), (1, 5), (1, 6), (1, 8), (1, 9), (1, 10), (1, 11),
    (2, 7), (3, 4), (3, 5), (3, 6), (3, 8), (3, 9), (3, 10), (3, 11),
    (4, 5), (4, 6), (4, 8), (4, 9), (4, 10), (4, 11), (5, 6), (5, 8),
    (5, 9), (5, 10), (5, 11), (6, 8), (6, 9), (6, 10), (6, 11), (8, 9),
    (8, 10), (8, 11), (9, 10), (9, 11), (10, 11),
]

NUM_PRNS = len(_G2_TAPS)

# Both registers start at 01010101010, written stage 1 -> stage 11.
_INIT = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0], dtype=np.uint8)

# Feedback stages (1-indexed) read off the generator polynomials above.
_G1_FEEDBACK = (1, 7, 8, 9, 10, 11)
_G2_FEEDBACK = (1, 2, 3, 4, 5, 8, 9, 11)


def _b1i_code_bits(prn: int) -> np.ndarray:
    """Return the 2046-bit CB1I code for ``prn`` (1-based) as uint8 {0,1}."""
    if not 1 <= prn <= NUM_PRNS:
        raise ValueError(f"PRN must be in 1..{NUM_PRNS}, got {prn}")
    t1, t2 = _G2_TAPS[prn - 1]
    g1 = _INIT.copy()
    g2 = _INIT.copy()
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = g1[10] ^ g2[t1 - 1] ^ g2[t2 - 1]
        fb1 = np.bitwise_xor.reduce(g1[[s - 1 for s in _G1_FEEDBACK]])
        fb2 = np.bitwise_xor.reduce(g2[[s - 1 for s in _G2_FEEDBACK]])
        g1 = np.concatenate(([fb1], g1[:10]))
        g2 = np.concatenate(([fb2], g2[:10]))
    return out


@functools.lru_cache(maxsize=1)
def code_table() -> np.ndarray:
    """``[2046, 37]`` float32 matrix of +/-1 chips, one column per PRN.

    Bit 1 maps to +1.0, bit 0 to -1.0; correlator outputs do not depend on
    the global sign convention.
    """
    table = np.stack([_b1i_code_bits(p) for p in range(1, NUM_PRNS + 1)], axis=1)
    return table.astype(np.float32) * 2.0 - 1.0


def secondary_code() -> np.ndarray:
    """D1 NH20 overlay, ``[20]`` +/-1, identical to GPS L5's Q5 NH20."""
    return 1.0 - 2.0 * gpsl5.NH20_BITS.astype(np.float32)
