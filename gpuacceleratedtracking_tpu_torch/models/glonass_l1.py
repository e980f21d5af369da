"""GLONASS L1OF ranging code (GLONASS ICD L1/L2 edition 5.1 §3.3.2.2).

A numpy copy of `gpuacceleratedtracking_tpu.models.glonass_l1`, copied rather
than imported because the JAX package's ``models`` imports jax; the table is
bit-equal to the JAX one.

GLONASS L1OF is FDMA: every satellite transmits the same 511-chip maximal-
length sequence at 0.511 Mchip/s, on its own carrier
``1602 MHz + k * 562.5 kHz`` for frequency channel ``k in -7..6``. A channel
bank already carries a per-channel carrier frequency, so the FDMA split costs
the kernels nothing.

The m-sequence: 9-stage shift register, generator polynomial ``x^9 + x^5 + 1``,
output tapped from stage 7, all-ones initial state, period ``2^9 - 1 = 511``
chips = exactly 1 ms.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 511            # chips per period (= 1 ms at 511 kcps)
CODE_FREQUENCY = 0.511e6     # chips / s
CENTER_FREQUENCY = 1.602e9   # Hz (channel k = 0)
CHANNEL_SPACING = 562.5e3    # Hz per FDMA channel number
FREQUENCY_CHANNELS = tuple(range(-7, 7))   # ICD: k = -7 .. +6 since 2005
NUM_CHANNELS = len(FREQUENCY_CHANNELS)


def _m_sequence_bits() -> np.ndarray:
    """511-bit m-sequence as uint8 {0,1}: stage-7 output, taps 5 & 9, init ones."""
    reg = np.ones(9, dtype=np.uint8)
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = reg[6]                      # stage 7 (1-indexed) output
        fb = reg[4] ^ reg[8]                 # stages 5 and 9 feedback
        reg = np.concatenate(([fb], reg[:8]))
    return out


@functools.lru_cache(maxsize=1)
def code_table() -> np.ndarray:
    """``[511, 14]`` float32 matrix of +/-1 chips, one identical column per
    frequency channel (the spreading code is shared; the columns fit the
    ``[code_length, num_prns]`` contract of the other systems)."""
    bits = _m_sequence_bits().astype(np.float32) * 2.0 - 1.0
    return np.tile(bits[:, None], (1, NUM_CHANNELS))


def carrier_frequency(channel: int) -> float:
    """L1OF carrier for frequency channel ``k`` (-7..6): 1602 MHz + k*562.5 kHz."""
    if channel not in FREQUENCY_CHANNELS:
        raise ValueError(
            f"GLONASS frequency channel must be in {FREQUENCY_CHANNELS[0]}.."
            f"{FREQUENCY_CHANNELS[-1]}, got {channel}"
        )
    return CENTER_FREQUENCY + channel * CHANNEL_SPACING
