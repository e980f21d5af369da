"""GPS L5 code generation (IS-GPS-705 §3.3.2.2): XA/XB LFSRs + Neuman-Hofman codes.

A numpy copy of `gpuacceleratedtracking_tpu.models.gpsl5`: the 10230-chip
I5/Q5 ranging codes and the NH10/NH20 overlays. It is copied rather than
imported because the JAX package's ``models`` imports jax; the tables are
bit-equal to the JAX ones. The ranging codes are the modulo-2 sum of:

- ``XA``: 13-stage LFSR, polynomial x^13+x^12+x^10+x^9+1, all-ones init,
  short-cycled — reset to all-ones after 8190 chips (one short of its natural
  8191 period) and at the 10230-chip code epoch.
- ``XB_i``: 13-stage LFSR, polynomial x^13+x^12+x^8+x^7+x^6+x^4+x^3+x+1, natural
  period 8191 (never short-cycled inside a code period); the PRN is selected by a
  per-PRN initial state, expressed here as a chip advance into the natural XB
  sequence (IS-GPS-705 Table 3-I).

Secondary (overlay) codes: NH10 = 0000110101 on I5, NH20 (20 bits) on Q5, one
overlay bit per 1 ms primary code period.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 10230           # chips per primary period (1 ms)
CODE_FREQUENCY = 10.23e6      # chips / s
CENTER_FREQUENCY = 1.17645e9  # Hz

# Overlay codes, one bit per primary period; 0 -> +1, 1 -> -1 chip sign.
NH10_BITS = np.array([0, 0, 0, 0, 1, 1, 0, 1, 0, 1], dtype=np.uint8)
NH20_BITS = np.array(
    [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0], dtype=np.uint8
)

# XB code advance in chips (IS-GPS-705 Table 3-I), PRN 1..37: (I5, Q5).
_XB_ADVANCE = [
    (266, 1701), (365, 323), (804, 5292), (1138, 2020), (1509, 5429),
    (1559, 7136), (1756, 1041), (2084, 5947), (2170, 4315), (2303, 148),
    (2527, 535), (2687, 1939), (2930, 5206), (3471, 5910), (3940, 3595),
    (4132, 5135), (4332, 6082), (4924, 6990), (5343, 3546), (5443, 1523),
    (5641, 4548), (5816, 4484), (5898, 1893), (5918, 3961), (5955, 7106),
    (6243, 5299), (6345, 4660), (6477, 276), (6518, 4389), (6875, 3783),
    (7168, 1591), (7187, 1601), (7329, 749), (7577, 1387), (7720, 1661),
    (7777, 3210), (8057, 708),
]

NUM_PRNS = len(_XB_ADVANCE)


def _lfsr_sequence(taps: tuple[int, ...], length: int) -> np.ndarray:
    """Fibonacci LFSR output (stage-13 tap) from all-ones init; 1-indexed taps."""
    state = np.ones(13, dtype=np.uint8)
    out = np.empty(length, dtype=np.uint8)
    tap_idx = [t - 1 for t in taps]
    for i in range(length):
        out[i] = state[12]
        fb = 0
        for t in tap_idx:
            fb ^= state[t]
        state = np.concatenate(([fb], state[:12]))
    return out


@functools.lru_cache(maxsize=1)
def _xa_sequence() -> np.ndarray:
    # Natural sequence truncated to the 8190-chip short cycle.
    return _lfsr_sequence((9, 10, 12, 13), 8191)[:8190]


@functools.lru_cache(maxsize=1)
def _xb_sequence() -> np.ndarray:
    return _lfsr_sequence((1, 3, 4, 6, 7, 8, 12, 13), 8191)


def _l5_code_bits(prn: int, quadrature: bool) -> np.ndarray:
    if not 1 <= prn <= NUM_PRNS:
        raise ValueError(f"PRN must be in 1..{NUM_PRNS}, got {prn}")
    adv = _XB_ADVANCE[prn - 1][1 if quadrature else 0]
    t = np.arange(CODE_LENGTH)
    xa = _xa_sequence()[t % 8190]
    xb = _xb_sequence()[(t + adv) % 8191]
    return xa ^ xb


@functools.lru_cache(maxsize=2)
def code_table(quadrature: bool = False) -> np.ndarray:
    """``[10230, 37]`` float32 matrix of +/-1 chips (I5 by default, Q5 if asked)."""
    table = np.stack(
        [_l5_code_bits(p, quadrature) for p in range(1, NUM_PRNS + 1)], axis=1
    )
    return 1.0 - 2.0 * table.astype(np.float32)


def neuman_hofman(quadrature: bool = False) -> np.ndarray:
    """Overlay code as +/-1 signs, one entry per 1 ms primary period."""
    bits = NH20_BITS if quadrature else NH10_BITS
    return 1.0 - 2.0 * bits.astype(np.float32)
