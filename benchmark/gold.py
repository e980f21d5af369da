"""GPS L1 C/A Gold codes (IS-GPS-200, section 3.3.2.3), the benchmark's own table.

Frozen copy of `gpuacceleratedtracking_tpu_torch/models/gpsl1.py` at commit
d8875d6 (`_G2_TAPS`, `_ca_code_bits`, `code_table`), rewritten over Python
integers: the 1023-chip codes from the G1 and G2 shift registers, as a
``[1023, 37]`` float32 table of +/-1 chips, one column per PRN (0-based).
Nothing of the program is imported, so the program and the reference both
take this table from the benchmark.
"""

from __future__ import annotations

import numpy as np

CODE_LENGTH = 1023

# G2 phase-select taps per PRN (IS-GPS-200 Table 3-Ia, PRN 1..37; 1-indexed stages).
G2_TAPS = (
    (2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9), (3, 10),
    (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10), (1, 4), (2, 5),
    (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6), (5, 7), (6, 8), (7, 9),
    (8, 10), (1, 6), (2, 7), (3, 8), (4, 9), (5, 10), (4, 10), (1, 7), (2, 8),
    (4, 10),
)


def ca_code_bits(prn: int) -> list:
    """The 1023 chips of ``prn`` (1-based) as 0/1 integers."""
    if not 1 <= prn <= len(G2_TAPS):
        raise ValueError(f"PRN must be in 1..{len(G2_TAPS)}, got {prn}")
    t1, t2 = G2_TAPS[prn - 1]
    g1 = [1] * 10
    g2 = [1] * 10
    out = []
    for _ in range(CODE_LENGTH):
        out.append(g1[9] ^ g2[t1 - 1] ^ g2[t2 - 1])
        # G1 feedback x^10 + x^3 + 1; G2 feedback x^10 + x^9 + x^8 + x^6 + x^3 + x^2 + 1.
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = [fb1] + g1[:9]
        g2 = [fb2] + g2[:9]
    return out


def code_table() -> np.ndarray:
    """``[1023, 37]`` float32 +/-1 chips (bit 1 -> +1, bit 0 -> -1)."""
    bits = np.array([ca_code_bits(p) for p in range(1, len(G2_TAPS) + 1)], dtype=np.float32)
    return np.ascontiguousarray(bits.T * 2.0 - 1.0)


def first_chips_octal(prn: int) -> int:
    """The first 10 chips as an octal number (IS-GPS-200 Table 3-Ia's check column)."""
    return int(oct(int("".join(map(str, ca_code_bits(prn)[:10])), 2))[2:])
