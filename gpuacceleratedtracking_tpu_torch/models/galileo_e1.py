"""Galileo E1 OS codes, BOC(1,1) folded into the code table.

A numpy copy of `gpuacceleratedtracking_tpu.models.galileo_e1`, copied rather
than imported because the JAX package's ``models`` imports jax; the tables are
bit-equal to the JAX ones.

The BOC(1,1) subcarrier flips sign mid-chip. It is folded into the table: a
chip ``c`` becomes the half-chip pair ``(+c, -c)``, so every correlator sees
an ordinary +/-1 code of ``2 * 4092 = 8184`` half-chips at 2.046 Mchip/s with
a 4 ms period, at twice the transition density of a BPSK code. Phase units
are then half-chips: divide by 2 for ICD chips.

**Code provenance.** The E1 OS primary codes are memory codes: 4092-bit
sequences published as hex tables in the Galileo OS SIS ICD (Annex C), not
register-generated. No copy of those tables is at hand, so `code_table()`
builds STAND-IN primary codes with the same structure (length 4092, rate
1.023 Mchip/s, near balance, 50 PRNs) from a documented deterministic
construction (truncated 13-stage Gold-like pairs). Correlator correctness,
the meander and throughput do not depend on the particular +/-1 sequence;
tracking live Galileo signals needs the ICD tables, which
`load_primary_codes()` reads in the ICD hex-string format.

The E1-C pilot secondary code CS25_1 (25 chips over 100 ms, shared by all
PRNs) is the commonly published sequence; verify it against OS SIS ICD
Table 19 before live-sky use.
"""

from __future__ import annotations

import functools

import numpy as np

PRIMARY_LENGTH = 4092            # ICD chips per primary period (4 ms)
PRIMARY_FREQUENCY = 1.023e6      # ICD chips / s
CODE_LENGTH = 2 * PRIMARY_LENGTH      # half-chips after BOC(1,1) expansion
CODE_FREQUENCY = 2 * PRIMARY_FREQUENCY  # half-chips / s (2.046 Mcps)
CENTER_FREQUENCY = 1.57542e9     # Hz (shared with GPS L1)
NUM_PRNS = 50

# E1-C secondary code CS25_1 (one sign per 4 ms primary period; 100 ms
# total). Commonly published value; see the provenance note above.
_CS25 = "0011100000001010110110010"


def _lfsr_bits(taps: tuple[int, ...], n_stages: int, length: int,
               init: int = 1) -> np.ndarray:
    """Fibonacci LFSR output bits (uint8), ``taps`` 1-indexed feedback stages."""
    reg = np.array([(init >> i) & 1 for i in range(n_stages)], dtype=np.uint8)
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        out[i] = reg[-1]
        fb = 0
        for t in taps:
            fb ^= reg[t - 1]
        reg = np.concatenate(([fb], reg[:-1]))
    return out


def _stand_in_primaries(first_shift: int) -> np.ndarray:
    """``[4092, 50]`` stand-in memory codes (+/-1), deterministic.

    Gold-like: two maximal 13-stage m-sequences (period 8191; primitive
    polynomials x^13+x^4+x^3+x+1 and x^13+x^12+x^11+x^8+1), the second
    circularly shifted by ``137 * (first_shift + k)`` for PRN column ``k``,
    XORed, truncated to 4092.
    """
    g1 = _lfsr_bits((13, 4, 3, 1), 13, 8191)
    g2 = _lfsr_bits((13, 12, 11, 8), 13, 8191)
    cols = []
    for k in range(NUM_PRNS):
        shifted = np.roll(g2, -(137 * (k + first_shift)))
        bits = (g1 ^ shifted)[:PRIMARY_LENGTH]
        cols.append(bits.astype(np.float32) * 2.0 - 1.0)
    return np.stack(cols, axis=1)


def _boc_expand(primary: np.ndarray) -> np.ndarray:
    """Fold the BOC(1,1) subcarrier into the table: ``c -> (+c, -c)``.

    ``[L, K] -> [2L, K]``; the meander halves are consecutive half-chips.
    """
    expanded = np.empty((2 * primary.shape[0],) + primary.shape[1:],
                        dtype=np.float32)
    expanded[0::2] = primary
    expanded[1::2] = -primary
    return expanded


@functools.lru_cache(maxsize=2)
def code_table(pilot: bool = False) -> np.ndarray:
    """``[8184, 50]`` BOC(1,1)-expanded +/-1 half-chip table.

    ``pilot=True`` selects the E1-C component (distinct stand-in sequences:
    PRN columns offset by 50 in the generator); E1-B (data) otherwise.
    """
    return _boc_expand(_stand_in_primaries(51 if pilot else 1))


def secondary_code() -> np.ndarray:
    """CS25 pilot overlay: ``[25]`` +/-1, one sign per 4 ms primary period."""
    return np.array([1.0 - 2.0 * int(b) for b in _CS25], dtype=np.float32)


def load_primary_codes(hex_rows) -> np.ndarray:
    """Build the expanded table from ICD Annex C hex strings.

    ``hex_rows``: iterable of 50 hex strings, each encoding 4092 bits
    MSB-first (the ICD convention: the last hex digit carries the final 4
    bits left-aligned). Returns the ``[8184, 50]`` BOC-expanded table; pass
    it as the ``codes`` of a `GNSSSystem` to run with the authoritative codes.
    """
    cols = []
    for row in hex_rows:
        bits = np.array(
            [int(b) for h in row.strip() for b in f"{int(h, 16):04b}"],
            dtype=np.uint8,
        )[:PRIMARY_LENGTH]
        if bits.size != PRIMARY_LENGTH:
            raise ValueError(
                f"expected >= {PRIMARY_LENGTH} bits per row, got {bits.size}"
            )
        cols.append(bits.astype(np.float32) * 2.0 - 1.0)
    if len(cols) != NUM_PRNS:
        raise ValueError(f"expected {NUM_PRNS} rows, got {len(cols)}")
    return _boc_expand(np.stack(cols, axis=1))
