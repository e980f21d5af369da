"""Correlator tap geometry (port of `gpuacceleratedtracking_tpu.models.correlator`).

Maps a preferred chip spacing to integer per-tap sample shifts, and keeps the
tap bookkeeping (which accumulator is early, prompt or late).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .system import GNSSSystem


@dataclasses.dataclass(frozen=True)
class EPLCorrelator:
    """Symmetric multi-tap correlator: ``num_accumulators`` odd, prompt centered."""

    num_accumulators: int = 3

    def __post_init__(self):
        if self.num_accumulators < 3 or self.num_accumulators % 2 == 0:
            raise ValueError("num_accumulators must be odd and >= 3")

    @property
    def prompt_index(self) -> int:
        return (self.num_accumulators - 1) // 2


def correlator_sample_shifts(
    system: GNSSSystem,
    correlator: EPLCorrelator,
    sampling_frequency: float,
    preferred_code_shift: float = 0.5,
) -> np.ndarray:
    """Integer sample shifts per tap, e.g. ``[-1, 0, 1]`` for EPL at 2.5 MHz.

    ``unit = round(preferred_code_shift * f_s / f_code)`` samples, taps at
    consecutive multiples centered on the prompt.
    """
    unit = max(1, round(preferred_code_shift * sampling_frequency / system.code_frequency))
    half = correlator.prompt_index
    return np.arange(-half, half + 1, dtype=np.int64) * unit


def actual_code_shift(
    system: GNSSSystem, sampling_frequency: float, sample_shift: int
) -> float:
    """Realized early/late spacing in chips for an integer sample shift."""
    return sample_shift * system.code_frequency / sampling_frequency
