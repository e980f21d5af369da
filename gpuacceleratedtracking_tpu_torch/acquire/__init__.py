"""Acquisition: FFT-based parallel code-phase search (PCPS) + track handoff."""

from .pcps import AcquisitionResult, acquire, to_track_states

__all__ = ["AcquisitionResult", "acquire", "to_track_states"]
