"""Closed-loop tracking: discriminators, loop filters, C/N0, block loops,
dual-component (GPS L5) banks, overlay sync and lock detection."""

from . import cn0, discriminators, loop_filter
from .dual import DualTrackOutput, dual_config, track_bank_dual
from .lock import detect_bit_boundary, phase_lock_metric
from .secondary import detect_secondary_offset, detect_secondary_offset_windowed
from .state import (
    TrackConfig,
    TrackOutput,
    TrackState,
    config_from_jax_fields,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from .track import loop_update, track, track_bank, track_step

__all__ = [
    "cn0",
    "discriminators",
    "loop_filter",
    "DualTrackOutput",
    "dual_config",
    "track_bank_dual",
    "detect_bit_boundary",
    "phase_lock_metric",
    "detect_secondary_offset",
    "detect_secondary_offset_windowed",
    "TrackConfig",
    "TrackOutput",
    "TrackState",
    "config_from_jax_fields",
    "init_state",
    "state_from_numpy",
    "state_to_numpy",
    "loop_update",
    "track",
    "track_bank",
    "track_step",
]
