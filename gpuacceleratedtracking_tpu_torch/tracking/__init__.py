"""Closed-loop tracking: discriminators, loop filters, C/N0, block loops."""

from . import cn0, discriminators, loop_filter
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
