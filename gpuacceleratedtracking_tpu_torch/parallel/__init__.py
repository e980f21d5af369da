"""The distributed layer: channel, time and antenna parallelism over a mesh of
devices, driven from one process."""

from .mesh import ANT_AXIS, CHAN_AXIS, TIME_AXIS, channel_time_mesh, make_mesh
from .correlate import advance_phases, correlate_sharded, nominal_advance_tables
from .bank import track_bank_dual_sharded, track_bank_sharded

__all__ = [
    "ANT_AXIS",
    "CHAN_AXIS",
    "TIME_AXIS",
    "channel_time_mesh",
    "make_mesh",
    "advance_phases",
    "correlate_sharded",
    "nominal_advance_tables",
    "track_bank_dual_sharded",
    "track_bank_sharded",
]
