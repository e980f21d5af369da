"""GNSS signal models: systems, code tables, synthetic signals, tap geometry."""

from . import gpsl1, gpsl5
from .system import GNSSSystem, GPSL1, GPSL5, GNSS_REGISTRY, get_system
from .signal import gen_signal, gen_signal_mixed, gen_carrier, upsample_code, soa
from .correlator import EPLCorrelator, correlator_sample_shifts, actual_code_shift

__all__ = [
    "GNSSSystem",
    "GPSL1",
    "GPSL5",
    "gpsl1",
    "gpsl5",
    "GNSS_REGISTRY",
    "get_system",
    "gen_signal",
    "gen_signal_mixed",
    "gen_carrier",
    "upsample_code",
    "soa",
    "EPLCorrelator",
    "correlator_sample_shifts",
    "actual_code_shift",
]
