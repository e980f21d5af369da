"""GNSS signal models: systems, code tables, synthetic signals, tap geometry."""

from . import beidou_b1i, galileo_e1, glonass_l1, gpsl1, gpsl5
from .system import (
    GNSSSystem, GPSL1, GPSL5, GLONASSL1, GalileoE1, BeiDouB1I, GNSS_REGISTRY,
    get_system,
)
from .signal import gen_signal, gen_signal_mixed, gen_carrier, upsample_code, soa
from .correlator import EPLCorrelator, correlator_sample_shifts, actual_code_shift

__all__ = [
    "GNSSSystem",
    "GPSL1",
    "GPSL5",
    "GLONASSL1",
    "GalileoE1",
    "BeiDouB1I",
    "gpsl1",
    "gpsl5",
    "glonass_l1",
    "galileo_e1",
    "beidou_b1i",
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
