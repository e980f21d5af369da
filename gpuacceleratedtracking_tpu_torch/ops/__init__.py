"""Compute ops: replica generation, plain correlators, the bank kernel."""

from .replica import code_phase_steps, gen_carrier_replica, gen_code_replica, rate
from .correlate import (
    correlate_fused,
    correlate_xla_bank,
    downconvert,
    epl_accumulate,
)
from . import registry

__all__ = [
    "code_phase_steps",
    "gen_carrier_replica",
    "gen_code_replica",
    "rate",
    "correlate_fused",
    "correlate_xla_bank",
    "downconvert",
    "epl_accumulate",
    "registry",
]
