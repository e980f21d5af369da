"""Compute ops: replica generation, plain correlators, reductions, and the
kernels' wrappers (imported on first use through `registry`)."""

from .replica import (
    code_phase_steps,
    gen_carrier_replica,
    gen_code_replica,
    gen_code_replica_quantized,
    rate,
)
from .correlate import (
    correlate_fused,
    correlate_unfused,
    correlate_xla_bank,
    downconvert,
    epl_accumulate,
)
from .reduce import REDUCTIONS, get_reduction
from . import registry

__all__ = [
    "code_phase_steps",
    "gen_carrier_replica",
    "gen_code_replica",
    "gen_code_replica_quantized",
    "rate",
    "correlate_fused",
    "correlate_unfused",
    "correlate_xla_bank",
    "downconvert",
    "epl_accumulate",
    "REDUCTIONS",
    "get_reduction",
    "registry",
]
