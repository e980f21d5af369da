"""Benchmark harness: timing protocol, dict-driven benchmarks, sweeps, plots.

The exports of `gpuacceleratedtracking_tpu.bench`, less the TPU launch-shape
autotuner. The figures are in `bench.plots`, imported on their own as in the
JAX package (they need matplotlib).
"""

from .timing import TrialStats, benchmark
from .harness import (
    REALTIME_BOUND_S,
    add_metadata,
    run_acquire_benchmark,
    run_dual_track_benchmark,
    run_kernel_benchmark,
    run_reduction_benchmark,
    run_replica_benchmark,
    run_track_benchmark,
)
from .sweep import collect_results, dict_list, run_sweep, savename
from .results import eval_results

__all__ = [
    "TrialStats",
    "benchmark",
    "REALTIME_BOUND_S",
    "add_metadata",
    "run_acquire_benchmark",
    "run_dual_track_benchmark",
    "run_kernel_benchmark",
    "run_reduction_benchmark",
    "run_replica_benchmark",
    "run_track_benchmark",
    "collect_results",
    "dict_list",
    "run_sweep",
    "savename",
    "eval_results",
]
