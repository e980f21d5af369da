"""Reduction fusion-degree sweep on the card: the port's
``scripts/benchmark_reduction.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.benchmark_reduction

Records go to ``data/torch/benchmarks/reduction/``.
"""

from ..bench import run_reduction_benchmark, run_sweep
from . import BENCHMARKS

OUT = BENCHMARKS / "reduction"

params = {
    "num_samples": [2**e for e in range(11, 16)],
    "num_ants": 4,
    "num_correlators": 3,
    "algorithm": ["pure", "cplx", "cplx_multi"],
    "processor": ["GPU"],
    "reps": "auto",
    "trials": 7,
}


def main() -> int:
    run_sweep(params, run_reduction_benchmark, OUT, prefix="ReductionBenchmark")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
