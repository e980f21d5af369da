"""Replica-generation sweep (exact vs quantized NCO) on the card: the port's
``scripts/benchmark_replica.py``; each rep is one launch of
``csrc/replica.cu``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.benchmark_replica

Records go to ``data/torch/benchmarks/replica/``.
"""

from ..bench import run_replica_benchmark, run_sweep
from . import BENCHMARKS

OUT = BENCHMARKS / "replica"

params = {
    "GNSS": "GPSL1",
    "num_samples": [2**e for e in range(11, 19)],
    "algorithm": ["exact", "quantized"],
    "processor": ["GPU"],
    "reps": "auto",
    "trials": 7,
}


def main() -> int:
    run_sweep(params, run_replica_benchmark, OUT, prefix="ReplicaBenchmark")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
