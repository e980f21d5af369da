"""GPS L5 kernel benchmark sweep on the card: the port's
``scripts/run_benchmarks_gpsl5.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.run_benchmarks_gpsl5

L5's 10.23 MHz chip rate needs >= ~20 MHz sampling, so N starts at 2^15.
Records go to ``data/torch/benchmarks/kernel/`` beside the L1 sweep's.
"""

from ..bench import run_kernel_benchmark, run_sweep
from . import BENCHMARKS

OUT = BENCHMARKS / "kernel"

params = {
    "GNSS": "GPSL5",
    "num_samples": [2**e for e in range(15, 19)],
    "num_ants": [1, 4],
    "num_correlators": [3, 7],
    "algorithm": ["fused_xla", "unfused_xla", "pallas_fused", "pallas_taps"],
    "processor": "GPU",
    "reps": "auto",
    "trials": 7,
}

cpu_params = dict(params, processor="CPU", reps=4, trials=7,
                  algorithm=["fused_xla", "unfused_xla"])


def main() -> int:
    run_sweep(params, run_kernel_benchmark, OUT, prefix="KernelBenchmark")
    run_sweep(cpu_params, run_kernel_benchmark, OUT, prefix="KernelBenchmark")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
