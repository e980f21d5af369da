"""GPS L1 kernel benchmark sweep on the card: the port's
``scripts/run_benchmarks_gpsl1.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.run_benchmarks_gpsl1

Sweep: N = 2^11..2^18 samples per 1 ms (2-262 MHz), M in {1, 4}, L in {3, 7},
the per-channel pipeline family, on the card (``processor="GPU"``; a timed
call replays a CUDA graph of its reps, `bench.harness.reps_program`), then
the CPU baseline of the plain torch paths. Each configuration is saved as
soon as it is done (a rerun skips those saved) under
``data/torch/benchmarks/kernel/``.
"""

from ..bench import run_kernel_benchmark, run_sweep
from . import BENCHMARKS

OUT = BENCHMARKS / "kernel"

params = {
    "GNSS": "GPSL1",
    "num_samples": [2**e for e in range(11, 19)],
    "num_ants": [1, 4],
    "num_correlators": [3, 7],
    "algorithm": ["fused_xla", "unfused_xla", "pallas_fused", "pallas_taps"],
    "processor": "GPU",
    "reps": "auto",
    "trials": 7,
}

# The host baseline: the plain torch paths only (the kernels' plain versions
# are correctness references, not a CPU performance path).
cpu_params = dict(params, processor="CPU", reps=4, trials=7,
                  algorithm=["fused_xla", "unfused_xla"])


def main() -> int:
    run_sweep(params, run_kernel_benchmark, OUT, prefix="KernelBenchmark")
    run_sweep(cpu_params, run_kernel_benchmark, OUT, prefix="KernelBenchmark")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
