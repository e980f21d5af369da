"""PCPS acquisition benchmark sweep: the port's
``scripts/run_benchmarks_acquire.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.run_benchmarks_acquire [--cpu]

On the card by default (``processor="GPU"``, `torch.fft` on cuFFT); ``--cpu``
asks for the host (``processor="CPU"``), the JAX script's default engine.
The JAX script's ``--tpu`` matmul DFT serves only the TPU and is not ported.
Sweep axes: block length N (the Doppler-bin count follows from the 2/(3T)
default grid), PRN-list size K, noncoherent rounds R. Records go to
``data/torch/benchmarks/acquire/``.
"""

import sys

from ..bench import run_acquire_benchmark, run_sweep
from . import BENCHMARKS

OUT = BENCHMARKS / "acquire"

params = {
    "GNSS": "GPSL1",
    "num_samples": [2048, 8192, 32768],
    "num_prns": [1, 8, 32],
    "rounds": [1, 6],
    "trials": 7,
}

l5_params = {
    "GNSS": "GPSL5",
    "num_samples": [32768],
    "num_prns": [1, 8, 32],
    "rounds": [1, 6],
    "trials": 7,
}

# BeiDou B1I: GPS L1's 1 ms period at twice the chip rate.
beidou_params = {
    "GNSS": "BEIDOUB1I",
    "num_samples": [8192],
    "num_prns": [8, 32],
    "rounds": [1, 6],
    "trials": 7,
}

SWEEPS = (params, l5_params, beidou_params)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    processor = "CPU" if "--cpu" in argv else "GPU"
    for grid in SWEEPS:
        run_sweep(dict(grid, processor=processor), run_acquire_benchmark, OUT,
                  prefix="AcquireBenchmark")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
