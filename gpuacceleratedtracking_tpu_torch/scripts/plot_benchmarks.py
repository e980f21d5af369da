"""The benchmark figures from the port's records: the port's
``scripts/plot_benchmarks.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.plot_benchmarks

Draws each figure whose records exist under ``data/torch/benchmarks/``
(kernel, reduction, replica, track) with `bench.plots` into ``img/torch/``.
Needs pandas and matplotlib, and no card.
"""

from ..bench import collect_results
from ..bench.plots import (
    plot_kernel_benchmarks,
    plot_reduction_benchmark,
    plot_replica_benchmark,
    plot_track_benchmark,
)
from . import BENCHMARKS, IMG

FIGURES = (
    ("kernel", plot_kernel_benchmarks, "kernel_benchmarks.png"),
    ("reduction", plot_reduction_benchmark, "reduction_benchmarks.png"),
    ("replica", plot_replica_benchmark, "replica_benchmarks.png"),
    ("track", plot_track_benchmark, "track_benchmarks.png"),
)


def main(records=BENCHMARKS, figures=IMG) -> list:
    """Draw every figure whose records exist; returns the files written."""
    figures.mkdir(parents=True, exist_ok=True)
    written = []
    for kind, plot, name in FIGURES:
        records_dir = records / kind
        if any(records_dir.glob("*.json")):
            written.append(plot(collect_results(records_dir), str(figures / name)))
            print(written[-1])
    return written


if __name__ == "__main__":
    main()
