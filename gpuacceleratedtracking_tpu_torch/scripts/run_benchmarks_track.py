"""Closed-loop tracking benchmark sweep on the card: the port's
``scripts/run_benchmarks_track.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.run_benchmarks_track

Sweep: channel-bank size K at the 32.768 MHz GPS L1 scenario and at
4.096 MHz, the full DLL/PLL/FLL loop closure per 1 ms block, each block one
replay of the captured block body (`tracking.graphs`); then the JAX script's
other cells: four antennas, GLONASS L1OF, Galileo E1-C, BeiDou B1I, the GPS
L5 dual-component bank at 32.768 and 65.536 MHz, and the wide-span L1 cells
at 131 and 262 MHz with their plain-oracle (``xla_bank``) counterparts. The
headline derived metric is ``realtime_channels``: how many channels one
card tracks in real time. Records go to ``data/torch/benchmarks/track/``.
"""

from ..bench import run_dual_track_benchmark, run_sweep, run_track_benchmark
from . import BENCHMARKS

OUT = BENCHMARKS / "track"

params = {
    "GNSS": "GPSL1",
    # K=512 is the per-card share of the K=1024 bank on a 2-card channel mesh.
    "num_samples": [4096, 32768],
    "num_channels": [32, 256, 512, 1024],
    "num_ants": 1,
    "num_correlators": 3,
    "algorithm": ["pallas_bank_auto", "pallas_bank", "xla_bank"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# Beamformed four-antenna bank at the 32.768 MHz rate, L in {3, 7}.
m4_params = {
    "GNSS": "GPSL1",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_ants": 4,
    "num_correlators": [3, 7],
    "algorithm": ["pallas_bank_auto"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# GLONASS L1OF: the 511-chip m-sequence; FDMA offsets ride the per-channel
# carrier frequency.
glonass_params = {
    "GNSS": "GLONASSL1",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_correlators": 3,
    "algorithm": ["pallas_bank_auto"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# Galileo E1-C BOC(1,1) with the CS25 overlay wipe-off in the timed path.
galileo_params = {
    "GNSS": "GALILEOE1C",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_correlators": 3,
    "algorithm": ["pallas_bank_auto"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# BeiDou B1I: 2046 chips per ms, the NH20 overlay wipe-off in the timed path.
beidou_params = {
    "GNSS": "BEIDOUB1I",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_correlators": 3,
    "algorithm": ["pallas_bank_auto"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# GPS L5 dual component: K dual channels are a 2K-channel bank per block,
# NH10/NH20 wipe-off and the pilot's atan2 closure in the timed path.
dual_params = {
    "GNSS": "GPSL5",
    "num_samples": 32768,
    "num_channels": [16, 64, 128, 256],
    "num_correlators": 3,
    "algorithm": ["pallas_bank_auto"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# At 65.536 MHz the L5 chip rate is 0.156 chips per sample: the rows route.
dual_params_wide = {
    "GNSS": "GPSL5",
    "num_samples": 65536,
    "num_channels": [16, 64, 128, 256],
    "num_correlators": 3,
    "algorithm": ["pallas_bank_auto"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# Wide-span cells: L1 at 131 and 262 MHz, where one EPL chip spans >= 128
# samples.
wide_params = {
    "GNSS": "GPSL1",
    "num_samples": [131072, 262144],
    "num_channels": [256, 1024],
    "num_ants": 1,
    "num_correlators": 3,
    "algorithm": ["pallas_bank_auto"],
    "processor": ["GPU"],
    "blocks": 8,
    "trials": 7,
}

# The same cells on the plain oracle `xla_bank` (torch ops, chunked to
# ~256 MiB of taps per chunk). Few blocks: it takes milliseconds per block.
wide_fallback_params = {
    "GNSS": "GPSL1",
    "num_samples": [131072, 262144],
    "num_channels": [256, 1024],
    "num_ants": 1,
    "num_correlators": 3,
    "algorithm": ["xla_bank"],
    "processor": ["GPU"],
    "blocks": 2,
    "trials": 5,
}

# (params, runner, prefix) in the JAX script's order.
SWEEPS = (
    (params, run_track_benchmark, "TrackBenchmark"),
    (m4_params, run_track_benchmark, "TrackBenchmark"),
    (glonass_params, run_track_benchmark, "TrackBenchmark"),
    (galileo_params, run_track_benchmark, "TrackBenchmark"),
    (beidou_params, run_track_benchmark, "TrackBenchmark"),
    (dual_params, run_dual_track_benchmark, "DualTrackBenchmark"),
    (dual_params_wide, run_dual_track_benchmark, "DualTrackBenchmark"),
    (wide_params, run_track_benchmark, "TrackBenchmark"),
    (wide_fallback_params, run_track_benchmark, "TrackBenchmark"),
)


def main() -> int:
    for grid, runner, prefix in SWEEPS:
        run_sweep(grid, runner, OUT, prefix=prefix)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
