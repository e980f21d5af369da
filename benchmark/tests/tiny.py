"""Helpers of the benchmark's CPU tests: a copy of the benchmark whose cells are
cut to a size the CPU runs in a second, and a run of one of them."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, spec  # noqa: E402

SEED = 2**31 + 12345          # larger than 32 signed bits hold


def copy_benchmark(dest: pathlib.Path) -> pathlib.Path:
    """``BENCHMARK.json`` and ``benchmark/`` copied under ``dest``."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def shrink(root: pathlib.Path, channels: int = 8, blocks: int = 8) -> pathlib.Path:
    """Cut every configuration and traffic mix under ``root`` to a CPU's size:
    K=8 channels at 8.192 MHz (N = 8192, taps every 4 samples, still the
    rows and composite routes), 3 satellites, an 8-block capture, 4 blocks
    to an epoch20 call, no warm-up time."""
    for path in (root / "benchmark" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        taps = len(config["track"]["sample_shifts"])
        config["bank"].update(channels=channels, prn_cycle=channels)
        config["track"].update(sampling_frequency=8.192e6, num_samples=8192,
                               sample_shifts=[4 * (i - taps // 2) for i in range(taps)])
        path.write_text(json.dumps(config))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(satellites=3, capture_blocks=blocks, warm_calls=1, warm_seconds=0.0,
                       check_calls=3, check_blocks=4)
        if traffic["blocks_per_call"] > 1:
            traffic["blocks_per_call"] = 4
        path.write_text(json.dumps(traffic))
    return root


def tiny_root(tmp: pathlib.Path) -> pathlib.Path:
    return shrink(copy_benchmark(tmp))


def run(root: pathlib.Path, workload: str, seconds: float = 0.3, seed: int = SEED, **kwargs):
    """One run of ``workload`` of the copy at ``root`` on the CPU."""
    cell = spec.load_cell(workload, root)
    return harness.run(cell, seed, seconds, False, "cpu", log=lambda _: None, **kwargs)
