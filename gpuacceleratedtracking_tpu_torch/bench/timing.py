"""Timing protocol: min/median statistics over trials, fenced on the device.

Port of `gpuacceleratedtracking_tpu.bench.timing`, with the same names and
result keys. The fence is `torch.cuda.synchronize()` for CUDA outputs. A timed
span is read with CUDA events on CUDA (the device's clock, from the start
event to the stop event, so the host's enqueue time counts wherever the card
waits on it) and with `time.perf_counter` on the CPU. The device is that of
the first tensor in the measured callable's output.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Sequence

import torch


@dataclasses.dataclass
class TrialStats:
    """Min/median/mean/std/max over trials, seconds (per inner rep)."""

    times: list          # raw per-rep trial times [s]
    minimum: float
    median: float
    mean: float
    std: float
    maximum: float

    @classmethod
    def from_times(cls, times: Sequence[float]) -> "TrialStats":
        ts = list(times)
        return cls(
            times=ts,
            minimum=min(ts),
            median=statistics.median(ts),
            mean=statistics.fmean(ts),
            std=statistics.stdev(ts) if len(ts) > 1 else 0.0,
            maximum=max(ts),
        )

    def to_dict(self) -> dict:
        return {
            "Minimum": self.minimum,
            "Median": self.median,
            "Mean": self.mean,
            "Std": self.std,
            "Maximum": self.maximum,
            "times": self.times,
        }


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for item in x:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def _device_of(x) -> torch.device:
    found = _first_tensor(x)
    return found.device if found is not None else torch.device("cpu")


def _sync(x) -> None:
    """Wait until the device that holds ``x`` has finished all queued work."""
    device = _device_of(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn: Callable, args: tuple, device: torch.device) -> float:
    """Seconds from before ``fn(*args)`` is issued until its work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def _warm(fn: Callable, args: tuple) -> torch.device:
    out = fn(*args)
    _sync(out)
    return _device_of(out)


def benchmark(
    fn: Callable,
    *args,
    trials: int = 7,
    reps: int = 1,
    warmup: int = 1,
) -> TrialStats:
    """Time ``fn(*args)`` over ``trials`` trials.

    ``reps`` declares how many inner iterations one ``fn`` call holds (trial
    time is divided by it). ``warmup`` untimed calls come first (at least
    one: it tells the device).
    """
    for _ in range(max(warmup, 1)):
        device = _warm(fn, args)
    times = [_timed(fn, args, device) / reps for _ in range(trials)]
    return TrialStats.from_times(times)


def benchmark_pipelined(
    fn: Callable,
    arg_sets: Sequence[tuple],
    trials: int = 7,
) -> TrialStats:
    """Time ``fn`` by issuing one call per arg-set back to back and fencing
    once at the end (a device stream runs in order). Per-call time = total /
    len(arg_sets)."""
    device = _warm(fn, arg_sets[0])

    def all_sets():
        for a in arg_sets:
            fn(*a)

    times = [_timed(all_sets, (), device) / len(arg_sets) for _ in range(trials)]
    return TrialStats.from_times(times)


def benchmark_differential(
    make_fn: Callable[[int], tuple[Callable, tuple]],
    reps: int,
    trials: int = 7,
) -> TrialStats:
    """Per-iteration time via paired subtraction of two depths.

    ``make_fn(r)`` returns ``(fn, args)`` where one ``fn(*args)`` call runs
    ``r`` iterations of the workload. The estimate is
    ``(t(2 reps) - t(reps)) / reps`` per paired trial, clamped at 0: the
    fixed cost of a timed call (fences, events) cancels.
    """
    fn_a, args_a = make_fn(reps)
    fn_b, args_b = make_fn(2 * reps)
    device = _warm(fn_a, args_a)
    _warm(fn_b, args_b)
    diffs = []
    for _ in range(trials):
        ta = _timed(fn_a, args_a, device)
        tb = _timed(fn_b, args_b, device)
        diffs.append(max(tb - ta, 0.0) / reps)
    return TrialStats.from_times(diffs)
