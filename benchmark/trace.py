"""A traced sub-window and its reading: device busy time, kernel time by name,
and the idle gaps with the host work that overlaps them.

Frozen copies, rewritten to import nothing of the program (commit d8875d6):

- `gpuacceleratedtracking_tpu_torch/bench/profile.py`: `_union`,
  `_gap_hosts` and the event split of `extract_device_times` (device events
  are a Chrome trace's kernels, memcpys and memsets; host events its
  ``cpu_op``, ``cuda_runtime`` and ``user_annotation`` spans). The window is
  not first-to-last device event here but the traced wall span, the
  ``user_annotation`` `WINDOW` around the traced epochs, so host time before
  the first launch and after the last counts as idle.
- `chip_smoke.py::traced_ops`: the profiler sometimes loses a session's first
  device events, so a session counts only where an opening spin kernel it
  recorded ran before every other device op and the closing one after every
  other op; else it is made anew, at most `SESSIONS` times.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import re
import tempfile
from typing import Callable, NamedTuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "user_annotation")
WINDOW = "benchmark.traced_window"
SPIN = "spin_kernel"
SPINS = 2                # opening spin kernels of a session
SPIN_CYCLES = 100_000
SESSIONS = 5
TOP = 10                 # rows of each breakdown list
HOSTS_PER_GAP = 3


class Reading(NamedTuple):
    """What a traced sub-window holds, times in seconds."""

    window_s: float          # the traced wall span
    busy_s: float            # the union of the device events inside it
    kernels: dict            # device op name -> summed seconds inside the window
    gaps: list               # (seconds, [host event names]) of the idle gaps, longest first
    blocks: int              # blocks traced

    def kernel_seconds(self, pattern: str) -> float:
        """Summed seconds of the device ops whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernels.items() if rx.search(name))


def union(intervals: list) -> list:
    """Sorted, merged ``(start, end)`` intervals."""
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def gap_hosts(start: float, end: float, hosts: list) -> list:
    """The names of the host events that overlap ``[start, end)`` most, summed
    by name; of two names that overlap alike, the one of shorter events first."""
    overlap: dict = collections.defaultdict(float)
    length: dict = collections.defaultdict(float)
    for h_start, h_end, name in hosts:
        if h_start >= end:
            break
        covered = min(end, h_end) - max(start, h_start)
        if covered > 0:
            overlap[name] += covered
            length[name] += h_end - h_start
    ranked = sorted(overlap, key=lambda name: (-overlap[name], length[name]))
    return ranked[:HOSTS_PER_GAP]


def read_events(trace: dict) -> tuple[list, list, tuple | None]:
    """``(device, hosts, window)`` of a Chrome trace: device events
    ``(start, end, name)``, host events ``(start, end, name)``, and the
    `WINDOW` annotation's ``(start, end)``, in microseconds."""
    device, hosts, window = [], [], None
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append((start, end, e["name"]))
        elif cat in HOST_CATEGORIES:
            if cat == "user_annotation" and e["name"] == WINDOW:
                window = (start, end)
            else:
                hosts.append((start, end, e["name"]))
    return device, hosts, window


def live(device: list) -> bool:
    """Whether the tracer saw the whole session: an opening spin kernel before
    every other device op and the closing one after every other op."""
    spins = sorted(s for s, _, name in device if SPIN in name)
    ops = [s for s, _, name in device if SPIN not in name]
    if not ops:
        return len(spins) == SPINS + 1
    return len(spins) >= 2 and spins[0] < min(ops) and spins[-1] > max(ops)


def reduce(device: list, hosts: list, window: tuple, blocks: int) -> Reading:
    """The `Reading` of one live session's events inside ``window``."""
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), name) for s, e, name in device
              if SPIN not in name and e > w0 and s < w1]
    busy = union([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in busy)
    kernels: dict = collections.defaultdict(float)
    for s, e, name in inside:
        kernels[name] += (e - s) / 1e6
    edges = [w0] + [x for interval in busy for x in interval] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle.sort(key=lambda g: g[0] - g[1])
    window_hosts = sorted(h for h in hosts if not (h[0] <= w0 and h[1] >= w1))
    gaps = [((e - s) / 1e6, gap_hosts(s, e, window_hosts)) for s, e in idle[:TOP]]
    return Reading((w1 - w0) / 1e6, busy_us / 1e6, dict(kernels), gaps, blocks)


def traced(run_epochs: Callable[[], int]) -> Reading:
    """Profile ``run_epochs()`` (which runs the traced epochs, each ending in
    the consumer's synchronise, and returns the blocks they took) between
    spin kernels, inside the `WINDOW` annotation; a session whose device
    events were lost is made anew. The Chrome trace is written to a temporary
    file under ``$TMPDIR`` and removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            with record_function(WINDOW):
                blocks = run_epochs()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = json.loads(pathlib.Path(path).read_text())
        finally:
            os.unlink(path)
        device, hosts, window = read_events(trace)
        if window is not None and live(device):
            return reduce(device, hosts, window, blocks)
    raise RuntimeError(f"torch.profiler lost device events in {SESSIONS} sessions in a row")


def breakdown(reading: Reading) -> dict:
    """The result line's ``breakdown``: the device ops that took most time and
    the longest idle gaps, named by the host work that overlaps them."""
    ops = sorted(reading.kernels.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = [[" | ".join(names) if names else "(no host event)", seconds]
            for seconds, names in reading.gaps]
    return {"device_ops": [[name[:160], seconds] for name, seconds in ops], "idle_gaps": gaps}
