"""Device timelines from torch.profiler: per-call device time, busy share, and
the idle gaps between device ops with the host work that fills them.

The port's counterpart of `extract_device_times` in the JAX package's
``scripts/profile_trace.py``, for any callable. `profile_calls` runs the
calls under torch.profiler (CPU and, with a card, CUDA activities) inside one
``record_function`` range and one NVTX range, and exports the Chrome trace;
`extract_device_times` reads a trace back. Device events are the trace's
kernels, memcpys and memsets; host events its ``cpu_op``, ``cuda_runtime``
and ``user_annotation`` spans. Each device event names its card (the
trace's ``args.device``, else its ``pid``), so a call that runs on several
cards is also split card by card (``per_device``).
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import time
from typing import Callable, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "user_annotation")
TOP_ROWS = 8
TOP_GAPS = 8
HOSTS_PER_GAP = 3


def _fence(out) -> None:
    """Wait for ``out``'s device: the first tensor found in it, if on a card."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))


def _union(intervals: list) -> list:
    """Sorted, merged ``(start, end)`` intervals."""
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _gap_hosts(start: float, end: float, hosts: list) -> list:
    """The host events that overlap ``[start, end)`` most, summed by name; of
    two names that overlap alike, the one of shorter events first (the
    innermost span)."""
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
    return [{"name": name, "overlap_ms": overlap[name] / 1e3}
            for name in ranked[:HOSTS_PER_GAP]]


def _device_of(event: dict) -> int:
    """The card a device event ran on: its ``args.device``, else its ``pid``."""
    return int(event.get("args", {}).get("device", event.get("pid", 0)))


def _per_device(device: list, first: float, last: float, reps: int) -> dict:
    """Card by card over the window ``[first, last]`` of every card's device
    events ``(start, end, name, card, copy)``: per call the device ms, the
    copies' share of them, and the idle ms; the busy share."""
    window = last - first
    cards: dict = collections.defaultdict(list)
    for event in device:
        cards[event[3]].append(event)
    result = {}
    for card, events in sorted(cards.items()):
        busy = sum(end - start for start, end in _union([(e[0], e[1]) for e in events]))
        result[str(card)] = {
            "device_events": len(events),
            "device_per_call_ms": sum(e[1] - e[0] for e in events) / 1e3 / reps,
            "copy_per_call_ms": sum(e[1] - e[0] for e in events if e[4]) / 1e3 / reps,
            "idle_per_call_ms": (window - busy) / 1e3 / reps,
            "busy_share": busy / window if window > 0 else 1.0,
        }
    return result


def extract_device_times(trace, reps: int) -> dict:
    """Per-call device time and the device's idle gaps from a Chrome trace.

    ``trace`` is a path to a trace that torch.profiler exported, or the
    parsed trace. Returns the JAX script's keys, ``device_per_call_ms`` (the
    summed device-event time over ``reps``) and ``rows`` (the 8 device
    events with the most time, by name: ``total_ms``, ``calls``,
    ``per_call_ms`` per event), and, because wall and device time differ on
    the card: ``window_per_call_ms`` (first device start to last device end,
    over ``reps``), ``busy_share`` (the union of the device events over that
    window) and ``gaps``, the 8 longest idle stretches between device events
    (``start_ms`` from the window's start, ``ms``, and ``hosts``: the host
    events that overlap the gap most, by name, less the spans that cover the
    whole window), and ``per_device``: for each card (by index, as a
    string) its ``device_events``, ``device_per_call_ms``,
    ``copy_per_call_ms`` (memcpys and memsets), ``idle_per_call_ms`` and
    ``busy_share``, each over the window of every card's events. With no
    device event the times are None, ``rows``, ``gaps`` and ``per_device``
    empty.
    """
    trace_file = None
    if not isinstance(trace, dict):
        trace_file = str(trace)
        trace = json.loads(pathlib.Path(trace).read_text())
    device, hosts = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append((start, end, e["name"], _device_of(e), e["cat"] != "kernel"))
        elif e.get("cat") in HOST_CATEGORIES:
            hosts.append((start, end, e["name"]))
    result = {"trace_file": trace_file, "device_events": len(device)}
    total: dict = collections.Counter()
    calls: dict = collections.Counter()
    for start, end, name, _, _ in device:
        total[name] += end - start
        calls[name] += 1
    result["rows"] = {
        name: {"total_ms": us / 1e3, "calls": calls[name], "per_call_ms": us / 1e3 / calls[name]}
        for name, us in total.most_common(TOP_ROWS)
    }
    if not device:
        result.update(device_per_call_ms=None, window_per_call_ms=None, busy_share=None,
                      gaps=[], per_device={})
        return result
    busy = _union([(e[0], e[1]) for e in device])
    first, last = busy[0][0], busy[-1][1]
    window = last - first
    busy_us = sum(end - start for start, end in busy)
    # A span around the whole device window (the profile's own range) covers
    # every gap and says nothing of any.
    hosts = sorted(h for h in hosts if not (h[0] <= first and h[1] >= last))
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    result.update(
        device_per_call_ms=sum(total.values()) / 1e3 / reps,
        window_per_call_ms=window / 1e3 / reps,
        busy_share=busy_us / window if window > 0 else 1.0,
        gaps=[{"start_ms": (start - first) / 1e3, "ms": (end - start) / 1e3,
               "hosts": _gap_hosts(start, end, hosts)}
              for start, end in gaps[:TOP_GAPS]],
        per_device=_per_device(device, first, last, reps),
    )
    return result


def profile_calls(fn: Callable, args: tuple = (), reps: int = 10, label: str = "profile",
                  trace_path: Optional[str | pathlib.Path] = None) -> dict:
    """Profile ``reps`` calls of ``fn(*args)`` and read their device timeline.

    One call runs first and is fenced outside the trace (the JAX script's
    ``np.asarray(fn(*args)[0])``: builds, captures and caches happen there).
    The reps then run under torch.profiler, inside ``record_function(label)``
    and, on a card, ``torch.cuda.nvtx.range(label)``, and the last output is
    fenced inside the trace. The Chrome trace goes to ``trace_path`` (a
    temporary file if None, removed after it is read). Returns ``wall_s`` and
    ``per_call_ms`` (the host clock around the reps and the fence),
    ``host_per_call_ms`` (the host clock until the last call returns, before
    the fence: the host's own time per call where it does not wait on a
    card) and the `extract_device_times` of the trace under
    ``device_timeline``.
    """
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    _fence(fn(*args))
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    nvtx = torch.cuda.nvtx.range(label) if cuda else contextlib.nullcontext()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(label), nvtx:
            for _ in range(reps):
                out = fn(*args)
            issued = time.perf_counter() - t0
            _fence(out)
        wall = time.perf_counter() - t0
    with contextlib.ExitStack() as stack:
        if trace_path is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            path = pathlib.Path(tmp) / "trace.json"
        else:
            path = pathlib.Path(trace_path)
            path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        timeline = extract_device_times(path, reps)
    if trace_path is None:
        timeline["trace_file"] = None
    return {"label": label, "reps": reps, "wall_s": wall, "per_call_ms": wall / reps * 1e3,
            "host_per_call_ms": issued / reps * 1e3, "device_timeline": timeline}
