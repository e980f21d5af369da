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

Each device event keeps its card (Kineto's ``args.device``, else its
``pid``). On several cards the spins open and close the session on every
card and each card is checked on its own; the busy time is each card's own
union, averaged over the cell's cards, the kernel times are summed over the
cards, and the idle gaps are the first card's, where the consumer's
read-back and the host's spans land.
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
    busy_s: float            # each card's union of its device events inside it, averaged
                             # over the cards
    kernels: dict            # device op name -> summed seconds inside the window, all cards
    gaps: list               # (seconds, [host event names]) of the first card's idle gaps,
                             # longest first
    blocks: int              # blocks traced
    busy_by_card: dict       # card -> the union of its device events inside the window

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


def card_of(event: dict) -> int:
    """The card of a device event: Kineto's ``args.device``, else its ``pid``."""
    card = event.get("args", {}).get("device", event.get("pid", 0))
    return int(card)


def read_events(trace: dict) -> tuple[list, list, tuple | None]:
    """``(device, hosts, window)`` of a Chrome trace: device events
    ``(start, end, name, card)``, host events ``(start, end, name)``, and
    the `WINDOW` annotation's ``(start, end)``, in microseconds."""
    device, hosts, window = [], [], None
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append((start, end, e["name"], card_of(e)))
        elif cat in HOST_CATEGORIES:
            if cat == "user_annotation" and e["name"] == WINDOW:
                window = (start, end)
            else:
                hosts.append((start, end, e["name"]))
    return device, hosts, window


def live(device: list, cards=(0,)) -> bool:
    """Whether the tracer saw the whole session on each of ``cards``: an
    opening spin kernel before every other device op of the card and the
    closing one after every other op."""
    for card in cards:
        spins = sorted(s for s, _, name, c in device if c == card and SPIN in name)
        ops = [s for s, _, name, c in device if c == card and SPIN not in name]
        if not ops:
            if len(spins) != SPINS + 1:
                return False
        elif not (len(spins) >= 2 and spins[0] < min(ops) and spins[-1] > max(ops)):
            return False
    return True


def reduce(device: list, hosts: list, window: tuple, blocks: int, cards=(0,)) -> Reading:
    """The `Reading` of one live session's events inside ``window``, on
    ``cards`` (the first the one whose idle gaps are named)."""
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), name, card) for s, e, name, card in device
              if SPIN not in name and e > w0 and s < w1]
    busy = {card: union([(s, e) for s, e, _, c in inside if c == card]) for card in cards}
    busy_by_card = {card: sum(e - s for s, e in busy[card]) / 1e6 for card in cards}
    kernels: dict = collections.defaultdict(float)
    for s, e, name, _ in inside:
        kernels[name] += (e - s) / 1e6
    edges = [w0] + [x for interval in busy[cards[0]] for x in interval] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle.sort(key=lambda g: g[0] - g[1])
    window_hosts = sorted(h for h in hosts if not (h[0] <= w0 and h[1] >= w1))
    gaps = [((e - s) / 1e6, gap_hosts(s, e, window_hosts)) for s, e in idle[:TOP]]
    return Reading((w1 - w0) / 1e6, sum(busy_by_card.values()) / len(cards), dict(kernels),
                   gaps, blocks, busy_by_card)


def spin_all(cards) -> None:
    """One spin kernel on each of ``cards``."""
    for card in cards:
        with torch.cuda.device(card):
            torch.cuda._sleep(SPIN_CYCLES)


def sync_all(cards) -> None:
    for card in cards:
        torch.cuda.synchronize(card)


def traced(run_epochs: Callable[[], int], cards=(0,)) -> Reading:
    """Profile ``run_epochs()`` (which runs the traced epochs, each ending in
    the consumer's synchronise, and returns the blocks they took) between
    spin kernels on each of ``cards``, inside the `WINDOW` annotation; a
    session whose device events were lost on any card is made anew. The
    Chrome trace is written to a temporary file under ``$TMPDIR`` and
    removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cards = tuple(cards)
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SPINS):
                spin_all(cards)
            sync_all(cards)
            with record_function(WINDOW):
                blocks = run_epochs()
            spin_all(cards)
            sync_all(cards)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = json.loads(pathlib.Path(path).read_text())
        finally:
            os.unlink(path)
        device, hosts, window = read_events(trace)
        if window is not None and live(device, cards):
            return reduce(device, hosts, window, blocks, cards)
    raise RuntimeError(f"torch.profiler lost device events in {SESSIONS} sessions in a row")


def breakdown(reading: Reading) -> dict:
    """The result line's ``breakdown``: the device ops that took most time and
    the longest idle gaps, named by the host work that overlaps them."""
    ops = sorted(reading.kernels.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = [[" | ".join(names) if names else "(no host event)", seconds]
            for seconds, names in reading.gaps]
    return {"device_ops": [[name[:160], seconds] for name, seconds in ops], "idle_gaps": gaps}
