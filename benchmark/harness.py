"""One run of one cell: set-up, the measured window, the traced sub-window, the
check against the plain reference, and the result line.

The traffic is a closed loop over a capture that sits on the card: one
consumer makes an epoch's call of ``track_bank`` over ``blocks_per_call``
consecutive blocks, copies its outputs and final state to host memory,
synchronises, and only then makes the next call, from that final state. A
pass through the capture starts from the set-up states; at the capture's end
the next call is handed the set-up states again, so every pass is the same
work.

`run` takes the program (``track_bank``'s signature) as an argument: the
command passes the port's, the control passes the reference's
(`reference.track_bank_control`), and tests pass a broken one.

A configuration with a ``mesh`` key (``{"chan": 4, "time": 1}``) runs the
bank spread over the cell's cards: the port's program is then
`parallel.track_bank_sharded` on that layout of ``cuda:0`` up (`cards`),
behind ``track_bank``'s signature. The capture, the set-up states and the
code table stay on the first card, and the results come back joined onto
it, so the loop, the read-back and the check are the same for every cell.
Every card of the cell is synchronised at the end of an epoch, its peak
memory read, and traced.
"""

from __future__ import annotations

import math
import random
import sys
import time
from typing import Callable, NamedTuple, Optional

import torch

from . import capture, trace, yardstick
from .gold import code_table
from .spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "gpuacceleratedtracking_tpu")
NO_AGREEMENT = 1.0e30        # a gap where nothing agrees (a NaN or a zero scale)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is a forbidden one."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


# --- The program under test.

def cards(cell: Cell, device: torch.device) -> list:
    """The cell's cards, the first one first: ``device`` alone, or one for
    each place of the configuration's ``mesh`` (``chan x time``), ``cuda:0``
    up on a card and the CPU repeated off it (a mesh of repeated devices)."""
    layout = cell.config.get("mesh")
    if layout is None:
        return [device]
    count = int(layout["chan"]) * int(layout["time"])
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(count)]
    return [device] * count


def port_program(cell: Cell, device) -> tuple[Callable, object]:
    """The port's ``track_bank`` and the `TrackConfig` of the cell, and a
    function that frees the port's cached graphs. Where the configuration
    names a ``mesh``, the program is `parallel.track_bank_sharded` on that
    layout of the cell's cards, behind ``track_bank``'s signature."""
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, graphs, track_bank

    fields = dict(cell.config["track"])
    for key in ("sample_shifts", "secondary_code"):
        if key in fields:
            fields[key] = tuple(fields[key])
    layout = cell.config.get("mesh")
    if layout is None:
        return track_bank, TrackConfig(**fields), graphs.clear
    from gpuacceleratedtracking_tpu_torch.parallel import make_mesh, track_bank_sharded

    mesh = make_mesh(layout, cards(cell, torch.device(device)))

    def sharded(config, codes, states, signal_re, signal_im, ant_weights=None):
        if ant_weights is not None:
            raise ValueError("the sharded bank takes no steering weights")
        return track_bank_sharded(config, codes, states, signal_re, signal_im, mesh=mesh)

    return sharded, TrackConfig(**fields), graphs.clear


def port_state(state_np, device):
    """The set-up states as the port's `TrackState` on ``device``."""
    from gpuacceleratedtracking_tpu_torch.tracking import state_from_numpy

    return state_from_numpy(state_np, device=device)


# --- The consumer's read-back.

def named_leaves(prefix: str, tree) -> list:
    """``(dotted name, tensor)`` of a tree of NamedTuples of tensors."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [leaf for field in tree._fields
            for leaf in named_leaves(f"{prefix}.{field}", getattr(tree, field))]


def leaf_names(state, out) -> list:
    """The dotted names of a call's final state's and outputs' leaves, in the
    order `flatten` gives them."""
    return [name for name, _ in named_leaves("state", state) + named_leaves("out", out)]


def flatten(tree, into: list) -> list:
    """The tensors of a tree of tuples, depth first."""
    for x in tree:
        if isinstance(x, torch.Tensor):
            into.append(x)
        else:
            flatten(x, into)
    return into


class HostSet:
    """One call's results in host memory: a buffer per dtype (pinned on a
    card), and a view of it for each leaf, by the leaves' order. A fill
    gathers each dtype's leaves on the device and copies them in one piece,
    whatever the program's layout of its results."""

    def __init__(self, template: list, pinned: bool):
        self.groups: dict = {}
        for i, x in enumerate(template):
            self.groups.setdefault(x.dtype, []).append(i)
        self.buffers, self.leaves = {}, [None] * len(template)
        for dtype, members in self.groups.items():
            sizes = [template[i].numel() for i in members]
            buffer = torch.empty(sum(sizes), dtype=dtype, pin_memory=pinned)
            for i, view in zip(members, torch.split(buffer, sizes)):
                self.leaves[i] = view.view(template[i].shape)
            self.buffers[dtype] = buffer
        self.refs = 0
        self.is_prev = False

    def fill(self, leaves: list) -> None:
        for dtype, members in self.groups.items():
            staged = torch.cat([leaves[i].reshape(-1) for i in members])
            self.buffers[dtype].copy_(staged, non_blocking=True)


class Kept(NamedTuple):
    """A call kept for the check."""

    first_block: int         # its first block in the capture
    source: Optional[HostSet]  # the call before it (its final state is this call's input),
                             # None where the call started a pass from the set-up states
    result: HostSet


class Keeper:
    """The calls kept for the check: the window's first call, and a uniform
    sample drawn from the seed of the others (reservoir sampling), with the
    host sets they hold."""

    def __init__(self, slots: int, seed: int, template: list, pinned: bool):
        self.slots = slots
        self.rng = random.Random(seed)
        self.pool = [HostSet(template, pinned) for _ in range(2 * slots + 2)]
        self.kept: list = []
        self.seen = 0

    def take(self) -> HostSet:
        return self.pool.pop()

    def release(self, host: Optional[HostSet]) -> None:
        if host is not None and host.refs == 0 and not host.is_prev:
            self.pool.append(host)

    def decide(self) -> int | None:
        """Before a call: the slot it will take if kept, else None."""
        ordinal = self.seen
        self.seen += 1
        if ordinal < self.slots:
            return ordinal
        pick = self.rng.randrange(ordinal)          # the first call keeps slot 0
        return 1 + pick if pick < self.slots - 1 else None

    def keep(self, slot: int, record: Kept) -> None:
        for host in (record.source, record.result):
            if host is not None:
                host.refs += 1
        if slot < len(self.kept):
            old = self.kept[slot]
            self.kept[slot] = record
            for host in (old.source, old.result):
                if host is not None:
                    host.refs -= 1
                    self.release(host)
        else:
            self.kept.append(record)


# --- The run.

class Run(NamedTuple):
    """What a run measured, for the metric readers."""

    cell: Cell
    card: Optional[dict]     # the card's peaks (`yardstick.peaks`), None off the table
    setup_s: float
    window_s: float
    calls: int
    blocks: int
    host_call_s: float       # summed host time of the window's calls, to their return
    epoch_s: tuple           # each window call's time from its start to its outputs on the host
    reading: Optional[trace.Reading]


def sync(devices: list) -> None:
    for device in dict.fromkeys(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class Loop:
    """The closed loop over the capture: the program, its inputs, and the
    consumer's read-back."""

    def __init__(self, cell: Cell, program: Callable, track_config, codes, setup_state,
                 signal: tuple, weights, keeper: Keeper, devices: list):
        self.cell, self.program, self.config, self.codes = cell, program, track_config, codes
        self.setup_state, self.signal, self.weights = setup_state, signal, weights
        self.keeper, self.devices = keeper, devices
        self.per_call = int(cell.traffic["blocks_per_call"])
        self.capture_blocks = int(signal[0].shape[0])
        if self.capture_blocks % self.per_call:
            raise ValueError(f"{self.capture_blocks} capture blocks are not whole calls of "
                             f"{self.per_call}")
        self.prev: Optional[HostSet] = None
        self.state, self.position, self.host_call_s = setup_state, 0, 0.0
        self.epoch_s: list = []

    def start_window(self) -> None:
        """Back to the capture's start and the set-up states, and the first
        call's keeping drawn."""
        self.state = self.setup_state
        self.position = 0
        self.host_call_s = 0.0
        self.epoch_s = []
        self.pending = self.keeper.decide()

    def epoch(self, keep: bool) -> None:
        """One call, its read-back and the consumer's synchronise of every
        card. The next call's keeping is drawn now: a kept call's input is
        this call's state."""
        slot = self.pending if keep else None
        if keep:
            self.pending = self.keeper.decide()
        b0, b1 = self.position, self.position + self.per_call
        start = time.perf_counter()
        state, out = self.program(self.config, self.codes, self.state, self.signal[0][b0:b1],
                                  self.signal[1][b0:b1], self.weights)
        self.host_call_s += time.perf_counter() - start
        dest = self.keeper.take()
        dest.fill(flatten((state, out), []))
        sync(self.devices)
        self.epoch_s.append(time.perf_counter() - start)
        source = self.prev if b0 else None
        if slot is not None:
            self.keeper.keep(slot, Kept(b0, source, dest))
        if self.prev is not None:
            self.prev.is_prev = False
            self.keeper.release(self.prev)
        dest.is_prev = True
        self.prev = dest
        self.position = b1 % self.capture_blocks
        self.state = state if self.position else self.setup_state


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device, *,
        program: Optional[Callable] = None, t_start: Optional[float] = None,
        log=print) -> dict:
    """One run of ``cell``; returns the result line's object (with ``checks``
    last). ``program`` replaces the port's ``track_bank``; ``t_start`` is the
    process's start on the host clock (set-up is counted from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    devices = cards(cell, device)
    config, traffic = cell.config, cell.traffic
    ref = cell.reference

    # Set-up: the program, the capture, the set-up states, warm calls.
    port_track_bank, track_config, free_program = port_program(cell, device)
    program = port_track_bank if program is None else program
    table_np = code_table()
    table = torch.from_numpy(table_np).to(device)
    scenario = capture.draw_scenario(config, traffic, seed)
    signal = capture.synthesise(config, traffic, scenario, table, seed, device)
    state_np = capture.initial_state(config, scenario)
    setup_state = port_state(state_np, device)
    weights_np = capture.steering_weights(scenario) if config["bank"]["antennas"] > 1 else None
    weights = (None if weights_np is None
               else tuple(torch.from_numpy(w).to(device) for w in weights_np))
    pinned = device.type == "cuda"

    per_call = int(traffic["blocks_per_call"])
    probe = program(track_config, table, setup_state, signal[0][:per_call],
                    signal[1][:per_call], weights)
    names = leaf_names(*probe)
    keeper = Keeper(int(traffic["check_calls"]), seed, flatten(probe, []), pinned)
    del probe
    loop = Loop(cell, program, track_config, table, setup_state, signal, weights, keeper,
                devices)
    warm_until = time.perf_counter() + float(traffic["warm_seconds"])
    warm = 0
    while warm < int(traffic["warm_calls"]) or time.perf_counter() < warm_until:
        loop.epoch(keep=False)
        warm += 1
    loop.start_window()
    sync(devices)
    on_card = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    for d in on_card:
        torch.cuda.reset_peak_memory_stats(d)

    # The measured window.
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls = 0
    while calls == 0 or time.perf_counter() - t0 < seconds:
        loop.epoch(keep=True)
        calls += 1
    window_s = time.perf_counter() - t0
    host_call_s, epoch_s = loop.host_call_s, tuple(loop.epoch_s)

    # The traced sub-window, continuing the loop.
    reading = None
    if trace_on and device.type == "cuda":
        traced_epochs = int(traffic["traced_epochs"])

        def run_epochs():
            for _ in range(traced_epochs):
                loop.epoch(keep=False)
            return traced_epochs * per_call

        reading = trace.traced(run_epochs, [d.index or 0 for d in on_card])
    memory_peak = max((int(torch.cuda.max_memory_allocated(d)) for d in on_card), default=0)

    # Free the program's state before the reference runs.
    kept = list(keeper.kept)
    loop.state = loop.setup_state = setup_state = None
    del loop
    free_program()
    for d in on_card:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()

    checks, wrong = judge(cell, ref, kept, names, signal, table, state_np, weights_np, seed,
                          device)
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    card = yardstick.peaks(kind)
    record = Run(cell, card, setup_s, window_s, calls, calls * per_call, host_call_s, epoch_s,
                 reading)
    metrics = {}
    for m in cell.metrics:
        if ("layer" in m) != trace_on:
            continue
        value = cell.readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": calls,
        "failed": wrong,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                   "count": len(devices), "memory_peak_bytes": memory_peak},
    }
    if reading is not None:
        result["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = trace.breakdown(reading)
    result["checks"] = checks
    for name, v in checks.items():
        log(f"{name} {v['value']!r} limit {v['limit']!r}")
    return result


# --- The check.

PERIODS = {"carrier_phase": lambda cfg: 2 * math.pi,
           "code_phase": lambda cfg: float(cfg["track"]["code_length"])}


def leaf_gap(name: str, got: torch.Tensor, want: torch.Tensor, config: dict) -> float:
    """The widest gap of a leaf against the reference's largest magnitude in
    it; a phase's gap is taken modulo its period, an integer leaf is 0 where
    equal and 1 where not."""
    if not want.is_floating_point():
        return 0.0 if torch.equal(got.to(want.dtype), want) else 1.0
    got, want = got.double(), want.double()
    diff = got - want
    period = PERIODS.get(name.split(".")[-1])
    if period is not None:
        p = period(config)
        diff = torch.remainder(diff + p / 2, p) - p / 2
    both_nan = torch.isnan(got) & torch.isnan(want)
    diff = torch.where(both_nan, torch.zeros_like(diff), diff)
    if not bool(torch.isfinite(diff).all()):
        return NO_AGREEMENT
    widest = float(diff.abs().max()) if diff.numel() else 0.0
    scale = float(torch.nan_to_num(want, nan=0.0).abs().max()) if want.numel() else 0.0
    if scale == 0.0:
        return 0.0 if widest == 0.0 else NO_AGREEMENT
    return widest / scale


def judge(cell: Cell, ref, kept: list, names: list, signal: tuple, table: torch.Tensor,
          state_np, weights_np, seed: int, device) -> tuple[dict, int]:
    """The numbers that decide ``correct``, each beside its limit, and how
    many kept calls read over a limit.

    - ``accum_gap``: the bank correlator. For a sample of the kept calls'
      blocks drawn from the seed (with the window's first block), the
      reference correlates the block from the NCO state the program held at
      the block's start (the call's input state, else the program's outputs
      of the block before), every phase exact in float64, and the widest gap
      of the program's accumulators is taken against the root mean square of
      the reference's, block by block. A sample whose exact code phase lies
      within `ambiguous_chips` of a chip boundary counts on either side of it
      (`accum_gap`).
    - ``loop_gap``: the loop closure. From each kept call's input state, the
      reference closes the loop on the program's accumulators, block by
      block, and every output leaf but the accumulators, of every block, and
      every leaf of the final state is held against the program's
      (`leaf_gap`).

    Each is the widest over the blocks and calls it reads.
    """
    cfg = ref.LoopConfig.from_fields(cell.config["track"])
    ambiguous = ref.ambiguous_chips(cfg)
    limits = {name: float(v["limit"]) for name, v in cell.limits.items()}
    per_call = int(cell.traffic["blocks_per_call"])
    setup = capture.to_torch(state_np, device)
    num_k = int(cell.config["bank"]["channels"])
    num_ants = int(cell.config["bank"]["antennas"])
    weights = (None if weights_np is None
               else ref.expand_weights(tuple(torch.from_numpy(w) for w in weights_np), num_k,
                                       num_ants, device))
    rng = random.Random(seed ^ 0x5EED)
    blocks = [(i, b) for i in range(len(kept)) for b in range(per_call)]
    sample = {(0, 0)} | set(rng.sample(blocks, min(len(blocks),
                                                   int(cell.traffic["check_blocks"]))))
    index = {name: i for i, name in enumerate(names)}
    state_names = [name for name, _ in named_leaves("state", setup)]

    def host(hs: HostSet, name: str) -> torch.Tensor:
        return hs.leaves[index[name]].to(device)

    widest = {"accum_gap": 0.0, "loop_gap": 0.0}
    wrong = 0
    for i, k in enumerate(kept):
        gaps = {"accum_gap": 0.0, "loop_gap": 0.0}
        if k.source is None:
            state = setup
        else:
            state = ref.state_from_leaves({name[len("state."):]: host(k.source, name)
                                           for name in state_names})
        outs = {name: host(k.result, "out." + name) for name in ref.TrackOutput._fields}
        nco = state
        for b in range(per_call):
            block = k.first_block + b
            acc_re, acc_im = outs["accum_re"][b], outs["accum_im"][b]
            if (i, b) in sample:
                *want, flips = ref.correlate(cfg, table, nco, signal[0][block],
                                             signal[1][block], ambiguous=ambiguous)
                gaps["accum_gap"] = max(gaps["accum_gap"],
                                        accum_gap(ref, (acc_re, acc_im), want, flips))
            state, out = ref.loop_update(cfg, state, acc_re, acc_im, weights)
            for name in ref.TrackOutput._fields:
                if not name.startswith("accum"):
                    gaps["loop_gap"] = max(gaps["loop_gap"], leaf_gap(
                        name, outs[name][b], getattr(out, name), cell.config))
            nco = nco._replace(carrier_doppler=outs["carrier_doppler"][b],
                               carrier_phase=outs["carrier_phase"][b],
                               code_doppler=outs["code_doppler"][b],
                               code_phase=outs["code_phase"][b])
        for name, want in named_leaves("state", state):
            gaps["loop_gap"] = max(gaps["loop_gap"], leaf_gap(
                name, host(k.result, name), want, cell.config))
        wrong += any(gaps[name] > limits[name] for name in gaps)
        for name in gaps:
            widest[name] = max(widest[name], gaps[name])
    return {name: {"value": widest[name], "limit": limits[name]} for name in widest}, wrong


def accum_gap(ref, got: tuple, want: tuple, flips) -> float:
    """The widest gap of a block's accumulators, each after its ambiguous
    samples took their best sides (`explained_gap`), against the root mean
    square of the reference's."""
    want64 = torch.cat([w.double().flatten() for w in want])
    scale = float(torch.sqrt(torch.mean(want64 ** 2)))
    widest = float(ref.explained_gap(got, want, flips).max())
    if not (scale > 0 and math.isfinite(widest)):
        return NO_AGREEMENT
    return widest / scale
