"""Streaming tracking runtime: front-end IQ blocks -> channel bank on the card.

Port of `gpuacceleratedtracking_tpu.runtime.stream`. A deployed receiver runs
continuously: `StreamTracker` pulls fixed-size sample blocks from an IQ source
(`runtime.iq.IQFile` / `IQRing`), groups them into dispatch chunks, and
advances `tracking.track_bank` per chunk. The bank state stays on the device
between chunks.

On the card, each chunk is staged in a reused pinned host buffer and copied
to the device with ``non_blocking=True`` on a side stream, which the compute
stream waits on: the host goes on decoding the next chunk while the card
tracks this one (the counterpart of the JAX package's async dispatch).
`track_bank` replays its captured block body (`tracking.graphs`): the chunk's
copy into the graph's static buffers runs on the compute stream after that
wait, a short tail chunk replays the same graph (the block count is not in
its signature), and each chunk's outputs and state are views of one fresh
buffer per dtype, which stay on the device until `StreamResult.stacked`.
The state a chunk returns goes back into the next chunk's call in the
graph's own layout, so that call loads it as one copy per dtype.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..tracking.state import TrackOutput, TrackState, state_from_numpy, state_to_numpy
from ..tracking.track import track_bank
from . import iq as iq_mod

# Nested fields of a `TrackState`, in the order the JAX package flattens it.
_NESTED = ("pll_filter", "dll_filter", "cn0")


def _leaves(state: TrackState) -> list:
    """The state's arrays in JAX pytree order (`jax.tree.leaves`)."""
    out = []
    for name in TrackState._fields:
        value = getattr(state, name)
        out.extend(value if name in _NESTED else (value,))
    return out


def _unflatten(leaves: list, like: TrackState) -> TrackState:
    """A `TrackState` tree of ``leaves`` shaped like ``like``."""
    leaves = iter(leaves)
    fields = {}
    for name in TrackState._fields:
        value = getattr(like, name)
        if name in _NESTED:
            value = type(value)(*(next(leaves) for _ in value))
        else:
            value = next(leaves)
        fields[name] = value
    return TrackState(**fields)


@dataclasses.dataclass
class StreamResult:
    """Per-block observables accumulated over a streaming run."""

    outputs: list          # TrackOutput per chunk, [B, K] tensors on the device
    final_state: TrackState
    blocks_processed: int
    # Per-block wall time of each dispatch chunk (stacking + transfer + track
    # + fence), with ``measure_dispatch`` only. The first entry carries the
    # first-use set-up; `steady_block_s` (the median of the rest) is the
    # streaming rate.
    dispatch_block_s: list = dataclasses.field(default_factory=list)

    def stacked(self) -> TrackOutput:
        """The outputs of every block as ``[blocks, K]`` numpy arrays."""
        return TrackOutput(*(
            torch.cat([getattr(o, f) for o in self.outputs]).cpu().numpy()
            for f in TrackOutput._fields
        ))

    @property
    def steady_block_s(self) -> Optional[float]:
        # The first dispatch carries the first-use set-up: drop it, then take
        # the interpolating median of the rest.
        if not self.dispatch_block_s:
            return None
        rest = self.dispatch_block_s[1:]
        return statistics.median(rest) if rest else self.dispatch_block_s[0]


class StreamTracker:
    """Continuously track a channel bank over a block stream.

    The bank runs on the device of ``states`` (the card or the CPU).
    ``blocks_per_dispatch`` blocks are stacked and handed to `track_bank` at
    once; state carries over between dispatches.

    ``checkpoint_path``/``checkpoint_every`` enable periodic NCO-state
    snapshots, so an interrupted run resumes at block granularity. The file is
    the JAX package's format (``blocks_done`` and ``leaf_<i>`` in JAX pytree
    order, same dtypes), so either package resumes the other's file.

    ``measure_dispatch`` (default False) fences every dispatch chunk with a
    CUDA event to time it: benchmark instrumentation only. Left off, a chunk
    is queued without waiting on the card and `dispatch_block_s` stays empty.
    """

    def __init__(
        self,
        config,
        codes,
        states: TrackState,
        blocks_per_dispatch: int = 20,
        checkpoint_path=None,
        checkpoint_every: int = 200,
        measure_dispatch: bool = False,
    ):
        self.config = config
        self.device = states.prn.device
        self.codes = torch.as_tensor(codes, device=self.device)
        self.states = states
        self.blocks_per_dispatch = blocks_per_dispatch
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.measure_dispatch = measure_dispatch
        self._since_checkpoint = 0
        self._staging = None        # pinned (re, im) [blocks_per_dispatch, N]
        self._copy_stream = None
        self._copied = None         # event: the last copy out of the staging buffers

    def save_checkpoint(self, blocks_done: int) -> None:
        if self.checkpoint_path is None:
            return
        leaves = _leaves(state_to_numpy(self.states))
        np.savez(
            self.checkpoint_path,
            blocks_done=np.int64(blocks_done),
            **{f"leaf_{i}": v for i, v in enumerate(leaves)},
        )

    def load_checkpoint(self) -> int:
        """Restore states from the checkpoint; returns blocks already done."""
        with np.load(self.checkpoint_path) as data:
            leaves = [data[f"leaf_{i}"] for i in range(len(_leaves(self.states)))]
            blocks_done = int(data["blocks_done"])
        self.states = state_from_numpy(_unflatten(leaves, self.states), device=self.device)
        return blocks_done

    def _to_device(self, sre: np.ndarray, sim: np.ndarray):
        """``[B, N]`` host planes as tensors on the bank's device."""
        if self.device.type != "cuda":
            return torch.from_numpy(sre), torch.from_numpy(sim)
        b = sre.shape[0]
        if (self._staging is None or self._staging[0].shape[1] != sre.shape[1]
                or self._staging[0].shape[0] < b):
            shape = (max(self.blocks_per_dispatch, b), sre.shape[1])
            self._staging = tuple(torch.empty(shape, dtype=torch.float32, pin_memory=True)
                                  for _ in range(2))
            self._copy_stream = torch.cuda.Stream(self.device)
        if self._copied is not None:
            self._copied.synchronize()      # the last copy has left the buffers
        planes = []
        compute = torch.cuda.current_stream(self.device)
        for buf, host in zip(self._staging, (sre, sim)):
            buf[:b].numpy()[...] = host
            with torch.cuda.stream(self._copy_stream):
                planes.append(buf[:b].to(self.device, non_blocking=True))
        self._copied = self._copy_stream.record_event()
        compute.wait_event(self._copied)
        for plane in planes:
            plane.record_stream(compute)
        return planes

    def process(self, sre: np.ndarray, sim: np.ndarray) -> TrackOutput:
        """Process ``[B, N]`` blocks; returns per-block outputs ``[B, K]``."""
        self.states, out = track_bank(self.config, self.codes, self.states,
                                      *self._to_device(sre, sim))
        return out

    def run(self, source: Iterator, max_blocks: Optional[int] = None) -> StreamResult:
        """Drain an iterator of ``(re, im)`` block pairs (e.g. `blocks()`)."""
        n = self.config.num_samples
        chunk_re, chunk_im, outputs, processed = [], [], [], 0
        dispatch_block_s = []

        def dispatch():
            nonlocal processed
            b = len(chunk_re)
            t0 = time.perf_counter()
            out = self.process(np.stack(chunk_re), np.stack(chunk_im))
            if self.measure_dispatch:
                if self.device.type == "cuda":
                    # Benchmark-only fence: the host waits for the chunk.
                    torch.cuda.current_stream(self.device).record_event().synchronize()
                dispatch_block_s.append((time.perf_counter() - t0) / b)
            outputs.append(out)
            processed += b

        for re, im in source:
            if re.shape[-1] != n:
                break  # short tail block at EOF
            chunk_re.append(re)
            chunk_im.append(im)
            if len(chunk_re) == self.blocks_per_dispatch:
                dispatch()
                self._since_checkpoint += len(chunk_re)
                chunk_re, chunk_im = [], []
                if self._since_checkpoint >= self.checkpoint_every:
                    self.save_checkpoint(processed)
                    self._since_checkpoint = 0
            if max_blocks is not None and processed >= max_blocks:
                break
        if chunk_re:
            dispatch()
        return StreamResult(outputs, self.states, processed, dispatch_block_s)


def blocks(source: "iq_mod.IQFile", num_samples: int):
    """Iterate SoA blocks of ``num_samples`` from an IQ file until EOF."""
    while True:
        re, im = source.read(num_samples)
        if re.size == 0:
            return
        yield re, im


def track_file(
    config,
    codes,
    states: TrackState,
    path,
    fmt: str = "int8",
    scale: float = 1.0,
    blocks_per_dispatch: int = 20,
    max_blocks: Optional[int] = None,
) -> StreamResult:
    """Track a channel bank straight off a raw IQ capture file."""
    tracker = StreamTracker(config, codes, states, blocks_per_dispatch)
    with iq_mod.IQFile(path, fmt, scale) as f:
        return tracker.run(blocks(f, config.num_samples), max_blocks)
