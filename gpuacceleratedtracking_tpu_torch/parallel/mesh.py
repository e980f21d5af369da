"""Device meshes for the distributed tracking axes.

Port of `gpuacceleratedtracking_tpu.parallel.mesh`. The JAX package lays its
devices on a `jax.sharding.Mesh` and runs each shard under `shard_map`; here a
`Mesh` is a named grid of `torch.device`s, and the sharded functions run every
shard from one controlling process, each shard's work issued on its own
device (`parallel.correlate`, `parallel.bank`). The three axes:

- ``chan``: satellite channels (data parallel: no communication),
- ``time``: the sample axis of one integration block (one sum of the tiny
  ``[K, (A,) L]`` partial accumulators per block, in shard order),
- ``ant``: antennas (a sum over antenna shards when beamforming).

A device may appear more than once: ``[torch.device("cpu")] * 8`` is the CPU
counterpart of JAX's ``--xla_force_host_platform_device_count=8``, and
``[cuda:0] * 4`` puts four shards' kernels on one card.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import device as _device

CHAN_AXIS = "chan"
TIME_AXIS = "time"
ANT_AXIS = "ant"


def _as_device(d) -> torch.device:
    """``d`` as a `torch.device` with an index for a CUDA device, so shards
    compare equal to the device their tensors report."""
    d = _device.resolve(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device; raises `RuntimeError` where there is none.
    There is no CPU fallback: a CPU mesh names its devices."""
    _device.resolve("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s fields).

    ``devices`` is an object ndarray of `torch.device` shaped by the axis
    sizes; ``shape[axis]`` is the size of ``axis``.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid needs as many axis "
                             f"names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def grid(self, *axes: Optional[str]) -> np.ndarray:
        """The devices along ``axes`` (an ndarray indexed by their shard
        indices, in that order), at index 0 along every other axis: a shard
        is replicated over the axes that do not cut its data, and one
        controller runs each replica once. An axis of ``None`` has size 1."""
        for axis in axes:
            if axis is not None and axis not in self.shape:
                raise KeyError(f"mesh axes are {self.axis_names}, not {axis!r}")
        index = tuple(slice(None) if name in axes else 0 for name in self.axis_names)
        sub = self.devices[index]
        kept = [name for name in self.axis_names if name in axes]
        order = [kept.index(axis) for axis in axes if axis is not None]
        sub = np.transpose(sub, order) if order else np.asarray(sub, dtype=object)
        shape = tuple(self.shape[axis] if axis is not None else 1 for axis in axes)
        return sub.reshape(shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(
    axis_sizes: Mapping[str, int],
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh with the given ``{axis_name: size}`` layout.

    ``devices``: `torch.device`s or their names, repeats allowed; ``None``
    takes every visible CUDA device and raises `RuntimeError` where there is
    none. Raises `ValueError` when the sizes need more devices than given.
    """
    devices = visible_devices() if devices is None else [_as_device(d) for d in devices]
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    total = int(np.prod(sizes)) if sizes else 1
    if total > len(devices):
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {total} devices, have {len(devices)}"
        )
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(sizes), names)


def channel_time_mesh(
    num_chan_shards: Optional[int] = None,
    num_time_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """The production layout: channels x time blocks.

    With only ``num_time_shards`` given, all remaining devices go to the
    channel axis (channels need no communication, so they take whatever
    parallelism is left after the time axis is sized for latency).
    """
    devices = visible_devices() if devices is None else list(devices)
    if num_chan_shards is None:
        num_chan_shards = len(devices) // num_time_shards
    return make_mesh(
        {CHAN_AXIS: num_chan_shards, TIME_AXIS: num_time_shards}, devices
    )
