"""Mesh-sharded multi-channel tracking: the distributed channel bank.

Port of `gpuacceleratedtracking_tpu.parallel.bank`. The channel bank is the
unit of scale, on a ``(chan, time)`` mesh where

- the **chan** axis shards satellite channels (data parallel: each channel
  shard's states live on its own device, no communication),
- the **time** axis shards each integration block's sample axis (replicas
  made per shard from phase-advanced NCOs, `parallel.correlate`; the partial
  ``[K_local, (A,) L]`` accumulators meet in one ordered sum per block).

One process drives every shard, block by block: for each block it issues
every shard's correlation on the shard's device (one kernel launch per shard
for a bank algorithm, so chan x time launches per block), sums each channel
shard's partials on its lead device (the shard at time index 0) in shard
order, and closes the loop there once. The JAX package runs the loop closure
redundantly on every time shard, which only its SPMD model needs; here the
new phases and Dopplers are copied to the other time shards' devices at the
next block, a no-op where the device repeats. The signal is cut into
contiguous per-shard pieces and the code tables are built once per call,
before the block loop, so the loop copies nothing from the host and never
waits on a card.
"""

from __future__ import annotations

import functools

import torch

from ..ops import registry
from ..tracking.state import _NESTED, TrackConfig, TrackOutput, TrackState
from ..tracking.track import (
    _CHANNEL_KERNELS,
    _bank_code_tile_kwargs,
    _bank_kernel_kwargs,
    _per_channel,
    _Stacked,
    loop_update,
)
from .correlate import (advance_phases, nominal_advance_tables, on_device, sum_in_order,
                        time_piece)
from .mesh import CHAN_AXIS, TIME_AXIS, Mesh

def _map_state(fn, *states: TrackState) -> TrackState:
    """``fn`` applied leaf by leaf across ``states`` (``jax.tree.map``)."""
    fields = {}
    for name in TrackState._fields:
        values = [getattr(s, name) for s in states]
        if name in _NESTED:
            fields[name] = type(values[0])(*(fn(*leaves) for leaves in zip(*values)))
        else:
            fields[name] = fn(*values)
    return TrackState(**fields)


def _channel_shards(states: TrackState, num_chan: int, devices) -> list:
    """``states`` cut along the channel axis, shard ``c`` on ``devices[c]``."""
    per = states.prn.shape[0] // num_chan
    return [_map_state(lambda x: x[c * per:(c + 1) * per].to(devices[c]), states)
            for c in range(num_chan)]


def _gather(parts: list, device: torch.device, dim: int):
    """Per-shard tensors joined along ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _per_device(x: torch.Tensor, cache: dict, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, copied once per call and device."""
    if device not in cache:
        cache[device] = x.to(device)
    return cache[device]


def track_bank_sharded(
    config: TrackConfig,
    codes: torch.Tensor,
    states: TrackState,
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    *,
    mesh: Mesh,
    chan_axis: str = CHAN_AXIS,
    time_axis: str = TIME_AXIS,
) -> tuple[TrackState, TrackOutput]:
    """Track a K-channel bank over ``[B, N]`` / ``[B, A, N]`` blocks on a mesh.

    ``states`` leaves carry a leading ``[K]`` axis, cut over ``chan_axis``;
    the shared front-end signal is cut over ``time_axis`` on its sample axis
    and shared by every channel shard. A signal with ``A > 1`` antennas is
    summed uniformly over them, as in the JAX function (which takes no
    steering weights). Runs every algorithm that `track_bank` runs, as it
    runs it. Returns the final states and the per-block outputs
    ``[B, K, ...]``, on the mesh's first device.
    """
    num_chan = mesh.shape[chan_axis]
    num_time = mesh.shape[time_axis]
    num_k = states.prn.shape[0]
    num_samples = signal_re.shape[-1]
    if num_k % num_chan:
        raise ValueError(f"K={num_k} not divisible by {num_chan} channel shards")
    if num_samples % num_time:
        raise ValueError(f"N={num_samples} not divisible by {num_time} time shards")
    if num_samples != config.num_samples:
        raise ValueError("signal block length != config.num_samples")
    local_n = num_samples // num_time
    tables = nominal_advance_tables(
        config.intermediate_frequency, config.code_frequency,
        config.sampling_frequency, local_n, num_time, config.code_length,
    )
    advance = functools.partial(
        advance_phases, tables=tables,
        nominal_carrier_frequency=config.intermediate_frequency,
        nominal_code_frequency=config.code_frequency,
        sampling_frequency=config.sampling_frequency,
        samples_per_shard=local_n, code_length=config.code_length,
    )
    corr = registry.get(config.algorithm)
    if config.algorithm in _CHANNEL_KERNELS:
        corr = functools.partial(_per_channel, corr)
    kwargs = _bank_kernel_kwargs(config)
    grid = mesh.grid(chan_axis, time_axis)                # [chan shards, time shards]
    first = mesh.devices.flat[0]

    # Everything the block loop reads, made once: each shard's contiguous
    # signal piece, the code table per device, and each channel shard's code
    # tiles (built on its lead device, copied to its other time shards').
    sig_re, sig_im, code_copies = {}, {}, {}
    for t in range(num_time):
        for dev in grid[:, t]:
            if (dev, t) not in sig_re:
                sig_re[dev, t] = time_piece(signal_re, t, num_time, dev)
                sig_im[dev, t] = time_piece(signal_im, t, num_time, dev)
    local = _channel_shards(states, num_chan, grid[:, 0])
    shard_kwargs = []
    for c in range(num_chan):
        lead = grid[c, 0]
        with on_device(lead):
            tiles = _bank_code_tile_kwargs(
                config, _per_device(codes, code_copies, lead), local[c].prn)
        per_t = []
        for t in range(num_time):
            kw = dict(kwargs)
            kw.update({k: v.to(grid[c, t]) for k, v in tiles.items()})
            per_t.append(kw)
        shard_kwargs.append(per_t)

    num_blocks = signal_re.shape[0]
    outs = [_Stacked(num_blocks) for _ in range(num_chan)]
    for b in range(num_blocks):
        for c in range(num_chan):
            st, lead = local[c], grid[c, 0]
            parts_re, parts_im = [], []
            for t in range(num_time):
                dev = grid[c, t]
                with on_device(dev):
                    f_car = (config.intermediate_frequency
                             + st.carrier_doppler.to(dev, non_blocking=True))
                    f_code = config.code_frequency + st.code_doppler.to(dev, non_blocking=True)
                    phi_car, phi_code = advance(
                        st.carrier_phase.to(dev, non_blocking=True),
                        st.code_phase.to(dev, non_blocking=True), f_car, f_code, t)
                    are, aim = corr(
                        sig_re[dev, t][b], sig_im[dev, t][b],
                        _per_device(codes, code_copies, dev),
                        st.prn.to(dev, non_blocking=True), f_car,
                        config.sampling_frequency, phi_car, f_code, phi_code,
                        config.sample_shifts, config.code_length, **shard_kwargs[c][t],
                    )
                parts_re.append(are)
                parts_im.append(aim)
            with on_device(lead):
                local[c], out = loop_update(config, st, sum_in_order(parts_re, lead),
                                            sum_in_order(parts_im, lead))
            outs[c].put(b, out)

    with on_device(first):
        final = _map_state(lambda *xs: _gather(xs, first, 0), *local)
        fields = zip(*(o.result() for o in outs))
        return final, TrackOutput(*(_gather(xs, first, 1) for xs in fields))


def track_bank_dual_sharded(
    config: TrackConfig,
    codes_data: torch.Tensor,
    codes_pilot: torch.Tensor,
    states: TrackState,
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    *,
    mesh: Mesh,
    chan_axis: str = CHAN_AXIS,
):
    """Mesh-sharded GPS L5 dual-component bank: channel data parallelism.

    K dual channels (each a data + pilot pair, so 2K_local bank channels per
    shard's launch) are cut over ``chan_axis`` with no communication: dual
    channels are independent given the shared front end, which every shard
    reads whole. `tracking.dual.track_bank_dual` runs whole on each shard's
    device. The sample axis is not sharded, as in the JAX function. Returns
    the final states and the `DualTrackOutput` ``[B, K, ...]`` on the mesh's
    first device.
    """
    from ..tracking.dual import DualTrackOutput, track_bank_dual

    num_chan = mesh.shape[chan_axis]
    num_k = states.prn.shape[0]
    if num_k % num_chan:
        raise ValueError(f"K={num_k} not divisible by {num_chan} chan shards")
    devices = mesh.grid(chan_axis)
    first = mesh.devices.flat[0]
    local = _channel_shards(states, num_chan, devices)
    copies = {name: {} for name in ("data", "pilot", "re", "im")}
    finals, outs = [], []
    for c in range(num_chan):
        dev = devices[c]
        with on_device(dev):
            final, out = track_bank_dual(
                config, _per_device(codes_data, copies["data"], dev),
                _per_device(codes_pilot, copies["pilot"], dev), local[c],
                _per_device(signal_re, copies["re"], dev),
                _per_device(signal_im, copies["im"], dev))
        finals.append(final)
        outs.append(out)
    with on_device(first):
        final = _map_state(lambda *xs: _gather(xs, first, 0), *finals)
        pilot = TrackOutput(*(_gather(xs, first, 1) for xs in zip(*(o.pilot for o in outs))))
        return final, DualTrackOutput(
            pilot,
            _gather([o.data_prompt_re for o in outs], first, 1),
            _gather([o.data_prompt_im for o in outs], first, 1),
        )
