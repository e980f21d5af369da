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
order, and closes the loop there once. That block body runs through
`tracking.graphs.scan`: on one card (every mesh device the same) it is one
CUDA graph replayed per block. The JAX package runs the loop closure
redundantly on every time shard, which only its SPMD model needs; here the
new phases and Dopplers are copied to the other time shards' devices at the
next block, a no-op where the device repeats. The code tables are built
once per call, and the signal is cut into contiguous per-shard pieces (once
per call for the eager loop, per block inside a captured body), so the loop
copies nothing from the host and never waits on a card.
"""

from __future__ import annotations

import functools

import torch

from ..ops.epl_kernels import BankChannels
from ..tracking import graphs
from ..tracking.state import _NESTED, TrackConfig, TrackOutput, TrackState
from ..tracking.track import _bank_code_tile_kwargs, bank_correlator, loop_update
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


def _mesh_step(config, corr, kwargs, advance, grid, pieces: list, shards: list):
    """The block body of the channel shards ``shards``: ``step(states,
    consts, block)``, ``states`` and ``consts`` their states and constants
    (per time shard, the code table and code tiles on its device), ``block``
    the signal pieces of one block, ``(re, im)`` per ``(device, time shard)``
    of ``pieces``. Each channel shard's time shards are correlated on their
    devices, their partials summed in order on its lead device, and its loop
    closed there once."""
    num_time = grid.shape[1]
    where = {key: i for i, key in enumerate(pieces)}

    def step(states, consts, block):
        new, outs = [], []
        for c, st, shard_consts in zip(shards, states, consts):
            lead = grid[c, 0]
            parts_re, parts_im = [], []
            for t in range(num_time):
                dev = grid[c, t]
                codes, code_tiles = shard_consts[t]
                sre, sim = block[where[dev, t]]
                with on_device(dev):
                    car_dop = st.carrier_doppler.to(dev, non_blocking=True)
                    code_dop = st.code_doppler.to(dev, non_blocking=True)
                    f_car = config.intermediate_frequency + car_dop
                    f_code = config.code_frequency + code_dop
                    phi_car, phi_code = advance(
                        st.carrier_phase.to(dev, non_blocking=True),
                        st.code_phase.to(dev, non_blocking=True), f_car, f_code, t)
                    prn = st.prn.to(dev, non_blocking=True)
                    if code_tiles is None:
                        are, aim = corr(
                            sre, sim, codes, prn, f_car, config.sampling_frequency, phi_car,
                            f_code, phi_code, config.sample_shifts, config.code_length,
                            **kwargs)
                    else:
                        # A bank kernel derives the parameters from the
                        # Dopplers and this shard's phases (the state form).
                        are, aim = corr(
                            sre, sim, codes, prn, None, config.sampling_frequency, None, None,
                            None, config.sample_shifts, config.code_length, **kwargs,
                            code_tiles=code_tiles, channels=BankChannels(
                                config.intermediate_frequency, car_dop, phi_car,
                                config.code_frequency, code_dop, phi_code))
                parts_re.append(are)
                parts_im.append(aim)
            with on_device(lead):
                st, out = loop_update(config, st, sum_in_order(parts_re, lead),
                                      sum_in_order(parts_im, lead))
            new.append(st)
            outs.append(out)
        return tuple(new), tuple(outs)

    return step


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

    The block body runs through `graphs.scan`: where every device of the
    mesh is one card, the whole mesh's block is one CUDA graph; on distinct
    cards with a time axis of 1, each channel shard replays a graph of its
    own on its own card, issued without waiting, so the cards overlap. A time
    axis over distinct cards exchanges partials between cards every block,
    and runs the eager loop.
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
    corr, kwargs = bank_correlator(config)
    grid = mesh.grid(chan_axis, time_axis)                # [chan shards, time shards]
    first = mesh.devices.flat[0]

    # The per-call constants: the code table per device, and each channel
    # shard's code tiles (built on its lead device, copied to its other time
    # shards').
    local = _channel_shards(states, num_chan, grid[:, 0])
    code_copies, consts = {}, []
    for c in range(num_chan):
        lead = grid[c, 0]
        with on_device(lead):
            tiles = _bank_code_tile_kwargs(
                config, _per_device(codes, code_copies, lead), local[c].prn).get("code_tiles")
        consts.append(tuple((_per_device(codes, code_copies, grid[c, t]),
                             None if tiles is None else tiles.to(grid[c, t]))
                            for t in range(num_time)))
    pieces = list(dict.fromkeys((dev, t) for t in range(num_time) for dev in grid[:, t]))
    key = ("track_bank_sharded", config, num_chan, num_time)

    def cut(shards, piece_keys):
        """The body over ``shards`` from one whole block on their one device:
        each time shard's piece is cut inside the body."""
        step = _mesh_step(config, corr, kwargs, advance, grid, piece_keys, shards)

        def body(carry, shard_consts, block):
            return step(carry, shard_consts, tuple(
                tuple(time_piece(x, t, num_time, dev) for x in block) for dev, t in piece_keys))

        return body

    if len({str(d) for d in mesh.devices.flat}) == 1:
        with on_device(first):
            final, outs = graphs.scan(
                cut(list(range(num_chan)), pieces), tuple(local),
                (signal_re.to(first), signal_im.to(first)), tuple(consts), key=key)
        finals, outs = list(final), list(outs)
    elif num_time == 1:
        finals, outs = [], []
        for c in range(num_chan):
            dev = grid[c, 0]
            with on_device(dev):
                final, out = graphs.scan(
                    cut([c], [(dev, 0)]), (local[c],),
                    (signal_re.to(dev), signal_im.to(dev)), (consts[c],), key=key)
            finals.append(final[0])
            outs.append(out[0])
    else:
        # Each shard's contiguous signal piece, cut once per call.
        xs = [time_piece(x, t, num_time, dev) for dev, t in pieces for x in (signal_re, signal_im)]
        step = _mesh_step(config, corr, kwargs, advance, grid, pieces, list(range(num_chan)))
        final, outs = graphs.loop(
            lambda carry, c_, block: step(carry, c_, tuple(zip(block[::2], block[1::2]))),
            tuple(local), tuple(xs), tuple(consts))
        finals, outs = list(final), list(outs)

    with on_device(first):
        final = _map_state(lambda *xs: _gather(xs, first, 0), *finals)
        return final, TrackOutput(*(_gather(xs, first, 1) for xs in zip(*outs)))


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
    reads whole. Each shard runs `tracking.dual.track_bank_dual` on its
    device, so on CUDA tensors each replays a CUDA graph of its own per
    block; on one card that is faster than one graph for every shard
    (`chip_smoke.py` phase L times both). The sample axis is not sharded,
    as in the JAX function. Returns the final states and the
    `DualTrackOutput` ``[B, K, ...]`` on the mesh's first device.
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
