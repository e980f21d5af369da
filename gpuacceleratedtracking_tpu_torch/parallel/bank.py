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
once per call, so the loop copies nothing from the host and never waits on
a card.

On the bank kernels' routes (`tracking.track._takes_tiles`) a block is the
kernels alone, as the JAX `shard_map` body is one program: per (chan, time)
shard one bank launch in the state form with the shard's
`ops.epl_kernels.BankShard`, which advances the state's phases to its piece
and reads the piece of the block in place (in a capture, at the entry's
device-side index); per channel shard one finish, which adds its time
shards' partials in shard order (`ops.epl_kernels.ShardSum`), and one
loop-closure kernel, which writes that shard's outputs and carry through
the entry's sink; then the entry's index add. Other correlators cut each
shard's piece and advance its phases with torch ops, and their loop
closure returns its outputs.
"""

from __future__ import annotations

import functools

import torch

from ..ops.epl_kernels import BankChannels, ShardSum
from ..tracking import graphs
from ..tracking.state import _NESTED, TrackConfig, TrackOutput, TrackState
from ..tracking.track import (_bank_code_tile_kwargs, _takes_tiles, bank_correlator,
                              loop_update)
from .correlate import (advance_phases, nominal_advance_tables, on_device, sum_in_order,
                        time_piece, time_shard)
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
    """The block body of the channel shards ``shards`` for a correlator that
    takes no code tiles: ``step(states, consts, block)``, ``states`` and
    ``consts`` their states and constants (per time shard, the code table
    on its device and None), ``block`` the signal pieces of one block,
    ``(re, im)`` per ``(device, time shard)`` of ``pieces``. Each channel
    shard's time shards are correlated on their devices from phases
    advanced to their pieces, their partials summed in order on its lead
    device, and its loop closed there once."""
    num_time = grid.shape[1]
    where = {key: i for i, key in enumerate(pieces)}

    def step(states, consts, block):
        new, outs = [], []
        for c, st, shard_consts in zip(shards, states, consts):
            lead = grid[c, 0]
            parts_re, parts_im = [], []
            for t in range(num_time):
                dev = grid[c, t]
                codes, _ = shard_consts[t]
                sre, sim = block[where[dev, t]]
                with on_device(dev):
                    f_car = config.intermediate_frequency + st.carrier_doppler.to(
                        dev, non_blocking=True)
                    f_code = config.code_frequency + st.code_doppler.to(dev, non_blocking=True)
                    phi_car, phi_code = advance(
                        st.carrier_phase.to(dev, non_blocking=True),
                        st.code_phase.to(dev, non_blocking=True), f_car, f_code, t)
                    are, aim = corr(
                        sre, sim, codes, st.prn.to(dev, non_blocking=True), f_car,
                        config.sampling_frequency, phi_car, f_code, phi_code,
                        config.sample_shifts, config.code_length, **kwargs)
                parts_re.append(are)
                parts_im.append(aim)
            with on_device(lead):
                st, out = loop_update(config, st, sum_in_order(parts_re, lead),
                                      sum_in_order(parts_im, lead))
            new.append(st)
            outs.append(out)
        return tuple(new), tuple(outs)

    return step


def _bank_step(config, corr, kwargs, grid, shards: list, time_shards: list,
               pieces: list | None = None, per: int | None = None):
    """The block body of the channel shards ``shards`` for a bank kernel,
    as the JAX `shard_map` body: ``step(states, consts, block, sink=None)``,
    ``states`` and ``consts`` their states and constants (per time shard,
    the code table and code tiles on its device). ``block`` is one whole
    block on the mesh's one device (a `graphs.Chunk` in a capture: the
    kernels read it at the entry's index), or, with ``pieces``, each
    ``(device, time shard)``'s ``(re, im)`` piece in their order;
    ``time_shards[t]`` is time shard t's `BankShard`, its piece's offset in
    what the body reads. Each (chan, time) shard is one bank launch in the
    state form, which advances the shard's phases and reads its piece in
    place; each channel shard's time shards meet in one `ShardSum` on its
    lead device, whose finish adds them in shard order; its loop is closed
    there, through its part of the entry's sink in a capture (the loop
    kernel writes its outputs and carry in place). No torch op runs between
    the carry and the kernels.

    ``states`` is a tuple of the shards' states and the outputs a tuple of
    their outputs; with ``per`` (every shard on one device), ``states`` is
    the whole bank's, channel shard c its ``per`` channels from ``c * per``
    (contiguous views, which the loop kernels write in place), and the
    outputs are the whole bank's, each shard's loop kernel writing its
    columns of the sink's rows (`graphs.Sink.channel_window`): the call cuts
    and joins nothing."""
    num_time = grid.shape[1]
    where = None if pieces is None else {key: i for i, key in enumerate(pieces)}
    num_out = len(TrackOutput._fields)

    def own_sink(sink, i, c):
        if sink is None or per is None:
            return None if sink is None else graphs.Sink(
                sink.outs[i * num_out:(i + 1) * num_out], sink.index)
        return sink.channel_window(c * per, len(shards) * per)

    @graphs.writes_outputs
    def step(states, consts, block, sink=None):
        signal, index = ((block.xs, block.index) if isinstance(block, graphs.Chunk)
                         else (block, None))
        parts = states if per is None else [
            _map_state(lambda x: x[c * per:(c + 1) * per], states) for c in shards]
        new, outs = [], []
        for i, (c, st, shard_consts) in enumerate(zip(shards, parts, consts)):
            lead = grid[c, 0]
            total = ShardSum(num_time, lead)
            for t in range(num_time):
                dev = grid[c, t]
                codes, code_tiles = shard_consts[t]
                sre, sim = signal if where is None else signal[where[dev, t]]
                with on_device(dev):
                    car_dop, car_ph, code_dop, code_ph, prn = (
                        x.to(dev, non_blocking=True) for x in (
                            st.carrier_doppler, st.carrier_phase, st.code_doppler,
                            st.code_phase, st.prn))
                    corr(sre, sim, codes, prn, None, config.sampling_frequency, None, None, None,
                         config.sample_shifts, config.code_length, **kwargs,
                         code_tiles=code_tiles, block_index=index, shard_sum=total,
                         channels=BankChannels(config.intermediate_frequency, car_dop, car_ph,
                                               config.code_frequency, code_dop, code_ph,
                                               time_shards[t]))
            with on_device(lead):
                st, out = loop_update(config, st, *total.finish(), None, own_sink(sink, i, c))
            new.append(st)
            outs.append(out)
        if per is None:
            return tuple(new), tuple(outs)
        if sink is not None:                 # every shard wrote its part in place
            return states, outs[0]
        return (_map_state(lambda *xs: torch.cat(xs), *new),
                TrackOutput(*(torch.cat(xs) for xs in zip(*outs))))

    return graphs.reads_chunk(step)


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
    and runs the eager loop. On the bank kernels' routes a replayed block is
    ``chan x time`` bank launches, ``chan`` finishes, ``chan`` loop kernels
    and the index's add (see the module).
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
    per = num_k // num_chan
    code_copies, consts = {}, []
    for c in range(num_chan):
        lead = grid[c, 0]
        with on_device(lead):
            tiles = _bank_code_tile_kwargs(
                config, _per_device(codes, code_copies, lead),
                states.prn[c * per:(c + 1) * per].to(lead)).get("code_tiles")
        consts.append(tuple((_per_device(codes, code_copies, grid[c, t]),
                             None if tiles is None else tiles.to(grid[c, t]))
                            for t in range(num_time)))
    pieces = list(dict.fromkeys((dev, t) for t in range(num_time) for dev in grid[:, t]))
    tiles = _takes_tiles(config)
    # Each time shard as a bank call takes it: its piece in the whole block,
    # or a piece of its own (offset 0).
    shard_args = (tables, config.sampling_frequency, local_n, config.code_length)
    in_block = [time_shard(t, *shard_args) for t in range(num_time)]
    in_piece = [time_shard(t, *shard_args, offset=0) for t in range(num_time)]

    def cut(shards, piece_keys):
        """The body over ``shards`` from one whole block on their one device
        for a correlator that takes no tiles: each time shard's piece is cut
        inside the body."""
        step = _mesh_step(config, corr, kwargs, advance, grid, piece_keys, shards)

        def body(carry, shard_consts, block):
            return step(carry, shard_consts, tuple(
                tuple(time_piece(x, t, num_time, dev) for x in block) for dev, t in piece_keys))

        return body

    one_device = len({str(d) for d in mesh.devices.flat}) == 1
    if one_device and tiles:
        # A bank kernel on one device: the carry and the outputs are the
        # whole bank's, each channel shard its contiguous part of them.
        with on_device(first):
            return graphs.scan(
                _bank_step(config, corr, kwargs, grid, list(range(num_chan)), in_block,
                           per=per),
                states if states.prn.device == first else _map_state(
                    lambda x: x.to(first), states),
                (signal_re.to(first), signal_im.to(first)), tuple(consts),
                key=("track_bank_sharded", config, num_chan, num_time))
    local = _channel_shards(states, num_chan, grid[:, 0])
    if one_device:
        with on_device(first):
            final, outs = graphs.scan(
                cut(list(range(num_chan)), pieces), tuple(local),
                (signal_re.to(first), signal_im.to(first)), tuple(consts),
                key=("track_bank_sharded", config, num_chan, num_time))
        finals, outs = list(final), list(outs)
    elif num_time == 1:
        finals, outs = [], []
        for c in range(num_chan):
            dev = grid[c, 0]
            with on_device(dev):
                final, out = graphs.scan(
                    _bank_step(config, corr, kwargs, grid, [c], in_block) if tiles
                    else cut([c], [(dev, 0)]), (local[c],),
                    (signal_re.to(dev), signal_im.to(dev)), (consts[c],),
                    key=("track_bank_sharded", config, num_chan, num_time, c))
            finals.append(final[0])
            outs.append(out[0])
    else:
        # Each shard's contiguous signal piece, cut once per call.
        xs = [time_piece(x, t, num_time, dev) for dev, t in pieces for x in (signal_re, signal_im)]
        step = (_bank_step(config, corr, kwargs, grid, list(range(num_chan)), in_piece, pieces)
                if tiles else
                _mesh_step(config, corr, kwargs, advance, grid, pieces, list(range(num_chan))))
        final, outs = graphs.loop(
            lambda carry, c_, block: step(carry, c_, tuple(zip(block[::2], block[1::2]))),
            tuple(local), tuple(xs), tuple(consts))
        finals, outs = list(final), list(outs)

    with on_device(first):
        final = _map_state(lambda *xs: _gather(xs, first, 0), *finals)
        return final, TrackOutput(*(_gather(xs, first, 1) for xs in zip(*outs)))


def _dual_one_graph(config, codes_data, codes_pilot, shards: list, signal_re, signal_im,
                    num_chan: int):
    """The channel shards ``shards`` (states on one device) of the dual bank
    as one `graphs.scan`: each block runs every shard's
    `tracking.dual.dual_parts` body in turn, each with the entry's chunk and
    its part of the sink where its body takes them, after one prologue of
    every shard's ``prepare``. Returns each shard's final state and
    `DualTrackOutput`."""
    from ..tracking.dual import DualTrackOutput, dual_parts

    device = signal_re.device
    parts = [dual_parts(config, codes_data, codes_pilot, device) for _ in shards]
    steps, consts, prepares = zip(*parts)
    num_out = len(TrackOutput._fields) + len(DualTrackOutput._fields) - 1
    chunked = getattr(steps[0], "takes_chunk", False)

    @graphs.writes_outputs
    def step(carry, shard_consts, block, sink=None):
        res = [body(st, c, block) if sink is None else body(
                   st, c, block, graphs.Sink(sink.outs[i * num_out:(i + 1) * num_out], sink.index))
               for i, (body, st, c) in enumerate(zip(steps, carry, shard_consts))]
        return tuple(r[0] for r in res), tuple(r[1] for r in res)

    def prepare(carry, shard_consts, into=None):
        return tuple(
            fn(st, c) if into is None else fn(st, c, graphs.Into(into.prepared[i], into.index))
            for i, (fn, st, c) in enumerate(zip(prepares, carry, shard_consts)))

    if getattr(prepares[0], "takes_into", False):
        prepare = graphs.writes_prepared(prepare)
    return graphs.scan(graphs.reads_chunk(step) if chunked else step, tuple(shards),
                       (signal_re, signal_im), tuple(consts),
                       key=("track_bank_dual_sharded", config, num_chan), prepare=prepare)


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
    reads whole. Where every mesh device is one card, one captured program
    runs every shard's `tracking.dual.track_bank_dual` body per block
    (`_dual_one_graph`): on an NVIDIA H100 80GB HBM3 at 700 W, in two calls
    of ten rounds of turns at K=64 GPS L5, N=32768, 10-block calls
    (`block_ab.py --dual`), one graph won 10 and 9 rounds of 10 at chan 4
    (0.230 and 0.141 ms per block against 0.311 and 0.172 for a graph per
    shard) and 7 and 5 of 10 at chan 2 (0.140 and 0.115 against 0.170 and
    0.117): faster at chan 4, no slower at chan 2. On distinct
    cards each shard runs `track_bank_dual` on its own card, a graph of its
    own, so the cards overlap. The sample axis is not sharded, as in the JAX
    function. Returns the final states and the `DualTrackOutput` ``[B, K,
    ...]`` on the mesh's first device.
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
    if len({str(d) for d in mesh.devices.flat}) == 1:
        with on_device(first):
            finals, outs = _dual_one_graph(
                config, codes_data.to(first), codes_pilot.to(first), local,
                signal_re.to(first), signal_im.to(first), num_chan)
        finals, outs = list(finals), list(outs)
    else:
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
