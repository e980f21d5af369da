"""Mesh-sharded multi-channel tracking: the distributed channel bank.

Port of `gpuacceleratedtracking_tpu.parallel.bank`. The channel bank is the
unit of scale, on a ``(chan, time)`` mesh where

- the **chan** axis shards satellite channels (data parallel: each channel
  shard's states live on its own device, no communication),
- the **time** axis shards each integration block's sample axis (replicas
  made per shard from phase-advanced NCOs, `parallel.correlate`; the partial
  ``[K_local, (A,) L]`` accumulators meet in one ordered sum per block).

One process drives every shard. On the bank kernels' routes
(`tracking.track._takes_tiles`) a block is the kernels alone, as the JAX
`shard_map` body is one program: per (chan, time) shard one bank launch in
the state form with the shard's `ops.epl_kernels.BankShard`, which advances
the state's phases to its piece and reads the piece of the block in place
(in a capture, at the entry's device-side index); the time shards of a
channel shard meet in one `ops.epl_kernels.ShardSum`, whose finish adds
them in shard order; one loop-closure kernel per channel shard then writes
its outputs and carry through the entry's sink.

- Where every mesh device is one card, the carry and the outputs are the
  whole bank's (channel shard c a contiguous view of them, its loop kernel
  writing its columns of the outputs), the code tiles of the whole bank are
  packed by one launch in the call's prologue, and a block is one replayed
  CUDA graph: the call cuts and joins nothing (`_bank_step`).
- On distinct cards the call is `tracking.graphs.scan_mesh`: each card holds
  its channel shard's carry for the whole call (loaded in one copy per
  dtype from a cut of the caller's states on the mesh's first card,
  `_stage_channels`), packs its shard's code tiles in its own prologue and
  reads its own signal (whole where time is 1, its piece where it is more);
  per block every (chan, time) card launches its bank kernel, its partials
  go to every card of its channel shard, and every card closes the loop on
  its own replica of the carry, redundantly but identically, as the JAX
  package does after its ``psum``: no carry crosses cards inside a call
  (`_card_step`). On the cards each channel shard's block is one CUDA graph
  over its time shards' cards, replayed once per block. The results of each channel shard's time-0 card come back to the first
  card in one copy per dtype, and one gather per dtype lays them out as an
  unsharded call's (`_join_channels`).

Other correlators (`pallas_fused`, `pallas_taps`, `fused_xla`,
`unfused_xla`, `xla_bank`) advance each time shard's phases with torch ops
(`parallel.correlate.advance_phases`) and correlate its piece with the
bank's correlator (K_local launches of a per-channel kernel).

- Where every mesh device is one card, one `graphs.scan` runs every channel
  shard's body: each shard's piece is cut inside the block, the partials
  summed in order on the shard's lead device and the loop closed there once,
  its loop closure returning its outputs (`_mesh_step`).
- On distinct cards the call is the bank routes' `graphs.scan_mesh`, with
  the body `_card_step_without_tiles`: each card advances its own replica of
  the carry to its piece and correlates it, every card's partials go to
  every card of its channel shard after every card's correlator is
  launched, and every card adds them in shard order and closes the loop on
  its replica through its sink.
"""

from __future__ import annotations

import functools

import torch

from ..ops.epl_kernels import BankChannels, ShardSum
from ..tracking import graphs
from ..tracking.state import _NESTED, TrackConfig, TrackOutput, TrackState
from ..tracking.track import _takes_tiles, bank_correlator, bank_prepare, loop_update
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


def _stage_channels(states, num_chan: int, device: torch.device) -> list:
    """The cut of ``states`` (a tree of ``[K, ...]`` leaves) into ``num_chan``
    channel shards on ``device``: each shard's leaves as views of one buffer
    per dtype of its own, laid out as `graphs._layout` lays them out (as a
    card's entry lays out its carry, so that the card loads it in one copy
    per dtype), all filled by one multi-tensor copy per pair of dtypes."""
    leaves = graphs._leaves(states)
    per = leaves[0].shape[0] // num_chan
    sizes, places = graphs._layout(tuple(((per,) + tuple(x.shape[1:]), x.dtype)
                                         for x in leaves))
    shards = [graphs._views({dtype: torch.empty(size, dtype=dtype, device=device)
                             for dtype, size in sizes}, places) for _ in range(num_chan)]
    graphs._copy([x for shard in shards for x in shard],
                 [x[c * per:(c + 1) * per] for c in range(num_chan) for x in leaves])
    return [graphs._rebuild(states, iter(shard)) for shard in shards]


def _join_index(specs: tuple, num_carry: int, num_chan: int, device: torch.device) -> tuple:
    """Where each element of an unsharded call's results comes from in the
    channel shards' results laid end to end, one buffer per dtype (shard c's
    `graphs._layout` of ``specs`` at ``c`` times its size): an index per
    dtype on ``device`` (int32 where the shards' elements allow it;
    alignment gaps read element 0), and the unsharded results' places in
    their layout. The first ``num_carry`` leaves join along axis 0 (the
    carry), the rest along axis 1 (outputs stacked ``[B, K, ...]``)."""
    sizes, places = graphs._layout(specs)
    size = dict(sizes)
    origin = graphs._views({dtype: torch.arange(n, dtype=torch.int64) for dtype, n in sizes},
                           places)
    whole = [torch.cat([x + c * size[dtype] for c in range(num_chan)], 0 if i < num_carry else 1)
             for i, (x, (_, dtype)) in enumerate(zip(origin, specs))]
    whole_sizes, whole_places = graphs._layout(tuple((tuple(x.shape), dtype)
                                                     for x, (_, dtype) in zip(whole, specs)))
    index = {dtype: torch.zeros(n, dtype=torch.int32 if num_chan * size[dtype] < 2 ** 31
                                else torch.int64) for dtype, n in whole_sizes}
    for view, x in zip(graphs._views(index, whole_places), whole):
        view.copy_(x)
    return {dtype: x.to(device) for dtype, x in index.items()}, whole_places


def _join_channels(results: list, device: torch.device):
    """The channel shards' ``(final state, stacked outputs)`` (each on its
    card) as an unsharded call's on ``device``: each shard's results, one
    buffer per dtype (`graphs._flat`), copied to ``device`` in one copy per
    dtype, end to end, and one gather per dtype (`_join_index`, kept per
    layout as the graph entries are: `graphs.kept`) lays them out as
    `graphs.scan` lays out a call's results: the final state and outputs as
    views of one fresh buffer per dtype."""
    num_carry = len(graphs._leaves(results[0][0]))
    cards = [graphs._leaves(result) for result in results]
    specs = graphs._specs(cards[0])
    sizes, _ = graphs._layout(specs)
    stage = {dtype: torch.empty(len(cards) * size, dtype=dtype, device=device)
             for dtype, size in sizes}
    for c, leaves in enumerate(cards):
        for dtype, region in graphs._flat(leaves)[0].items():
            stage[dtype][c * region.numel():(c + 1) * region.numel()].copy_(region)
    index, whole_places = graphs.kept(
        device, ("join", specs, num_carry, len(cards)),
        lambda: _join_index(specs, num_carry, len(cards), device))
    joined = {dtype: torch.index_select(stage[dtype], 0, index[dtype]) for dtype in stage}
    return graphs._rebuild(results[0], iter(graphs._views(joined, whole_places)))


def _per_device(x: torch.Tensor, cache: dict, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, copied once per call and device."""
    if device not in cache:
        cache[device] = x.to(device)
    return cache[device]


def _mesh_step(config, corr, kwargs, advance, num_time: int):
    """The block body of every channel shard on one device for a correlator
    that takes no code tiles: ``step(states, codes, block)``, ``states`` the
    channel shards' states, ``block`` one whole block. Each time shard's
    piece is cut (`time_piece`) and correlated from phases advanced to it,
    each channel shard's partials summed in shard order and its loop closed
    once; the loop closure returns its outputs."""

    def step(states, codes, block):
        device = block[0].device
        pieces = [tuple(time_piece(x, t, num_time, device) for x in block)
                  for t in range(num_time)]
        new, outs = [], []
        for st in states:
            parts_re, parts_im = [], []
            for t, (sre, sim) in enumerate(pieces):
                f_car = config.intermediate_frequency + st.carrier_doppler
                f_code = config.code_frequency + st.code_doppler
                phi_car, phi_code = advance(st.carrier_phase, st.code_phase, f_car, f_code, t)
                are, aim = corr(sre, sim, codes, st.prn, f_car, config.sampling_frequency,
                                phi_car, f_code, phi_code, config.sample_shifts,
                                config.code_length, **kwargs)
                parts_re.append(are)
                parts_im.append(aim)
            st, out = loop_update(config, st, sum_in_order(parts_re, device),
                                  sum_in_order(parts_im, device))
            new.append(st)
            outs.append(out)
        return tuple(new), tuple(outs)

    return step


def _bank_step(config, corr, kwargs, grid, time_shards: list, per: int):
    """The block body of a bank kernel with every shard on one device, as
    the JAX `shard_map` body: ``step(states, (codes, code_tiles, None),
    block, sink=None)``, ``states`` and ``code_tiles`` (`track.bank_prepare`'s
    constants, the prologue's packing of the whole bank's tiles) the whole
    bank's, channel shard c its ``per`` channels from ``c * per``
    (contiguous views, which the loop kernels write in place, and rows of
    the tiles). ``block`` is one whole block (a `graphs.Chunk` in a
    capture: the kernels read it at the entry's index); ``time_shards[t]``
    is time shard t's `BankShard`. Each (chan, time) shard is one bank
    launch in the state form, which advances the shard's phases and reads
    its piece in place; each channel shard's time shards meet in one
    `ShardSum`, whose finish adds them in shard order; its loop is closed
    there, through its channel window of the entry's sink in a capture
    (`graphs.Sink.channel_window`: the loop kernel writes its columns of the
    whole bank's rows and its carry in place). No torch op runs between the
    carry and the kernels, and the call cuts and joins nothing."""
    num_chan, num_time = grid.shape
    device = grid[0, 0]

    @graphs.writes_outputs
    def step(states, consts, block, sink=None):
        codes, code_tiles, _ = consts
        signal, index = ((block.xs, block.index) if isinstance(block, graphs.Chunk)
                         else (block, None))
        new, outs = [], []
        for c in range(num_chan):
            rows = slice(c * per, (c + 1) * per)
            st = _map_state(lambda x: x[rows], states)
            total = ShardSum(num_time, device)
            with on_device(device):
                for t in range(num_time):
                    corr(signal[0], signal[1], codes, st.prn, None, config.sampling_frequency,
                         None, None, None, config.sample_shifts, config.code_length, **kwargs,
                         code_tiles=code_tiles[rows], block_index=index, shard_sum=total,
                         channels=BankChannels(config.intermediate_frequency, st.carrier_doppler,
                                               st.carrier_phase, config.code_frequency,
                                               st.code_doppler, st.code_phase, time_shards[t]))
                st, out = loop_update(config, st, *total.finish(), None, None if sink is None
                                      else sink.channel_window(c * per, num_chan * per))
            new.append(st)
            outs.append(out)
        if sink is not None:                 # every shard wrote its part in place
            return states, outs[0]
        return (_map_state(lambda *xs: torch.cat(xs), *new),
                TrackOutput(*(torch.cat(xs) for xs in zip(*outs))))

    return graphs.reads_chunk(step)


def _card_step(config, corr, kwargs, time_shards: list):
    """The block body of one channel shard of a bank kernel on distinct
    cards, as the JAX `shard_map` body runs on each device:
    ``step(states, consts, blocks, sinks=None)`` over its time shards' cards
    (a `graphs.scan_mesh` group: the cards its states lie on), card t holding its replica of
    the channel shard's carry (``states[t]``), its constants ``(codes,
    code_tiles, None)`` (its prologue's tiles, `track.bank_prepare`) and its
    own signal (``blocks[t]``, a `graphs.Chunk` in a capture;
    ``time_shards[t]`` its `BankShard`, the piece at offset 0 of what it
    reads). Every card launches its bank kernel first; then each card
    finishes the shard's `ShardSum`, whose first finish copies every card's
    partials to the other cards, adding the T shards in shard order, and
    closes the loop on its own replica through its sink: the same kernels
    over the same slots, so every replica holds the same carry, bit for bit,
    and no carry crosses cards."""

    @graphs.writes_outputs
    def step(states, consts, blocks, sinks=None):
        devices = [st.prn.device for st in states]
        total = ShardSum(len(states), devices)
        for t, (st, (codes, code_tiles, _), block) in enumerate(zip(states, consts, blocks)):
            signal, index = ((block.xs, block.index) if isinstance(block, graphs.Chunk)
                             else (block, None))
            with on_device(devices[t]):
                corr(signal[0], signal[1], codes, st.prn, None, config.sampling_frequency, None,
                     None, None, config.sample_shifts, config.code_length, **kwargs,
                     code_tiles=code_tiles, block_index=index, shard_sum=total,
                     channels=BankChannels(config.intermediate_frequency, st.carrier_doppler,
                                           st.carrier_phase, config.code_frequency,
                                           st.code_doppler, st.code_phase, time_shards[t]))
        new, outs = [], []
        for t, st in enumerate(states):
            with on_device(devices[t]):
                st, out = loop_update(config, st, *total.finish(devices[t]), None,
                                      None if sinks is None else sinks[t])
            new.append(st)
            outs.append(out)
        return tuple(new), tuple(outs)

    return graphs.reads_chunk(step)


def _card_step_without_tiles(config, corr, kwargs, advance):
    """`_card_step` for a correlator that takes no code tiles:
    ``step(states, consts, blocks, sinks=None)`` over one channel shard's
    time shards' cards, card t holding its replica of the carry
    (``states[t]``), its constants ``(codes, None)`` and its own piece of
    the block (``blocks[t]``, the whole block where time is 1). Card t
    advances its replica's phases to piece t (``advance``, its table entries
    Python floats) and correlates the piece; once every card's correlator
    is launched, each card's ``[2, K_local, (A,) L]`` partials (re and im in
    one buffer) go to every other card, and every card adds the T partials
    in shard order (`sum_in_order`) and closes the loop on its own replica
    through its sink: every card adds the same partials in the same order,
    so every replica holds the same carry, bit for bit, and no carry
    crosses cards."""

    @graphs.writes_outputs
    def step(states, consts, blocks, sinks=None):
        devices = [st.prn.device for st in states]
        parts = []
        for t, (st, (codes, _), block) in enumerate(zip(states, consts, blocks)):
            with on_device(devices[t]):
                f_car = config.intermediate_frequency + st.carrier_doppler
                f_code = config.code_frequency + st.code_doppler
                phi_car, phi_code = advance(st.carrier_phase, st.code_phase, f_car, f_code, t)
                parts.append(corr(block[0], block[1], codes, st.prn, f_car,
                                  config.sampling_frequency, phi_car, f_code, phi_code,
                                  config.sample_shifts, config.code_length, **kwargs))
        if len(parts) > 1:
            # Every card's partials to every card, after every correlator.
            for t, dev in enumerate(devices):
                with on_device(dev):
                    parts[t] = torch.stack(parts[t])
            shared = []
            for dev in devices:
                with on_device(dev):
                    shared.append([p.to(dev, non_blocking=True) for p in parts])
        new, outs = [], []
        for t, st in enumerate(states):
            with on_device(devices[t]):
                total = parts[0] if len(parts) == 1 else sum_in_order(shared[t], devices[t])
                st, out = loop_update(config, st, total[0], total[1], None,
                                      None if sinks is None else sinks[t])
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

    On the bank kernels' routes, where every device of the mesh is one card,
    the whole mesh's block is one replayed CUDA graph of ``chan x time``
    bank launches, ``chan`` finishes, ``chan`` loop kernels and the index's
    add (`graphs.scan`); on distinct cards each card holds its channel
    shard's carry and closes its loop itself, and the block over every card
    is one CUDA graph (`graphs.scan_mesh`; see the module). Other
    correlators run through `graphs.scan` on one card, and on distinct
    cards through `graphs.scan_mesh` as the bank routes do, for a time axis
    of 1 and of more than 1 alike: each card advances and correlates its own
    piece and closes the loop on its own replica of its channel shard's
    carry (`_card_step_without_tiles`).
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
    corr, kwargs = bank_correlator(config)
    grid = mesh.grid(chan_axis, time_axis)                # [chan shards, time shards]
    first = mesh.devices.flat[0]
    per = num_k // num_chan
    one_device = len({str(d) for d in mesh.devices.flat}) == 1
    key = ("track_bank_sharded", config, num_chan, num_time)
    tiles = _takes_tiles(config)
    if not tiles and one_device:
        return _one_device_without_tiles(config, corr, kwargs, codes, states, signal_re,
                                         signal_im, num_chan, num_time, tables, first, key)
    # Each time shard as a bank call takes it: its piece in the whole block
    # (one device), or a piece of its own (offset 0, a card's).
    shard_args = (tables, config.sampling_frequency, local_n, config.code_length)
    if one_device:
        # The carry and the outputs are the whole bank's, each channel shard
        # its contiguous part of them; the prologue packs the whole bank's
        # tiles, each shard's its rows.
        with on_device(first):
            return graphs.scan(
                _bank_step(config, corr, kwargs, grid,
                           [time_shard(t, *shard_args) for t in range(num_time)], per),
                states if states.prn.device == first else _map_state(
                    lambda x: x.to(first), states),
                (signal_re.to(first), signal_im.to(first)), (codes.to(first), None),
                key=key, prepare=bank_prepare(config))
    with on_device(first):
        staged = _stage_channels(states, num_chan, first)
        signal = [x.to(first) for x in (signal_re, signal_im)]
        codes = codes.to(first)
    parts = [graphs.Part(staged[c], tuple(x[..., t * local_n:(t + 1) * local_n] for x in signal),
                         (codes, None), grid[c, t])
             for c in range(num_chan) for t in range(num_time)]
    if tiles:
        step = _card_step(config, corr, kwargs, [time_shard(t, *shard_args, offset=0)
                                                 for t in range(num_time)])
    else:
        step = _card_step_without_tiles(config, corr, kwargs, _advance(config, tables, local_n))
    results = graphs.scan_mesh(step, parts, key=key, prepare=bank_prepare(config) if tiles
                               else None, group=num_time)
    with on_device(first):
        return _join_channels(results, first)


def _advance(config, tables, local_n: int):
    """`advance_phases` of ``config``'s time shards of ``local_n`` samples:
    ``advance(carrier_phase, code_phase, carrier_frequency, code_frequency,
    t)``."""
    return functools.partial(
        advance_phases, tables=tables,
        nominal_carrier_frequency=config.intermediate_frequency,
        nominal_code_frequency=config.code_frequency,
        sampling_frequency=config.sampling_frequency,
        samples_per_shard=local_n, code_length=config.code_length,
    )


def _one_device_without_tiles(config, corr, kwargs, codes, states, signal_re, signal_im,
                              num_chan: int, num_time: int, tables, device, key):
    """`track_bank_sharded` for a correlator that takes no code tiles where
    every mesh device is ``device``: the channel shards' states cut onto it,
    one `graphs.scan` of every shard's body (`_mesh_step`), and the shards'
    results joined."""
    step = _mesh_step(config, corr, kwargs,
                      _advance(config, tables, signal_re.shape[-1] // num_time), num_time)
    with on_device(device):
        final, outs = graphs.scan(
            step, tuple(_channel_shards(states, num_chan, [device] * num_chan)),
            (signal_re.to(device), signal_im.to(device)), codes.to(device), key=key)
        final = _map_state(lambda *xs: _gather(xs, device, 0), *final)
        return final, TrackOutput(*(_gather(xs, device, 1) for xs in zip(*outs)))


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
    if len({str(d) for d in mesh.devices.flat}) == 1:
        with on_device(first):
            finals, outs = _dual_one_graph(
                config, codes_data.to(first), codes_pilot.to(first),
                _channel_shards(states, num_chan, devices), signal_re.to(first),
                signal_im.to(first), num_chan)
            final = _map_state(lambda *xs: _gather(xs, first, 0), *finals)
            pilot = TrackOutput(*(_gather(xs, first, 1)
                                  for xs in zip(*(o.pilot for o in outs))))
            return final, DualTrackOutput(
                pilot,
                _gather([o.data_prompt_re for o in outs], first, 1),
                _gather([o.data_prompt_im for o in outs], first, 1),
            )
    # Each card takes its channel shard in one copy per dtype (`_stage_channels`),
    # and its results come back in one copy per dtype (`_join_channels`).
    with on_device(first):
        staged = _stage_channels(states, num_chan, first)
    copies = {name: {} for name in ("data", "pilot", "re", "im")}
    results = []
    for c in range(num_chan):
        dev = devices[c]
        with on_device(dev):
            results.append(track_bank_dual(
                config, _per_device(codes_data, copies["data"], dev),
                _per_device(codes_pilot, copies["pilot"], dev), graphs._moved(staged[c], dev),
                _per_device(signal_re, copies["re"], dev),
                _per_device(signal_im, copies["im"], dev)))
    with on_device(first):
        return _join_channels(results, first)
