"""GPS L5 pilot/data dual-component tracking.

Port of `gpuacceleratedtracking_tpu.tracking.dual`. L5 broadcasts two
quadrature components: I5 (data: ranging code x NH10 overlay x 100 sps nav
symbols) and Q5 (pilot: another ranging code x NH20, dataless). A dual channel
correlates both codes against the shared front end and closes the loop on the
pilot (full-range atan2 PLL, unlimited coherent integration); the data
component is demodulated with the pilot-driven NCOs.

The K dual channels run as one 2K-channel bank: data codes in columns
``[0, P)`` and pilot codes in ``[P, 2P)`` of one combined code table, so a
block is one bank call (one kernel launch on CUDA tensors; the per-channel
kernels ``pallas_taps`` and ``pallas_fused`` run one channel at a time, 2K
launches, as in `track_bank`). The rest of the block, the overlay wipes,
the pilot's rotation, the loop closure over ``[K]`` and the data prompts, is
`dual_update`: one launch of the loop-closure kernel in dual mode on CUDA
tensors, its plain torch version `dual_update_plain` on the CPU. As in
`track_bank`, the block body runs through `graphs.scan`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import gpsl5
from ..ops import loop_kernel
from . import graphs
from .state import TrackConfig, TrackOutput, TrackState
from .track import (_bank_code_tile_kwargs, _overlay_table, _takes_tiles, bank_correlate,
                    bank_correlator, loop_update_plain)


class DualTrackOutput(NamedTuple):
    """Per-block observables of a dual-component channel bank."""

    pilot: TrackOutput               # pilot-driven loop observables
    data_prompt_re: torch.Tensor     # [K] overlay-wiped data prompt (nav symbols)
    data_prompt_im: torch.Tensor


def dual_config(config: TrackConfig) -> TrackConfig:
    """Adapt a TrackConfig for pilot-driven loop closure."""
    return dataclasses.replace(config, pll_discriminator="atan2", secondary_code=())


def _overlay(code, default, device) -> torch.Tensor:
    """The overlay signs as an f32 tensor on ``device``, copied there once per
    code and device (`track._overlay_table`)."""
    signs = np.asarray(default if code is None else code, np.float32)
    return _overlay_table(tuple(float(s) for s in signs.reshape(-1)), device)


def _wipe(x, sc, ms_elapsed):
    sign = sc[torch.remainder(ms_elapsed, sc.shape[0]).long()]
    return x * sign.reshape(sign.shape + (1,) * (x.ndim - sign.ndim))


def dual_update_plain(config: TrackConfig, states: TrackState, accum_re, accum_im,
                      data_overlay, pilot_overlay, sink: Optional[graphs.Sink] = None):
    """The plain PyTorch version of `dual_update`, on any device: the kernel's
    reference on the card. A ``sink`` takes the results as in `dual_update`,
    by ``index_copy_`` and ``copy_`` (`graphs.write_sink`)."""
    num_k = states.prn.shape[0]
    d_re = _wipe(accum_re[:num_k], data_overlay, states.ms_elapsed)
    d_im = _wipe(accum_im[:num_k], data_overlay, states.ms_elapsed)
    p_re = _wipe(accum_re[num_k:], pilot_overlay, states.ms_elapsed)
    p_im = _wipe(accum_im[num_k:], pilot_overlay, states.ms_elapsed)
    # The pilot is transmitted in phase quadrature (+90 deg) to the data:
    # rotate it by -90 deg so zero loop phase error puts the data component
    # on I (nav symbols = sign of data_prompt_re).
    new_states, out = loop_update_plain(config, states, p_im, -p_re)
    # An antenna axis, if any, is summed, as the JAX function does.
    pidx = config.prompt_index
    data_re = d_re[..., pidx] if d_re.ndim == 2 else d_re[..., pidx].sum(dim=1)
    data_im = d_im[..., pidx] if d_im.ndim == 2 else d_im[..., pidx].sum(dim=1)
    result = DualTrackOutput(out, data_re, data_im)
    if sink is not None:
        return graphs.write_sink(sink, states, new_states, result)
    return new_states, result


def dual_update(config: TrackConfig, states: TrackState, accum_re, accum_im, data_overlay,
                pilot_overlay, sink: Optional[graphs.Sink] = None):
    """The dual block after the correlator: wipe the data and pilot overlays
    off the 2K-channel bank's ``[2K, (A,) L]`` accumulators (data channels
    first), close the loops on the pilot rotated by -90 deg, and sum the data
    prompts over any antenna axis. Returns the new states and a
    `DualTrackOutput`. CUDA tensors launch the loop-closure kernel once in
    dual mode (`ops.loop_kernel.dual_update_kernel`) or raise; CPU tensors
    run `dual_update_plain`. With a ``sink`` (a `graphs.Sink` of the
    `DualTrackOutput` leaves) the outputs go into their rows of the sink and
    the new states over ``states``' own tensors, as in `track.loop_update`.
    """
    device = accum_re.device
    if device.type == "cuda":
        return loop_kernel.dual_update_kernel(config, states, accum_re, accum_im, data_overlay,
                                              pilot_overlay, sink)
    if device.type != "cpu":
        raise ValueError(f"dual_update runs on CPU or CUDA tensors, not {device}")
    return dual_update_plain(config, states, accum_re, accum_im, data_overlay, pilot_overlay,
                             sink)


def dual_parts(config: TrackConfig, codes_data, codes_pilot, device: torch.device,
               data_secondary=None, pilot_secondary=None):
    """The block body of `track_bank_dual`, its per-call constants and their
    prologue: ``step(states, consts, (signal_re, signal_im))`` correlates
    the 2K-channel bank once and hands its accumulators to `dual_update` (in
    a capture, with the entry's `graphs.Sink`); ``consts`` are ``(codes_data,
    codes_pilot, data overlay, pilot overlay)``; ``prepare(states, consts)``
    returns the constants ``step`` takes, ``(codes, prn, code_tiles, data
    overlay, pilot overlay)``, derived once per call (`graphs.scan`: on the
    card, inside the captured program). For a bank kernel: the data table,
    the K PRNs and the 2K channels' code tiles (data, then pilot) packed
    from both tables in one launch (``prepare`` marked
    `graphs.writes_prepared`: in a capture, into the entry's buffer, the
    entry's index zeroed by the same launch), and the kernel derives
    channel k's parameters from state k mod K and reads the block at the
    entry's index (`graphs.Chunk`): nothing is joined. For any other
    correlator: the joined ``[Lc, 2P]`` table, the 2K channels' PRNs and no
    tiles, and the channel parameters joined per block."""
    if config.secondary_code:
        raise ValueError("use dual_config(): overlay wipe-off is per-component here")
    sd = _overlay(data_secondary, gpsl5.neuman_hofman(False), device)
    sp = _overlay(pilot_secondary, gpsl5.neuman_hofman(True), device)
    corr, kwargs = bank_correlator(config)    # per-channel kernels: 2K launches per block
    tiles = _takes_tiles(config)

    def prepare(states, consts, into=None):
        codes_data, codes_pilot, sd, sp = consts
        if tiles:
            code_tiles = _bank_code_tile_kwargs(
                config, codes_data, states.prn, codes_pilot,
                None if into is None else (into.prepared[2], into.index))["code_tiles"]
            return codes_data, states.prn, code_tiles, sd, sp
        codes = torch.cat([codes_data, codes_pilot], dim=1)
        prn2 = torch.cat([states.prn, states.prn + codes_data.shape[1]])
        return codes, prn2, None, sd, sp

    def dup(x):
        return torch.cat([x, x])

    @graphs.writes_outputs
    def step(states, consts, block, sink=None):
        codes, prn, code_tiles, sd, sp = consts
        if tiles:
            are, aim = bank_correlate(config, corr, kwargs, states, codes, prn, code_tiles,
                                      block)
        else:
            are, aim = corr(
                block[0], block[1], codes, prn,
                dup(config.intermediate_frequency + states.carrier_doppler),
                config.sampling_frequency, dup(states.carrier_phase),
                dup(config.code_frequency + states.code_doppler), dup(states.code_phase),
                config.sample_shifts, config.code_length, **kwargs,
            )
        return dual_update(config, states, are, aim, sd, sp, sink)

    consts = (torch.as_tensor(codes_data, device=device),
              torch.as_tensor(codes_pilot, device=device), sd, sp)
    if tiles:
        return graphs.reads_chunk(step), consts, graphs.writes_prepared(prepare)
    return step, consts, prepare


def track_bank_dual(
    config: TrackConfig,
    codes_data: torch.Tensor,
    codes_pilot: torch.Tensor,
    states: TrackState,
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    data_secondary=None,
    pilot_secondary=None,
) -> tuple[TrackState, DualTrackOutput]:
    """Track a K-channel dual-component (data + pilot) bank over ``[B, ..., N]``.

    ``codes_data`` / ``codes_pilot``: ``[Lc, P]`` +/-1 chip tables (I5 / Q5).
    ``states.prn`` indexes into both tables; overlay wipe-off uses the
    channel's ``ms_elapsed`` (align it by secondary sync). The loop closes on
    the pilot; data prompts come back overlay-wiped, so their signs are the
    100 sps nav symbols (10 repeats each at 1 ms blocks). On CUDA tensors the
    block body (`dual_parts`) runs as a replayed CUDA graph (`graphs.scan`),
    after a captured prologue that joins the tables and packs the code
    tiles, else block by block, as in `track.track_bank`.
    """
    step, consts, prepare = dual_parts(config, codes_data, codes_pilot, signal_re.device,
                                       data_secondary, pilot_secondary)
    return graphs.scan(step, states, (signal_re, signal_im), consts,
                       key=("track_bank_dual", config), prepare=prepare)
