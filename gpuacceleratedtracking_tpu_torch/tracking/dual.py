"""GPS L5 pilot/data dual-component tracking.

Port of `gpuacceleratedtracking_tpu.tracking.dual`. L5 broadcasts two
quadrature components: I5 (data: ranging code x NH10 overlay x 100 sps nav
symbols) and Q5 (pilot: another ranging code x NH20, dataless). A dual channel
correlates both codes against the shared front end and closes the loop on the
pilot (full-range atan2 PLL, unlimited coherent integration); the data
component is demodulated with the pilot-driven NCOs.

The K dual channels run as one 2K-channel bank: data codes in columns
``[0, P)`` and pilot codes in ``[P, 2P)`` of one combined code table, so a
block is one bank call (one kernel launch on CUDA tensors), and the loop
closure is one batched `loop_update` over ``[K]``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models import gpsl5
from ..ops import registry
from .state import TrackConfig, TrackOutput, TrackState
from .track import _bank_code_tile_kwargs, _bank_kernel_kwargs, _Stacked, loop_update


class DualTrackOutput(NamedTuple):
    """Per-block observables of a dual-component channel bank."""

    pilot: TrackOutput               # pilot-driven loop observables
    data_prompt_re: torch.Tensor     # [K] overlay-wiped data prompt (nav symbols)
    data_prompt_im: torch.Tensor


def dual_config(config: TrackConfig) -> TrackConfig:
    """Adapt a TrackConfig for pilot-driven loop closure."""
    return dataclasses.replace(config, pll_discriminator="atan2", secondary_code=())


def _overlay(code, default, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(default if code is None else code, np.float32),
                           device=device)


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
    100 sps nav symbols (10 repeats each at 1 ms blocks).
    """
    if config.secondary_code:
        raise ValueError("use dual_config(): overlay wipe-off is per-component here")
    device = signal_re.device
    num_k = states.prn.shape[0]
    codes = torch.cat([torch.as_tensor(codes_data, device=device),
                       torch.as_tensor(codes_pilot, device=device)], dim=1)
    sd = _overlay(data_secondary, gpsl5.neuman_hofman(False), device)
    sp = _overlay(pilot_secondary, gpsl5.neuman_hofman(True), device)
    prn2 = torch.cat([states.prn, states.prn + codes_data.shape[1]])
    corr = registry.get(config.algorithm)
    kwargs = _bank_kernel_kwargs(config)
    kwargs.update(_bank_code_tile_kwargs(config, codes, prn2))
    pidx = config.prompt_index

    def dup(x):
        return torch.cat([x, x])

    def wipe(x, sc, ms_elapsed):
        sign = sc[torch.remainder(ms_elapsed, sc.shape[0]).long()]
        return x * sign.reshape(sign.shape + (1,) * (x.ndim - sign.ndim))

    pilot_outs = _Stacked(signal_re.shape[0])
    data_re, data_im = [], []
    for b in range(signal_re.shape[0]):
        are, aim = corr(
            signal_re[b], signal_im[b], codes, prn2,
            dup(config.intermediate_frequency + states.carrier_doppler),
            config.sampling_frequency, dup(states.carrier_phase),
            dup(config.code_frequency + states.code_doppler), dup(states.code_phase),
            config.sample_shifts, config.code_length, **kwargs,
        )
        d_re = wipe(are[:num_k], sd, states.ms_elapsed)
        d_im = wipe(aim[:num_k], sd, states.ms_elapsed)
        p_re = wipe(are[num_k:], sp, states.ms_elapsed)
        p_im = wipe(aim[num_k:], sp, states.ms_elapsed)
        # The pilot is transmitted in phase quadrature (+90 deg) to the data:
        # rotate it by -90 deg so zero loop phase error puts the data
        # component on I (nav symbols = sign of data_prompt_re).
        states, out = loop_update(config, states, p_im, -p_re)
        pilot_outs.put(b, out)
        # An antenna axis, if any, is summed, as the JAX function does.
        data_re.append(d_re[..., pidx] if d_re.ndim == 2 else d_re[..., pidx].sum(dim=1))
        data_im.append(d_im[..., pidx] if d_im.ndim == 2 else d_im[..., pidx].sum(dim=1))
    return states, DualTrackOutput(pilot_outs.result(), torch.stack(data_re),
                                   torch.stack(data_im))
