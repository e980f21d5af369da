"""Closed-loop tracking: per-block correlate -> discriminate -> filter -> NCO.

Port of `gpuacceleratedtracking_tpu.tracking.track`. `loop_update` works on
any leading channel axes, so a bank's loop closure is one batched call over
``[K]``; `track` and `track_bank` run a Python loop over blocks in place of
`lax.scan`, with no host sync inside the loop, writing into preallocated
stacked ``[B, ...]`` outputs.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops import registry
from . import cn0 as cn0_mod
from . import discriminators, loop_filter
from .loop_filter import LoopFilterState
from .state import TrackConfig, TrackOutput, TrackState

# Bank algorithms served by a hand-written kernel: they take the nominal
# rates and the hoisted per-channel code columns.
_BANK_KERNELS = ("pallas_bank", "pallas_bank_rows", "pallas_bank_comp",
                 "pallas_bank_auto")


def _bank_kernel_kwargs(config: TrackConfig) -> dict:
    """Keyword arguments of a bank-signature correlator from the config.

    ``z_dtype="bf16"`` goes to the composite kernel (``pallas_bank_comp``, or
    ``pallas_bank_auto``, which warns itself if the scenario resolves
    elsewhere); any other algorithm ignores it, and says so with a warning.
    """
    kwargs = {}
    if config.algorithm in _BANK_KERNELS:
        kwargs["nominal_code_frequency"] = config.code_frequency
        kwargs["nominal_carrier_frequency"] = config.intermediate_frequency
    if config.z_dtype == "bf16":
        if config.algorithm in ("pallas_bank_comp", "pallas_bank_auto"):
            kwargs["z_dtype"] = torch.bfloat16
        else:
            warnings.warn(
                f"TrackConfig(z_dtype='bf16') is ignored by algorithm "
                f"{config.algorithm!r} (only the composite bank kernel has "
                "bf16 accumulator planes); tracking runs in f32",
                stacklevel=2,
            )
    return kwargs


def _bank_code_tile_kwargs(config: TrackConfig, codes: torch.Tensor,
                           prn: torch.Tensor) -> dict:
    """The per-channel code columns of a bank kernel, gathered once per run:
    PRNs are loop constants. All three bank routes take the same table."""
    if config.algorithm not in _BANK_KERNELS:
        return {}
    from ..ops.epl_kernels import prepare_bank_code_tiles_rows

    return {"code_tiles": prepare_bank_code_tiles_rows(codes, prn)}


def track_step(
    config: TrackConfig,
    codes: torch.Tensor,
    state: TrackState,
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Process one integration block for one channel.

    ``signal_*``: ``[N]`` or ``[A, N]``; discriminators run on the beamformed
    accumulators (``ant_weights``: optional ``(w_re, w_im)`` ``[A]``).
    """
    corr = registry.get(config.algorithm)
    accum_re, accum_im = corr(
        signal_re, signal_im, codes, state.prn,
        config.intermediate_frequency + state.carrier_doppler,
        config.sampling_frequency, state.carrier_phase,
        config.code_frequency + state.code_doppler, state.code_phase,
        config.sample_shifts, config.code_length,
    )
    return loop_update(config, state, accum_re, accum_im, ant_weights)


def _beamform(accum_re, accum_im, ant_weights, single_antenna: bool):
    """Steered antenna combination ``sum_a conj(w_a) x_a`` over axis -2."""
    if single_antenna:
        return accum_re, accum_im
    if ant_weights is None:
        return accum_re.sum(dim=-2), accum_im.sum(dim=-2)
    w_re, w_im = (torch.as_tensor(w, dtype=torch.float32,
                                  device=accum_re.device)[..., :, None]
                  for w in ant_weights)
    bf_re = (w_re * accum_re + w_im * accum_im).sum(dim=-2)
    bf_im = (w_re * accum_im - w_im * accum_re).sum(dim=-2)
    return bf_re, bf_im


def _select(mask, new, old):
    """``where(mask, new, old)`` with ``mask`` broadcast over trailing axes."""
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def loop_update(
    config: TrackConfig,
    state: TrackState,
    accum_re: torch.Tensor,
    accum_im: torch.Tensor,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Close the loop on one block's accumulators: discriminate -> filter -> NCO.

    ``accum_*``: ``[..., L]`` or ``[..., A, L]`` over the state's channel axes.
    """
    device = accum_re.device
    t = config.integration_time
    # Constants rounded to f32 but kept as Python floats: an op with a Python
    # scalar passes it as an argument, where a 0-d device tensor would cost a
    # host-to-device copy every block.
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    carrier_freq = config.intermediate_frequency + state.carrier_doppler
    code_freq = config.code_frequency + state.code_doppler
    single_antenna = accum_re.ndim == state.prn.ndim + 1

    # Secondary-code (overlay) wipe-off, indexed by the block counter.
    if config.secondary_code:
        sc = torch.tensor(config.secondary_code, dtype=torch.float32, device=device)
        sign = sc[torch.remainder(state.ms_elapsed, len(config.secondary_code)).long()]
        sign = sign.reshape(sign.shape + (1,) * (accum_re.ndim - sign.ndim))
        accum_re = accum_re * sign
        accum_im = accum_im * sign

    bf_re, bf_im = _beamform(accum_re, accum_im, ant_weights, single_antenna)
    pidx = config.prompt_index

    # Coherent post-integration over a k_coh-block window: the filters update
    # only at window boundaries; NCO phases advance every block.
    k_coh = max(int(config.coherent_blocks), 1)
    if k_coh > 1:
        coh_re = state.coh_re + bf_re
        coh_im = state.coh_im + bf_im
        boundary = torch.remainder(state.ms_elapsed + 1, k_coh) == 0
    else:
        coh_re, coh_im = bf_re, bf_im
    t_coh = f32(t * k_coh)
    prompt_re, prompt_im = coh_re[..., pidx], coh_im[..., pidx]

    atan2 = config.pll_discriminator == "atan2"
    pll_err = (discriminators.pll_atan2 if atan2 else discriminators.pll_costas)(
        prompt_re, prompt_im)
    # Early = most-advanced replica (largest positive sample shift, last tap).
    dll_err = discriminators.dll_emle(
        coh_re[..., -1], coh_im[..., -1], coh_re[..., 0], coh_im[..., 0],
        config.spacing_chips,
    )
    fll_err = (discriminators.fll_atan2 if atan2 else discriminators.fll_atan)(
        state.prev_prompt_re, state.prev_prompt_im, prompt_re, prompt_im, t_coh)
    fll_err = torch.where(state.ms_elapsed >= k_coh, fll_err, 0.0)

    pll_state, doppler_cmd = loop_filter.step(
        state.pll_filter, pll_err, t_coh, config.pll_bandwidth, config.pll_order,
        fll_error=fll_err, fll_bandwidth=config.fll_bandwidth,
    )
    dll_state, code_cmd = loop_filter.step(
        state.dll_filter, dll_err, t_coh, config.dll_bandwidth, config.dll_order
    )

    # Carrier aiding: code Doppler follows carrier Doppler scaled into chip
    # rate, plus the DLL's own correction.
    new_carrier_doppler = doppler_cmd
    new_code_doppler = (
        code_cmd + new_carrier_doppler * config.code_frequency / config.center_frequency
    )

    if k_coh > 1:
        pll_state = LoopFilterState(*(_select(boundary, a, b)
                                      for a, b in zip(pll_state, state.pll_filter)))
        dll_state = LoopFilterState(*(_select(boundary, a, b)
                                      for a, b in zip(dll_state, state.dll_filter)))
        new_carrier_doppler = _select(boundary, new_carrier_doppler, state.carrier_doppler)
        new_code_doppler = _select(boundary, new_code_doppler, state.code_doppler)
        prompt_keep = _select(boundary, prompt_re, state.prev_prompt_re)
        prompt_keep_im = _select(boundary, prompt_im, state.prev_prompt_im)
        coh_re = _select(boundary, torch.zeros_like(coh_re), coh_re)
        coh_im = _select(boundary, torch.zeros_like(coh_im), coh_im)
        pll_err = _select(boundary, pll_err, torch.zeros_like(pll_err))
        dll_err = _select(boundary, dll_err, torch.zeros_like(dll_err))
    else:
        prompt_keep, prompt_keep_im = prompt_re, prompt_im
        coh_re = torch.zeros_like(state.coh_re)
        coh_im = torch.zeros_like(state.coh_im)

    # NCO phase propagation over the block just consumed, wrapped for f32.
    two_pi = f32(2 * math.pi)
    carrier_phase = torch.remainder(
        state.carrier_phase + two_pi * carrier_freq * f32(t), two_pi
    )
    code_phase = torch.remainder(
        state.code_phase + code_freq * f32(t), f32(float(config.code_length))
    )

    # C/N0 runs on the per-block prompt regardless of the coherent window.
    cn0_state = cn0_mod.update(state.cn0, bf_re[..., pidx], bf_im[..., pidx])
    cn0_dbhz = cn0_mod.estimate(cn0_state, f32(t))

    new_state = TrackState(
        prn=state.prn,
        carrier_doppler=new_carrier_doppler,
        carrier_phase=carrier_phase,
        code_doppler=new_code_doppler,
        code_phase=code_phase,
        pll_filter=pll_state,
        dll_filter=dll_state,
        cn0=cn0_state,
        ms_elapsed=state.ms_elapsed + 1,
        prev_prompt_re=prompt_keep,
        prev_prompt_im=prompt_keep_im,
        coh_re=coh_re,
        coh_im=coh_im,
    )
    output = TrackOutput(
        accum_re=accum_re,
        accum_im=accum_im,
        prompt_re=prompt_re,
        prompt_im=prompt_im,
        carrier_doppler=new_carrier_doppler,
        code_doppler=new_code_doppler,
        carrier_phase=carrier_phase,
        code_phase=code_phase,
        pll_error=pll_err,
        dll_error=dll_err,
        cn0_dbhz=cn0_dbhz,
    )
    return new_state, output


class _Stacked:
    """Per-block outputs written into ``[B, ...]`` tensors allocated on the
    first block (shapes are known only then)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.fields = None

    def put(self, b: int, out: TrackOutput) -> None:
        if self.fields is None:
            self.fields = [torch.empty((self.num_blocks,) + x.shape, dtype=x.dtype,
                                       device=x.device) for x in out]
        for dst, x in zip(self.fields, out):
            dst[b] = x

    def result(self) -> TrackOutput:
        return TrackOutput(*self.fields)


def track(
    config: TrackConfig,
    codes: torch.Tensor,
    state: TrackState,
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Track one channel over ``[num_blocks, ..., N]`` blocks.

    Returns the final state and per-block stacked outputs.
    """
    outs = _Stacked(signal_re.shape[0])
    for b in range(signal_re.shape[0]):
        state, out = track_step(config, codes, state, signal_re[b], signal_im[b],
                                ant_weights)
        outs.put(b, out)
    return state, outs.result()


def track_bank(
    config: TrackConfig,
    codes: torch.Tensor,
    states: TrackState,
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Track a K-channel bank over ``[B, N]`` or ``[B, A, N]`` blocks.

    ``states`` carries a leading channel axis ``[K]``; the signal is shared by
    all channels. A bank algorithm correlates the whole bank in one call per
    block (one kernel launch for ``pallas_bank*`` on CUDA tensors); the
    per-channel algorithm ``fused_xla`` runs batched over ``[K]``.
    ``ant_weights``: optional ``(w_re, w_im)`` of shape ``[A]`` (shared) or
    ``[K, A]`` (per channel).
    """
    num_k = states.prn.shape[0]
    device = signal_re.device
    if ant_weights is not None:
        num_ants = signal_re.shape[-2] if signal_re.ndim == 3 else 1
        ant_weights = tuple(
            torch.as_tensor(w, dtype=torch.float32, device=device)
            .expand(num_k, num_ants) for w in ant_weights
        )

    corr = registry.get(config.algorithm)
    kwargs = _bank_kernel_kwargs(config)
    kwargs.update(_bank_code_tile_kwargs(config, codes, states.prn))

    outs = _Stacked(signal_re.shape[0])
    for b in range(signal_re.shape[0]):
        accum_re, accum_im = corr(
            signal_re[b], signal_im[b], codes, states.prn,
            config.intermediate_frequency + states.carrier_doppler,
            config.sampling_frequency, states.carrier_phase,
            config.code_frequency + states.code_doppler, states.code_phase,
            config.sample_shifts, config.code_length, **kwargs,
        )
        states, out = loop_update(config, states, accum_re, accum_im, ant_weights)
        outs.put(b, out)
    return states, outs.result()
