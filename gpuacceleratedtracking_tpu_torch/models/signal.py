"""Synthetic GNSS signal generation (port of `gpuacceleratedtracking_tpu.models.signal`).

BPSK code chips upsampled by the fractional code phase, modulated onto a
complex carrier, for 1-D ``[N]``, 2-D ``[A, N]`` (antennas) and 3-D
``[K, A, N]`` (satellites x antennas) blocks:

  code_phase[n]   = f_code / f_s * n + start_code_phase
  chip[n]         = codes[floor(code_phase[n]) mod code_length, prn]
  carrier[n]      = exp(i * (2*pi * f_carrier / f_s * n + start_carrier_phase))
  signal[..., n]  = chip[n] * carrier[n]            (identical across antennas)

The sample axis is last. Everything is made on ``device``; noise comes from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.replica import code_phase_steps, rate
from .system import GNSSSystem


def upsample_code(
    codes: torch.Tensor,
    prn,
    num_samples: int,
    code_frequency,
    sampling_frequency,
    start_code_phase,
    code_length: int,
) -> torch.Tensor:
    """``chip[n] = codes[floor(phase_n) mod L, prn]``; ``prn`` 0-based.

    Scalar ``prn`` gives ``[N]``; a ``[K]`` tensor gives ``[K, N]``. Uses the
    same f32 phase grid as the replica ops, so signal chips and correlator
    replicas agree bit-exactly at floor boundaries.
    """
    phase = code_phase_steps(code_frequency, sampling_frequency, num_samples,
                             device=codes.device)
    phase = phase + torch.tensor(float(start_code_phase), dtype=torch.float32,
                                 device=codes.device)
    chip_idx = torch.remainder(torch.floor(phase).long(), code_length)
    if isinstance(prn, (int, np.integer)):
        return codes[:, int(prn)][chip_idx]
    cols = codes.T[torch.as_tensor(prn, device=codes.device).long()]  # [K, Lc]
    return cols[:, chip_idx]


def gen_carrier(
    num_samples: int,
    carrier_frequency,
    sampling_frequency,
    start_carrier_phase,
    device=None,
) -> torch.Tensor:
    """Unit-amplitude complex carrier ``exp(i(2 pi f/fs n + phi0))`` as complex64.

    The per-sample cycle count is wrapped before the 2*pi multiply to keep
    f32 accuracy at large N.
    """
    n = torch.arange(num_samples, dtype=torch.float32, device=device)
    f_cyc = rate(carrier_frequency, sampling_frequency, device)
    phi_cyc = torch.tensor(float(start_carrier_phase) / (2 * math.pi),
                           dtype=torch.float32, device=device)
    cycles = f_cyc * n + phi_cyc
    cycles = cycles - torch.floor(cycles)
    theta = torch.tensor(2 * math.pi, dtype=torch.float32, device=device) * cycles
    return torch.complex(torch.cos(theta), torch.sin(theta))


def gen_signal(
    system: GNSSSystem,
    prn,
    carrier_frequency: float,
    num_samples: int,
    *,
    num_ants: Optional[int] = None,
    duration: float = 1e-3,
    start_code_phase: float = 0.0,
    start_carrier_phase: float = 0.0,
    code_frequency: Optional[float] = None,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    secondary_code=None,
    secondary_phase: int = 0,
    device=None,
):
    """Generate a synthetic GNSS signal block on ``device``.

    Args mirror the JAX `gen_signal`; ``generator`` replaces the PRNG key and
    is required when ``noise_std > 0``.

    Returns:
      (signal, sampling_frequency): complex64 ``[N]``, ``[A, N]``, ``[K, N]`` or
      ``[K, A, N]``.
    """
    sampling_frequency = num_samples / duration
    f_code = float(code_frequency if code_frequency is not None
                   else system.code_frequency)
    codes = torch.as_tensor(system.codes, device=device)
    chips = upsample_code(
        codes, prn, num_samples, f_code, sampling_frequency,
        float(start_code_phase), system.code_length,
    )
    if secondary_code is not None:
        # One overlay sign per primary code period, selected by the integer
        # part of the code phase in periods.
        phase = code_phase_steps(f_code, sampling_frequency, num_samples,
                                 device=codes.device)
        phase = phase + torch.tensor(float(start_code_phase),
                                     dtype=torch.float32, device=codes.device)
        period = torch.floor(phase / system.code_length).long() + int(secondary_phase)
        sc = torch.as_tensor(np.asarray(secondary_code, np.float32),
                             device=codes.device)
        chips = chips * sc[torch.remainder(period, sc.shape[0])]
    carrier = gen_carrier(num_samples, float(carrier_frequency),
                          sampling_frequency, float(start_carrier_phase),
                          device=codes.device)
    signal = (chips * carrier).to(torch.complex64)
    if num_ants is not None:
        signal = signal.unsqueeze(-2).expand(
            signal.shape[:-1] + (int(num_ants), num_samples)
        ).contiguous()
    if noise_std > 0.0:
        signal = signal + _noise(signal, noise_std, generator)
    return signal, sampling_frequency


def _noise(signal: torch.Tensor, noise_std: float,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise ValueError("noise_std > 0 requires a torch.Generator")
    noise = torch.randn(signal.shape + (2,), generator=generator,
                        dtype=torch.float32, device=signal.device)
    return noise_std * torch.complex(noise[..., 0], noise[..., 1])


def gen_signal_mixed(
    system: GNSSSystem,
    prns,
    dopplers,
    num_samples: int,
    *,
    num_ants: Optional[int] = None,
    duration: float = 1e-3,
    start_code_phases=None,
    intermediate_frequency: float = 0.0,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """Sum of K Doppler-shifted satellite signals — one RF front-end stream.

    Each satellite's code rate is scaled coherently with its carrier Doppler
    (``1 + doppler/f_center``). Returns ``(signal [.., N], sampling_frequency)``.
    """
    prns = np.asarray(prns)
    dopplers = np.asarray(dopplers, np.float64)
    if start_code_phases is None:
        start_code_phases = np.zeros(len(prns))
    total = None
    for prn, dop, phi in zip(prns, dopplers, np.asarray(start_code_phases)):
        scale = 1.0 + dop / system.center_frequency
        s, _ = gen_signal(
            system, int(prn), intermediate_frequency + float(dop),
            num_samples, num_ants=num_ants, duration=duration,
            start_code_phase=float(phi),
            code_frequency=system.code_frequency * scale, device=device,
        )
        total = s if total is None else total + s
    if noise_std > 0.0:
        total = total + _noise(total, noise_std, generator)
    return total, num_samples / duration


def soa(signal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split complex64 into contiguous structure-of-arrays (re, im) f32 planes."""
    return signal.real.contiguous(), signal.imag.contiguous()
