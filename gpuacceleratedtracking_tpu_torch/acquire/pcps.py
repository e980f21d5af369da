"""PCPS acquisition: FFT-based parallel code-phase search.

Port of `gpuacceleratedtracking_tpu.acquire.pcps`. Circular correlation over
all code phases at once, ``IFFT(FFT(signal) * conj(FFT(code)))``, on
`torch.fft` (cuFFT on the card), with:

- Doppler bins processed ``bin_batch`` at a time, so memory stays bounded at
  ``bin_batch x R x K x N`` complex words;
- K satellites searched at once (the code-table FFT is one batched FFT);
- R noncoherent rounds summed in power.

The JAX package's second engine, a four-step matmul DFT on split f32 planes
(`acquire/dftmm.py`), exists because the TPU has no FFT and no complex
transfers; it is not ported, and ``fft_mode="matmul"`` raises.

Outputs hand off to `tracking.init_state` (0-based PRNs, Doppler in Hz, code
phase in chips) through `to_track_states`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device as _device
from ..models.signal import upsample_code
from ..models.system import GNSSSystem
from ..ops.replica import _TWO_PI_F32, rate


class AcquisitionResult(NamedTuple):
    """Per-satellite acquisition estimates (leading axis = searched PRNs)."""

    prn: torch.Tensor              # int32, 0-based (as searched)
    carrier_doppler: torch.Tensor  # Hz, best bin
    code_phase: torch.Tensor       # chips, in [0, code_length)
    peak_metric: torch.Tensor      # deflection: (peak - mu) / sigma off-peak
    power: torch.Tensor            # raw peak power


def doppler_grid(max_doppler: float, num_bins: int) -> np.ndarray:
    """``num_bins`` f32 Doppler bins evenly over ``[-max_doppler, max_doppler]``."""
    return np.linspace(-max_doppler, max_doppler, num_bins).astype(np.float32)


def _bin_power(sre, sim, code_re, code_im, f_cyc, n):
    """Noncoherent correlation power ``[b, K, N]`` of ``[R, N]`` signal planes
    for ``b`` Doppler bins (``f_cyc``: carrier cycles per sample, ``[b]``)."""
    cyc = f_cyc[:, None] * n                                  # [b, N]
    cyc = cyc - torch.floor(cyc)
    theta = _TWO_PI_F32 * cyc
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    # Wipe-off: signal * conj(carrier).
    mr = sre * c + sim * s                                    # [b, R, N]
    mi = sim * c - sre * s
    spec = torch.fft.fft(torch.complex(mr, mi))
    sr, si = spec.real[:, :, None], spec.imag[:, :, None]     # [b, R, 1, N]
    # S * conj(C) per satellite.
    pr = sr * code_re + si * code_im                          # [b, R, K, N]
    pi = si * code_re - sr * code_im
    q = torch.fft.ifft(torch.complex(pr, pi))
    return (q.real * q.real + q.imag * q.imag).sum(dim=1)     # [b, K, N]


def acquire(
    system: GNSSSystem,
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    prns,
    sampling_frequency: float,
    *,
    intermediate_frequency: float = 0.0,
    max_doppler: float = 5000.0,
    doppler_step: Optional[float] = None,
    bin_batch: int = 8,
    fft_mode: str = "auto",
) -> AcquisitionResult:
    """Search ``prns`` (0-based) in a signal block over a Doppler grid.

    ``signal_*``: ``[N]`` f32 planes (one antenna; beamform upstream if
    needed), or ``[R, N]`` for R-round noncoherent integration: per-round
    correlation powers are summed, so data-bit sign flips between rounds do
    not cancel. The search runs on the signal's device. ``doppler_step``
    defaults to ``2/(3 T)`` for the coherent integration time ``T = N / fs``.
    ``fft_mode``: ``"auto"`` or ``"fft"`` (`torch.fft`). Returns estimates
    aligned with ``prns``; ``peak_metric`` is the deflection coefficient
    ``(peak - mu)/sigma`` of the winning Doppler plane (the noise-only maximum
    over the grid sits near ``sqrt(2 ln(D N))``, ~5: accept at roughly > 8).
    """
    if fft_mode not in ("auto", "fft"):
        if fft_mode == "matmul":
            raise ValueError(
                "fft_mode='matmul' is the JAX package's matmul DFT for a TPU, "
                "which has no FFT; the port runs torch.fft (cuFFT on the card): "
                "use 'auto' or 'fft'")
        raise ValueError(f"fft_mode must be 'auto' or 'fft', got {fft_mode!r}")
    signal_re = torch.as_tensor(signal_re, dtype=torch.float32)
    signal_im = torch.as_tensor(signal_im, dtype=torch.float32, device=signal_re.device)
    device = signal_re.device
    if signal_re.ndim == 1:
        signal_re, signal_im = signal_re[None], signal_im[None]
    num_samples = signal_re.shape[-1]
    fs = float(sampling_frequency)
    if doppler_step is None:
        doppler_step = 2.0 / (3.0 * (num_samples / fs))
    num_bins = int(2 * max_doppler / doppler_step) + 1
    dopplers = torch.as_tensor(doppler_grid(max_doppler, num_bins), device=device)

    prns = torch.as_tensor(np.asarray(prns), dtype=torch.int32, device=device)
    codes = torch.as_tensor(system.codes, device=device)
    chips = upsample_code(codes, prns, num_samples, system.code_frequency, fs, 0.0,
                          system.code_length)                 # [K, N]
    code_fft = torch.fft.fft(torch.complex(chips, torch.zeros_like(chips)))
    code_re, code_im = code_fft.real, code_fft.imag

    # Carrier cycles per sample of each bin, f32 as the JAX package rounds them.
    f_cyc = rate(float(np.float32(intermediate_frequency)) + dopplers, fs)
    n = torch.arange(num_samples, dtype=torch.float32, device=device)
    power = torch.cat([
        _bin_power(signal_re, signal_im, code_re, code_im, f_cyc[b:b + bin_batch], n)
        for b in range(0, num_bins, bin_batch)])              # [D, K, N]

    # Peak over (Doppler, phase) per satellite.
    num_k = power.shape[1]
    flat = power.transpose(0, 1).reshape(num_k, -1)           # [K, D*N]
    idx = torch.argmax(flat, dim=1)
    peak = flat.gather(1, idx[:, None])[:, 0]
    bin_idx = idx // num_samples
    phase_idx = idx % num_samples

    # Detection statistic: deflection (peak - mu) / sigma over the off-peak
    # cells of the winning Doppler plane, +/-1 chip around the peak left out.
    # Summing R rounds shrinks the floor's relative sigma by sqrt(R).
    f32 = np.float32
    guard = int(np.ceil(f32(fs) / f32(system.code_frequency)))
    pos = torch.arange(num_samples, device=device)[None, :]
    dist = (pos - phase_idx[:, None]).abs()
    dist = torch.minimum(dist, num_samples - dist)
    mask = (dist > guard).to(torch.float32)                   # [K, N]
    best_plane = power[bin_idx, torch.arange(num_k, device=device)]  # [K, N]
    denom = mask.sum(dim=1).clamp(min=1.0)
    mu = (best_plane * mask).sum(dim=1) / denom
    var = ((best_plane - mu[:, None]) ** 2 * mask).sum(dim=1) / denom
    metric = (peak - mu) / var.sqrt().clamp(min=1e-30)

    # The f32 order of the JAX formula: sample index times chips per sample.
    chips_per_sample = float(f32(system.code_frequency) / f32(fs))
    code_length = system.code_length
    code_phase = torch.remainder(phase_idx.to(torch.float32) * chips_per_sample, code_length)
    # Tracking replicas start at this shift into the code: the signal's code
    # phase at sample 0 is (code_length - shift) mod code_length.
    code_phase = torch.remainder(code_length - code_phase, code_length)
    return AcquisitionResult(
        prn=prns, carrier_doppler=dopplers[bin_idx], code_phase=code_phase,
        peak_metric=metric, power=peak,
    )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_track_states(result, cn0_window: int = 20, device=_device.DEFAULT):
    """Acquisition -> tracking handoff: a seeded channel-bank state on
    ``device`` (the card unless the caller asks for the CPU). ``result`` is an
    `AcquisitionResult` of tensors or of numpy arrays (a JAX result converted
    with ``np.asarray``)."""
    from ..tracking.state import init_state

    return init_state(
        _host(result.prn),
        carrier_doppler=_host(result.carrier_doppler),
        code_phase=_host(result.code_phase),
        cn0_window=cn0_window,
        device=device,
    )
