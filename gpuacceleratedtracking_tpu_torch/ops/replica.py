"""Replica generation: carrier NCO and code-replica upsampling.

Port of `gpuacceleratedtracking_tpu.ops.replica`. Layout: sample axis last.
Channel parameters may carry leading batch axes (``[K]``), which then lead the
outputs, so a bank is one batched call rather than a per-channel map.

The JAX package needs ``precise_div`` because XLA lowers a traced f32 divide
to reciprocal-multiply. Here every rate is ``f32(f64(num) / fs)`` (`rate`),
the correctly rounded quotient; it is at most 1 ulp from the JAX value.

Nothing here copies a host value to the device or reads a device value on
the host: constants enter as Python scalars (an f32 op rounds them to f32),
and a PRN tensor selects its code column by `index_select`, so a tracking
loop issues these ops without waiting on the card.
"""

from __future__ import annotations

import math
import numbers

import torch


# f32(2 pi). Kernels and plain versions agree only if every carrier path
# rounds 2 pi the same way, so they all import this one value.
_TWO_PI_F32 = float(torch.tensor(2 * math.pi, dtype=torch.float32))


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def code_columns(codes: torch.Tensor, prn) -> torch.Tensor:
    """The PRNs' code columns ``[..., Lc]`` of a ``[Lc, P]`` table, contiguous;
    ``prn`` is 0-based, a Python integer or a tensor of any shape."""
    if isinstance(prn, numbers.Integral):
        return codes[:, int(prn)].contiguous()
    prn = torch.as_tensor(prn, device=codes.device)
    cols = torch.index_select(codes, 1, prn.reshape(-1).long())      # [Lc, K]
    return cols.T.reshape(prn.shape + codes.shape[:1]).contiguous()


def _chips(codes: torch.Tensor, prn, chip_idx: torch.Tensor) -> torch.Tensor:
    """``code[chip_idx]`` for each PRN: ``[..K.., M]`` from ``[M]`` indices."""
    cols = code_columns(codes, prn)                                  # [..K.., Lc]
    if cols.ndim == 1:
        return cols[chip_idx]
    return torch.gather(cols, -1, chip_idx.expand(cols.shape[:-1] + (-1,)))


def rate(num, sampling_frequency, device=None) -> torch.Tensor:
    """Correctly rounded f32 ``num / sampling_frequency`` (``num`` taken as f32)."""
    num = _f32(num, device)
    return (num.double() / float(sampling_frequency)).float()


def code_phase_steps(code_frequency, sampling_frequency, num_samples: int,
                     device=None) -> torch.Tensor:
    """Per-sample code phases ``rho * n`` as f32, rebased for accuracy.

    ``rho*n`` is computed as ``rho*row_start + rho*offset`` over 128-sample
    rows, so f32 rounding stays below ~1e-4 chips even at N = 2**18. Leading
    axes of ``code_frequency`` lead the ``[..., N]`` result.
    """
    rho = rate(code_frequency, sampling_frequency, device)[..., None, None]
    n_hi = torch.arange(0, num_samples, 128, dtype=torch.float32, device=rho.device)
    n_lo = torch.arange(128, dtype=torch.float32, device=rho.device)
    phases = rho * n_hi[:, None] + rho * n_lo[None, :]
    return phases.reshape(phases.shape[:-2] + (-1,))[..., :num_samples]


def gen_code_replica(
    codes: torch.Tensor,
    prn,
    code_frequency,
    sampling_frequency,
    start_code_phase,
    num_samples: int,
    min_shift: int,
    max_shift: int,
    code_length: int,
) -> torch.Tensor:
    """Upsampled +/-1 code replica with tap halo, ``[..., N + span]``.

    Element ``r[j]`` holds the chip at sample ``n = j + min_shift``; the tap
    with shift ``d`` correlates sample ``n`` against ``r[n + d - min_shift]``.
    ``prn`` is 0-based, scalar or ``[K]`` (with matching ``[K]`` phases/rates).
    """
    device = codes.device
    rho = rate(code_frequency, sampling_frequency, device)
    phi = _f32(start_code_phase, device)
    # Main range n in [0, N + max_shift) reuses the signal generator's phase
    # grid (origin 0), so prompt-tap chips are bit-identical to the
    # transmitted chips; the left halo n in [min_shift, 0) is computed directly.
    phase_main = code_phase_steps(
        code_frequency, sampling_frequency, num_samples + max_shift, device
    ) + phi[..., None]
    if min_shift < 0:
        n_left = torch.arange(min_shift, 0, dtype=torch.float32, device=device)
        phase_left = rho[..., None] * n_left + phi[..., None]
        phase = torch.cat(
            [phase_left.expand(phase_main.shape[:-1] + (-1,)), phase_main], dim=-1
        )
    else:
        phase = phase_main[..., min_shift:]
    chip_idx = torch.remainder(torch.floor(phase).long(), code_length)
    return _chips(codes, prn, chip_idx)


def gen_code_replica_quantized(
    codes: torch.Tensor,
    prn,
    code_frequency,
    sampling_frequency,
    start_code_phase,
    num_samples: int,
    min_shift: int,
    max_shift: int,
    code_length: int,
    phase_bits: int = 12,
) -> torch.Tensor:
    """Fixed-point-NCO replica ``[..., N + span]``: the texture-lookup analog.

    The per-sample code phase is rounded to ``phase_bits`` fractional bits
    (round half to even, the texture unit's nearest-neighbour snap) before
    the floor, as in the JAX `gen_code_replica_quantized`; element ``r[j]``
    holds the chip at sample ``j + min_shift``.
    """
    device = codes.device
    total = num_samples + max_shift - min_shift
    scale = float(2 ** phase_bits)
    phase = code_phase_steps(code_frequency, sampling_frequency, total, device)
    offset = (_f32(start_code_phase, device)
              + rate(code_frequency, sampling_frequency, device) * float(min_shift))
    phase = phase + offset[..., None]
    q = torch.round(phase * scale) / scale
    chip_idx = torch.remainder(torch.floor(q).long(), code_length)
    return _chips(codes, prn, chip_idx)


def gen_carrier_replica(
    carrier_frequency,
    sampling_frequency,
    start_carrier_phase_rad,
    num_samples: int,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) planes ``[..., N]`` of ``exp(i(2 pi f/fs n + phi))``.

    The cycle count is wrapped per 128-sample row before the lane offset is
    added, for f32 accuracy at large N.
    """
    f_cyc = rate(carrier_frequency, sampling_frequency, device)[..., None, None]
    device = f_cyc.device
    phi_cyc = (_f32(start_carrier_phase_rad, device) / _TWO_PI_F32)[..., None, None]
    n_hi = torch.arange(0, num_samples + 127, 128, dtype=torch.float32,
                        device=device)[:, None]
    n_lo = torch.arange(128, dtype=torch.float32, device=device)[None, :]
    cyc_hi = f_cyc * n_hi
    cyc_hi = cyc_hi - torch.floor(cyc_hi)
    cyc = cyc_hi + f_cyc * n_lo + phi_cyc
    theta = (cyc - torch.floor(cyc)) * _TWO_PI_F32
    flat = theta.reshape(theta.shape[:-2] + (-1,))[..., :num_samples]
    return torch.cos(flat), torch.sin(flat)
