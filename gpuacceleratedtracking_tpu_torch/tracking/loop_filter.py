"""Loop filters: 1st/2nd/3rd-order with trapezoidal (bilinear) integrators.

Port of `gpuacceleratedtracking_tpu.tracking.loop_filter` (Kaplan & Hegarty
Table 8.23 constants):

- 1st order: ``out = 4 * Bn * err``                      (omega0 = 4Bn)
- 2nd order: ``omega0 = Bn / 0.53``,  a2 = sqrt(2)
- 3rd order: ``omega0 = Bn / 0.7845``, a3 = 1.1, b3 = 2.4

State is an ``(x1, x2)`` pair of f32 tensors (unused entries zero), the same
shape for every order, batched over any leading channel axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class LoopFilterState(NamedTuple):
    x1: torch.Tensor  # velocity integrator
    x2: torch.Tensor  # acceleration integrator (3rd order only)


def init(value=0.0, device=None) -> LoopFilterState:
    """Initial state; ``value`` seeds the velocity integrator."""
    value = torch.as_tensor(value, dtype=torch.float32, device=device)
    return LoopFilterState(value, torch.zeros_like(value))


def step(
    state: LoopFilterState,
    error,
    integration_time,
    bandwidth,
    order: int = 2,
    fll_error=None,
    fll_bandwidth: float = 0.0,
) -> tuple[LoopFilterState, torch.Tensor]:
    """One filter update. Returns ``(new_state, control_output)``.

    ``error`` in the discriminator's units; the output in units/s. A
    ``fll_error`` (Hz) with nonzero ``fll_bandwidth`` frequency-aids the
    velocity integrator (FLL-assisted PLL).
    """
    device = state.x1.device
    # An f32-rounded Python float: no host-to-device copy per call.
    t = float(np.float32(integration_time))
    err = torch.as_tensor(error, dtype=torch.float32, device=device)
    fll = None
    if fll_error is not None and fll_bandwidth > 0.0:
        fll = torch.as_tensor(fll_error, dtype=torch.float32, device=device)
    if order == 1:
        omega0 = 4.0 * bandwidth
        return state, omega0 * err
    if order == 2:
        omega0 = bandwidth / 0.53
        dx1 = omega0**2 * err * t
        if fll is not None:
            omega0f = 4.0 * fll_bandwidth
            dx1 = dx1 + omega0f * fll * t
        x1 = state.x1 + dx1
        out = 0.5 * (state.x1 + x1) + math.sqrt(2.0) * omega0 * err
        return LoopFilterState(x1, state.x2), out
    if order == 3:
        omega0 = bandwidth / 0.7845
        x2 = state.x2 + omega0**3 * err * t
        dx1 = (0.5 * (state.x2 + x2) + 1.1 * omega0**2 * err) * t
        if fll is not None:
            omega0f = fll_bandwidth / 0.53
            x2 = x2 + omega0f**2 * fll * t
            dx1 = dx1 + math.sqrt(2.0) * omega0f * fll * t
        x1 = state.x1 + dx1
        out = 0.5 * (state.x1 + x1) + 2.4 * omega0 * err
        return LoopFilterState(x1, x2), out
    raise ValueError(f"order must be 1, 2 or 3, got {order}")
