"""DLL/PLL/FLL discriminators (port of `gpuacceleratedtracking_tpu.tracking.discriminators`).

- PLL: Costas ``atan(Q_P / I_P)`` — insensitive to data-bit flips.
- DLL: normalized noncoherent early-minus-late envelope with spacing-dependent
  gain correction.
- FLL: two-sample cross/dot product frequency discriminator.

All take f32 tensors of any (matching) shape.
"""

from __future__ import annotations

import math

import torch


def pll_costas(prompt_re, prompt_im):
    """Costas phase error in **cycles** (range [-1/4, 1/4])."""
    safe_re = torch.where(prompt_re == 0, 1e-12, prompt_re)
    return torch.atan(prompt_im / safe_re) / (2 * math.pi)


def pll_atan2(prompt_re, prompt_im):
    """Full-range four-quadrant phase error in **cycles** ([-1/2, 1/2])."""
    return torch.atan2(prompt_im, prompt_re) / (2 * math.pi)


def dll_emle(early_re, early_im, late_re, late_im, spacing_chips):
    """Code error in **chips**: ``(E-L)/(E+L) * (2-d)/2`` on the envelopes."""
    e = torch.sqrt(early_re**2 + early_im**2)
    l = torch.sqrt(late_re**2 + late_im**2)
    return (e - l) / torch.clamp(e + l, min=1e-12) * (2.0 - spacing_chips) / 2.0


def fll_atan2(prev_re, prev_im, curr_re, curr_im, dt):
    """Frequency error in **Hz** from two consecutive prompts ``dt`` apart
    (full range +-1/(2 dt); for dataless components only)."""
    cross = prev_re * curr_im - prev_im * curr_re
    dot = prev_re * curr_re + prev_im * curr_im
    return torch.atan2(cross, dot) / (2 * math.pi * dt)


def fll_atan(prev_re, prev_im, curr_re, curr_im, dt):
    """Data-insensitive frequency error in **Hz** (range +-1/(4 dt))."""
    cross = prev_re * curr_im - prev_im * curr_re
    dot = prev_re * curr_re + prev_im * curr_im
    safe = torch.where(torch.abs(dot) < 1e-12, 1e-12, dot)
    return torch.atan(cross / safe) / (2 * math.pi * dt)
