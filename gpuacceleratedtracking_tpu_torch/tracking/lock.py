"""Carrier phase-lock detection and data-bit synchronization.

Port of `gpuacceleratedtracking_tpu.tracking.lock`: stateless ``[K]``-vector
math over windows of prompt accumulators, on the device, for a whole channel
bank at once.

- `phase_lock_metric`: the narrowband I/Q power-ratio detector
  ``(I^2 - Q^2) / (I^2 + Q^2)`` per window, an estimate of ``cos(2 dphi)``:
  +1 in phase lock, ~0 unlocked, insensitive to data-bit flips.
- `detect_bit_boundary`: GPS L1 C/A 20 ms data-bit synchronization by the
  sign-transition histogram.
"""

from __future__ import annotations

import torch


def phase_lock_metric(
    prompt_re: torch.Tensor,
    prompt_im: torch.Tensor,
    window: int = 20,
) -> torch.Tensor:
    """Phase-lock indicator in [-1, 1] from ``[B]`` (or ``[B, K]``) prompts.

    Non-overlapping windows of ``window`` blocks each give one ``cos(2 dphi)``
    estimate; returns the per-window series ``[B // window, (K)]``. In-phase
    noise-free prompts give exactly +1; decide lock with a threshold (~0.85).
    """
    p_re = torch.as_tensor(prompt_re, dtype=torch.float32)
    p_im = torch.as_tensor(prompt_im, dtype=torch.float32)
    num_w = p_re.shape[0] // window
    shape = (num_w, window) + tuple(p_re.shape[1:])
    # Squares first: BPSK flips within a window must not cancel the power.
    i2 = (p_re[: num_w * window].reshape(shape) ** 2).sum(dim=1)
    q2 = (p_im[: num_w * window].reshape(shape) ** 2).sum(dim=1)
    return (i2 - q2) / torch.clamp(i2 + q2, min=1e-20)


def detect_bit_boundary(
    prompt_re: torch.Tensor,
    bit_length: int = 20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Find the data-bit edge phase from ``[B]`` / ``[B, K]`` locked prompts.

    Returns ``(offset, confidence)``: block ``b`` starts a new bit iff
    ``(b + offset) % bit_length == 0``. ``confidence`` is the fraction of
    observed sign transitions in the winning histogram bin (1.0 = all agree).
    """
    p = torch.as_tensor(prompt_re, dtype=torch.float32)
    sign_flip = (p[1:] * p[:-1] < 0.0).to(torch.float32)         # [B-1, (K)]
    # A flip between blocks b and b+1 means b+1 is a bit start.
    phase = torch.remainder(torch.arange(1, p.shape[0], device=p.device), bit_length)
    onehot = (phase[:, None] == torch.arange(bit_length, device=p.device)[None, :]
              ).to(torch.float32)                                # [B-1, S]
    votes = torch.tensordot(onehot, sign_flip, dims=([0], [0]))  # [S, (K)]
    start = votes.argmax(dim=0)
    total = torch.clamp(votes.sum(dim=0), min=1e-20)
    confidence = torch.gather(votes, 0, start[None])[0] / total
    offset = torch.remainder(-start, bit_length).to(torch.int32)
    return offset, confidence
