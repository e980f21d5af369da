"""Secondary-code (overlay) synchronization.

Port of `gpuacceleratedtracking_tpu.tracking.secondary`. Overlay codes (L5
Neuman-Hofman NH10/NH20) flip the prompt accumulator's sign once per primary
code period; before coherent integration beyond one period, the receiver finds
the overlay phase from a window of prompts by cyclic sign correlation, on the
device, over a whole channel bank at once.
"""

from __future__ import annotations

import numpy as np
import torch


def detect_secondary_offset(
    prompt_re: torch.Tensor,
    secondary_code,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Find the overlay phase from tracked prompts.

    Args:
      prompt_re: ``[B]`` (or ``[B, K]``) in-phase prompt accumulators from
        ``B`` consecutive locked blocks (one per primary code period).
      secondary_code: ``[S]`` +/-1 overlay signs.

    Returns:
      (offset, confidence): ``offset`` (int32, per channel) such that block
      ``b`` carries overlay sign ``secondary_code[(b + offset) % S]``;
      ``confidence`` is the normalized correlation magnitude of the best
      offset in [0, 1] (1 = perfect sign match over the window).
    """
    p = torch.as_tensor(prompt_re, dtype=torch.float32)
    sc = torch.as_tensor(np.asarray(secondary_code, np.float32), device=p.device)
    s, b = sc.shape[0], p.shape[0]
    idx = (torch.arange(b, device=p.device)[None, :]
           + torch.arange(s, device=p.device)[:, None]) % s      # [S, B]
    corr = torch.tensordot(sc[idx], p, dims=([1], [0]))          # [S, ...]
    best, offset = corr.abs().max(dim=0)
    norm = p.abs().sum(dim=0)
    confidence = torch.where(norm > 0, best / norm, torch.zeros_like(best))
    return offset.to(torch.int32), confidence


def detect_secondary_offset_windowed(
    prompt_re: torch.Tensor,
    secondary_code,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Data-robust overlay sync for signals with nav bits but no pilot.

    A nav-bit sign flip inside the window decorrelates
    `detect_secondary_offset`. When bit edges are aligned to overlay-cycle
    boundaries, at least one of the ``S`` single-cycle window phases is
    bit-clean: each phase's length-``S`` window is correlated on its own, and
    per channel the phase with the highest confidence wins.

    Limitation (kept for parity with the JAX function): only the first
    ``2S - 1`` blocks of ``prompt_re`` are used; later blocks are ignored, so
    a longer window buys no extra SNR.

    Args:
      prompt_re: ``[B]`` or ``[B, K]`` prompts from consecutive locked
        blocks, ``B >= 2 S - 1`` so every window phase has a full window.
      secondary_code: ``[S]`` +/-1 overlay signs.

    Returns:
      (offset, confidence) with the convention of `detect_secondary_offset`.
    """
    p = torch.as_tensor(prompt_re, dtype=torch.float32)
    s = len(secondary_code)
    if p.shape[0] < 2 * s - 1:
        raise ValueError(
            f"need >= {2 * s - 1} blocks for S={s} window phases, got {p.shape[0]}"
        )
    found = [detect_secondary_offset(p[w: w + s], secondary_code) for w in range(s)]
    offs = torch.stack([o for o, _ in found]).long()             # [S, ...]
    confs = torch.stack([c for _, c in found])
    # Window phase w sees local offset o_w; globally sign(b) = sc[(b - w + o_w) % S].
    shift = torch.arange(s, device=p.device).reshape((s,) + (1,) * (offs.ndim - 1))
    offs = torch.remainder(offs - shift, s)
    best_w = confs.argmax(dim=0, keepdim=True)
    offset = torch.gather(offs, 0, best_w)[0].to(torch.int32)
    confidence = torch.gather(confs, 0, best_w)[0]
    return offset, confidence
