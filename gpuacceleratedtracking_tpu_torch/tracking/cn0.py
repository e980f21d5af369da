"""Carrier-to-noise-density estimation from prompt accumulators.

Port of `gpuacceleratedtracking_tpu.tracking.cn0`: the moments (M2M4)
estimator over a fixed-length ring buffer of prompts. The ring-buffer write is
one indexed scatter over the channel axis, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as _device


class CN0State(NamedTuple):
    prompts_re: torch.Tensor  # [..., window]
    prompts_im: torch.Tensor  # [..., window]
    index: torch.Tensor       # [...] int32, count of prompts seen


def init(window: int = 20, device=_device.DEFAULT) -> CN0State:
    device = _device.resolve(device)
    return CN0State(
        torch.zeros(window, dtype=torch.float32, device=device),
        torch.zeros(window, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def update(state: CN0State, prompt_re, prompt_im) -> CN0State:
    window = state.prompts_re.shape[-1]
    slot = torch.remainder(state.index, window).long().unsqueeze(-1)

    def write(buf, value):
        value = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
        return buf.scatter(-1, slot, value.reshape(slot.shape))

    return CN0State(
        write(state.prompts_re, prompt_re),
        write(state.prompts_im, prompt_im),
        state.index + 1,
    )


def estimate(state: CN0State, integration_time) -> torch.Tensor:
    """C/N0 in dB-Hz via the second/fourth-moment method.

    M2 = E[|P|^2], M4 = E[|P|^4];  Pd = sqrt(2 M2^2 - M4)  (signal power),
    Pn = M2 - Pd;  C/N0 = Pd / (Pn * T).
    """
    p2 = state.prompts_re**2 + state.prompts_im**2
    m2 = p2.mean(dim=-1)
    m4 = (p2**2).mean(dim=-1)
    pd = torch.sqrt(torch.clamp(2.0 * m2**2 - m4, min=1e-20))
    pn = torch.clamp(m2 - pd, min=1e-20)
    cn0 = pd / (pn * integration_time)
    return 10.0 * torch.log10(torch.clamp(cn0, min=1e-20))
