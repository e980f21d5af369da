"""The port's default device: the card.

The constructors that make tensors from host values (`models.gen_signal`,
`models.gen_signal_mixed`, `models.gen_carrier`, `tracking.init_state`,
`tracking.state_from_numpy`,
`tracking.cn0.init`, `tracking.loop_filter.init`) take ``device="cuda"`` by
default and raise where there is no card; they never fall back to the CPU. A
CPU run asks for it with ``device="cpu"``. Functions that take tensors follow
their inputs' device.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a `torch.device`; raises for a CUDA device without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA device and torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU"
        )
    return device
