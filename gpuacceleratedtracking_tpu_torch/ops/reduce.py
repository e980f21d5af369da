"""Accumulator reductions over per-sample product planes, by fusion degree.

Port of `gpuacceleratedtracking_tpu.ops.reduce`: the reference's axis of
reduction fusion (pure vs cplx vs cplx_multi). Inputs are SoA planes of
per-sample products ``[N, A, L]``; each reduction returns ``[A, L]`` sums of
both planes.
"""

from __future__ import annotations

import torch

REDUCTIONS = {}


def _register(name):
    def wrap(fn):
        REDUCTIONS[name] = fn
        return fn
    return wrap


@_register("pure")
def reduce_pure(prod_re: torch.Tensor, prod_im: torch.Tensor):
    """One reduction per (I/Q, antenna, tap) component: the unfused floor.

    Each scalar column is summed by its own operation, 2AL of them.
    """
    _, num_a, num_l = prod_re.shape
    acc_re = torch.stack([prod_re[:, a, l].sum() for a in range(num_a)
                          for l in range(num_l)]).reshape(num_a, num_l)
    acc_im = torch.stack([prod_im[:, a, l].sum() for a in range(num_a)
                          for l in range(num_l)]).reshape(num_a, num_l)
    return acc_re, acc_im


@_register("cplx")
def reduce_cplx(prod_re: torch.Tensor, prod_im: torch.Tensor):
    """I/Q fused, one reduction per (antenna, tap)."""
    _, num_a, num_l = prod_re.shape
    acc = torch.stack([
        torch.stack([prod_re[:, a, l], prod_im[:, a, l]], dim=-1).sum(dim=0)
        for a in range(num_a) for l in range(num_l)
    ]).reshape(num_a, num_l, 2)
    return acc[..., 0], acc[..., 1]


@_register("cplx_multi")
def reduce_cplx_multi(prod_re: torch.Tensor, prod_im: torch.Tensor):
    """Fully fused: both planes, all antennas and taps, one reduction each."""
    return prod_re.sum(dim=0), prod_im.sum(dim=0)


def get_reduction(name: str):
    try:
        return REDUCTIONS[name]
    except KeyError:
        raise KeyError(
            f"Unknown reduction {name!r}; known: {sorted(REDUCTIONS)}"
        ) from None
