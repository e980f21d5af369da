"""Plain tensor correlation paths: downconvert (carrier wipe-off) + EPL MAC.

Port of `gpuacceleratedtracking_tpu.ops.correlate`: the straightforward
PyTorch versions that the bank kernel is held against.

- ``correlate_fused``   — carrier NCO, wipe-off, code replica and tap MACs for
  one channel, or for ``[K]`` channels at once when the channel parameters are
  ``[K]`` tensors.
- ``correlate_xla_bank`` — the bank signature: ``[K]`` channel parameters
  against one shared block, as an explicit batch over ``[K]`` (chunked so
  K=1024 fits in memory).

The tap MAC is a float32 ``einsum`` (TF32 is off for float32 matmuls unless
``torch.backends.cuda.matmul.allow_tf32`` is set).
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import replica as replica_ops

# Bound on the elements of one [K, L, N] tap tensor per chunk (~256 MiB f32).
_CHUNK_ELEMENTS = 1 << 26


def downconvert(signal_re, signal_im, carrier_cos, carrier_sin):
    """Carrier wipe-off ``dw = signal * conj(carrier)`` on SoA planes.

    ``dw_re = s_re*c + s_im*s;  dw_im = s_im*c - s_re*s``. The carrier
    broadcasts over any antenna axis of the signal.
    """
    dw_re = signal_re * carrier_cos + signal_im * carrier_sin
    dw_im = signal_im * carrier_cos - signal_re * carrier_sin
    return dw_re, dw_im


def _tap_matrix(code_replica: torch.Tensor, sample_shifts: Sequence[int],
                num_samples: int) -> torch.Tensor:
    """Stack tap views of the haloed replica into ``[..., L, N]``."""
    d0 = int(min(sample_shifts))
    return torch.stack(
        [code_replica[..., int(d) - d0: int(d) - d0 + num_samples]
         for d in sample_shifts],
        dim=-2,
    )


def epl_accumulate(dw_re, dw_im, code_replica, sample_shifts):
    """Tap-shifted MAC ``accum[.., a, l] = sum_n dw[.., a, n] * rep[.., n + d_l - d_min]``.

    ``dw_*``: ``[..., A, N]`` or ``[..., N]`` with the replica's leading axes;
    returns ``[..., A, L]`` / ``[..., L]``.
    """
    num_samples = dw_re.shape[-1]
    taps = _tap_matrix(code_replica, sample_shifts, num_samples)   # [..., L, N]
    single_ant = dw_re.ndim == taps.ndim - 1

    def contract(x):
        if single_ant:
            return torch.einsum("...n,...ln->...l", x, taps)
        return torch.einsum("...an,...ln->...al", x, taps)

    return contract(dw_re), contract(dw_im)


def correlate_fused(
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    codes: torch.Tensor,
    prn,
    carrier_frequency,
    sampling_frequency,
    carrier_phase,
    code_frequency,
    code_phase,
    sample_shifts: Sequence[int],
    code_length: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Downconvert + correlate one channel (or a ``[K]`` batch of channels).

    ``signal_*``: ``[N]`` or ``[A, N]``. Returns ``(accum_re, accum_im)`` of
    shape ``[..., L]`` / ``[..., A, L]``, the leading axes those of the
    channel parameters.
    """
    num_samples = signal_re.shape[-1]
    device = signal_re.device
    cos, sin = replica_ops.gen_carrier_replica(
        carrier_frequency, sampling_frequency, carrier_phase, num_samples, device
    )
    if signal_re.ndim == 2:                      # [A, N]: carrier over antennas
        cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)
    dw_re, dw_im = downconvert(signal_re, signal_im, cos, sin)
    code_rep = replica_ops.gen_code_replica(
        codes, prn, code_frequency, sampling_frequency, code_phase,
        num_samples, int(min(sample_shifts)), int(max(sample_shifts)),
        code_length,
    )
    return epl_accumulate(dw_re, dw_im, code_rep, sample_shifts)


def correlate_xla_bank(
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    codes: torch.Tensor,
    prn: torch.Tensor,
    carrier_frequency: torch.Tensor,
    sampling_frequency,
    carrier_phase: torch.Tensor,
    code_frequency: torch.Tensor,
    code_phase: torch.Tensor,
    sample_shifts: Sequence[int],
    code_length: int,
    **_unused,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bank-signature plain correlator: ``[K]`` channel parameters, shared signal.

    Returns ``[K, L]`` or ``[K, A, L]``. Channels run as a batch, chunked so
    the ``[K, L, N]`` tap tensor stays under ~256 MiB.
    """
    device = signal_re.device
    params = [torch.as_tensor(x, device=device) for x in
              (prn, carrier_frequency, carrier_phase, code_frequency, code_phase)]
    num_k = params[0].shape[0]
    per_chunk = max(1, _CHUNK_ELEMENTS // (len(sample_shifts) * signal_re.numel()))
    outs_re, outs_im = [], []
    for k0 in range(0, num_k, per_chunk):
        p, f_car, phi_car, f_code, phi_code = (x[k0:k0 + per_chunk] for x in params)
        are, aim = correlate_fused(
            signal_re, signal_im, codes, p, f_car, sampling_frequency,
            phi_car, f_code, phi_code, sample_shifts, code_length,
        )
        outs_re.append(are)
        outs_im.append(aim)
    return torch.cat(outs_re), torch.cat(outs_im)
