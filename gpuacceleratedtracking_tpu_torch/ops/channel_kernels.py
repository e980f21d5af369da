"""The per-channel correlator kernels' wrappers and their plain versions.

Port of the per-channel half of `gpuacceleratedtracking_tpu.ops.pallas_epl`:
`correlate_pallas_taps` (the reference's 3431 kernel: replica from plain ops
as an ``[L, N]`` tap matrix, carrier NCO, wipe-off and tap MAC in the kernel)
and `correlate_pallas_fused` (the 5431 mega-kernel: the replica too is made
in the kernel, from the PRN's code column). Both take the 11-argument
registry signature for one channel and return ``[L]`` / ``[A, L]`` f32
accumulators.

Each wrapper dispatches on where its tensors lie. CUDA tensors launch the
hand-written kernel (``csrc/taps.cu``, ``csrc/fused.cu``, built at first use
by `_build`) or raise; CPU tensors run the plain version
(`correlate_taps_reference`, `correlate_fused_reference`), the same formula
in PyTorch with the same f32 phase arithmetic. Every launch adds one to the
wrapper's ``launches``.

Phase arithmetic shared by the kernels and the plain versions: the block is
cut into tiles of `TILE` samples; per tile the carrier cycles ``f_cyc * n0``
and code chips ``rho * n0`` at the tile start are computed exactly in float64
from the channel's own rates (``csrc/channel.cuh``), then

    carrier cycles at tile sample j: j * f_cyc + (phi_cyc + f32(frac(f_cyc * n0))),
                                     wrapped to [0, 1)
    phi_code + rho * n0 = c0 + frac    (whole chips added as integers, c0 in [0, Lc))
    chip of tap l at tile sample j:  (floor((j + delta_l) * rho + frac) + c0) mod Lc

each product and sum rounded to f32 on its own (no fused multiply-add). The
channel parameters stay device tensors: nothing here reads a device value
on the host, so a tracking loop never waits on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _build, registry
from .correlate import _tap_matrix
from .epl_kernels import KERNEL_ANTENNAS, KERNEL_TAPS, _channel_params, _deltas
from .replica import _TWO_PI_F32, code_columns, gen_code_replica

TILE = 1024                  # samples per CTA: N = 2048 spans 2 CTAs, N = 2^18 spans 256


class ChannelCall:
    """Everything a per-channel kernel and its plain version take, computed
    once per call from the registry signature's arguments.

    ``kernel`` is ``"taps"`` (the ``[L, N]`` tap matrix is built here, by the
    plain replica path, as the JAX wrapper builds it) or ``"fused"`` (the
    PRN's ``[Lc]`` code column is taken here; the kernel makes the replica).
    The channel parameters are scalars or one-element tensors.
    """

    def __init__(self, signal_re, signal_im, codes, prn, carrier_frequency,
                 sampling_frequency, carrier_phase, code_frequency, code_phase,
                 sample_shifts, code_length, kernel):
        self.kernel = kernel
        self.squeeze = signal_re.ndim == 1
        if self.squeeze:
            signal_re, signal_im = signal_re[None], signal_im[None]
        self.sre, self.sim = signal_re, signal_im
        self.device = signal_re.device
        self.num_ants, self.num_samples = signal_re.shape
        d_min = int(min(sample_shifts))
        self.deltas = tuple(int(d) - d_min for d in sample_shifts)
        self.code_length = int(code_length)
        fs = float(sampling_frequency)
        self.params = _channel_params(carrier_frequency, fs, carrier_phase,
                                      code_frequency, code_phase, d_min,
                                      self.device).reshape(-1)
        if self.params.shape != (4,):
            raise ValueError(
                f"{kernel} correlates one channel; got parameters of "
                f"{self.params.numel() // 4} channels")
        self.num_tiles = -(-self.num_samples // TILE)
        if kernel == "taps":
            rep = gen_code_replica(codes, prn, code_frequency, fs, code_phase,
                                   self.num_samples, d_min, int(max(sample_shifts)),
                                   self.code_length)
            self.replica = _tap_matrix(rep, sample_shifts, self.num_samples)
        elif kernel == "fused":
            self.replica = code_columns(codes, prn).reshape(-1)
        else:
            raise ValueError(f"unknown per-channel kernel {kernel!r}")

    def finish(self, out_re, out_im):
        if self.squeeze:
            return out_re[0], out_im[0]
        return out_re, out_im


def _tile_phases(call: ChannelCall):
    """Per tile ``[tiles]``: carrier cycles at the tile start (f32, not
    wrapped), and the code phase at the tile start as whole chips in
    ``[0, Lc)`` (int64) and a fraction (f32) — ``csrc/channel.cuh``'s
    `tile_carrier` and `tile_code`."""
    f_cyc, phi_cyc, rho, phi_code = call.params.unbind()
    n0 = torch.arange(call.num_tiles, dtype=torch.float64, device=call.device) * TILE
    car = f_cyc.double() * n0
    ph_car = phi_cyc + (car - torch.floor(car)).float()
    lc = float(call.code_length)
    code = rho.double() * n0
    base_whole = torch.floor(code)
    base_frac = (code - base_whole).float()
    base_whole = base_whole - torch.floor(base_whole / lc) * lc
    phi_whole = torch.floor(phi_code)
    frac = (phi_code - phi_whole) + base_frac
    f_whole = torch.floor(frac)
    chip0 = torch.remainder(base_whole.long() + phi_whole.long() + f_whole.long(),
                            call.code_length)
    return ph_car, chip0, frac - f_whole


def _wipe_off(call: ChannelCall, ph_car: torch.Tensor):
    """``[A, tiles, TILE]`` wiped-off planes over the zero-padded block."""
    nt = call.num_tiles
    pad = nt * TILE - call.num_samples
    s_re = torch.nn.functional.pad(call.sre, (0, pad)).view(call.num_ants, nt, TILE)
    s_im = torch.nn.functional.pad(call.sim, (0, pad)).view(call.num_ants, nt, TILE)
    j = torch.arange(TILE, dtype=torch.float32, device=call.device)
    cyc = j * call.params[0] + ph_car[:, None]                           # [nt, T]
    cyc = cyc - torch.floor(cyc)
    theta = cyc * _TWO_PI_F32              # an f32 multiply: the scalar is f32(2 pi)
    cos, sin = torch.cos(theta), torch.sin(theta)
    return s_re * cos + s_im * sin, s_im * cos - s_re * sin


def _taps_plain(call: ChannelCall) -> tuple[torch.Tensor, torch.Tensor]:
    ph_car, _, _ = _tile_phases(call)
    dw_re, dw_im = (x.reshape(call.num_ants, -1)[:, :call.num_samples]
                    for x in _wipe_off(call, ph_car))
    return (torch.einsum("an,ln->al", dw_re, call.replica),
            torch.einsum("an,ln->al", dw_im, call.replica))


def _fused_plain(call: ChannelCall) -> tuple[torch.Tensor, torch.Tensor]:
    ph_car, chip0, frac = _tile_phases(call)
    dw_re, dw_im = _wipe_off(call, ph_car)
    j = torch.arange(TILE, dtype=torch.float32, device=call.device)
    rho = call.params[2]
    shape = (call.num_ants, len(call.deltas))
    out_re = torch.empty(shape, dtype=torch.float32, device=call.device)
    out_im = torch.empty_like(out_re)
    for l, delta in enumerate(call.deltas):
        x = (j + float(delta)) * rho + frac[:, None]                     # [nt, T]
        chip = torch.floor(x).long() + chip0[:, None]
        rep = call.replica[torch.remainder(chip, call.code_length)]
        out_re[:, l] = (dw_re * rep).sum(dim=(-2, -1))
        out_im[:, l] = (dw_im * rep).sum(dim=(-2, -1))
    return out_re, out_im


_PLAIN = {"taps": _taps_plain, "fused": _fused_plain}


def _check_kernel_inputs(call: ChannelCall) -> None:
    tensors = {"signal_re": call.sre, "signal_im": call.sim,
               "replica": call.replica, "params": call.params}
    for name, t in tensors.items():
        if t.device != call.device:
            raise ValueError(f"{name} is on {t.device}, the signal on {call.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if call.sim.shape != call.sre.shape:
        raise ValueError(f"signal planes differ: {tuple(call.sre.shape)} vs "
                         f"{tuple(call.sim.shape)}")
    if call.num_ants not in KERNEL_ANTENNAS or len(call.deltas) not in KERNEL_TAPS:
        raise ValueError(
            f"{call.kernel} kernel takes A in {KERNEL_ANTENNAS} and L in "
            f"{KERNEL_TAPS}, got A={call.num_ants}, L={len(call.deltas)}"
        )
    want = ((len(call.deltas), call.num_samples) if call.kernel == "taps"
            else (call.code_length,))
    if call.replica.shape != want:
        raise ValueError(f"replica shape {tuple(call.replica.shape)} != {want}")
    if call.num_samples >= 1 << 24:
        raise ValueError(f"{call.kernel} kernel takes N < 2^24")


def _launch(call: ChannelCall, kernel: str) -> tuple[torch.Tensor, torch.Tensor]:
    if call.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, not {call.device}")
    if call.kernel != kernel:
        raise ValueError(f"a call prepared for {call.kernel!r} cannot launch {kernel!r}")
    _check_kernel_inputs(call)
    lib = _build.load_library(kernel)
    num_taps = len(call.deltas)
    out = torch.empty((2, call.num_ants, num_taps), dtype=torch.float32, device=call.device)
    # Per-tile partials, then one zeroed word: the kernel's finish counter.
    scratch = torch.zeros(call.num_tiles * 2 * call.num_ants * num_taps + 1,
                          dtype=torch.float32, device=call.device)
    stream = torch.cuda.current_stream(call.device).cuda_stream
    if kernel == "taps":
        err = lib.taps_launch(
            call.sre.data_ptr(), call.sim.data_ptr(), call.replica.data_ptr(),
            call.params.data_ptr(), scratch.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), call.num_ants, num_taps, call.num_samples, TILE, stream)
    else:
        err = lib.fused_launch(
            call.sre.data_ptr(), call.sim.data_ptr(), call.replica.data_ptr(),
            call.params.data_ptr(), _deltas(call.deltas, call.device).data_ptr(),
            scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            call.num_ants, num_taps, call.num_samples, call.code_length, TILE, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}_launch failed with CUDA error {err}")
    return out[0], out[1]


def launch_taps(call: ChannelCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/taps.cu`` for a prepared ``kernel="taps"`` call on CUDA
    tensors. Returns ``[A, L]`` accumulators and adds one to
    ``correlate_pallas_taps.launches``; raises on anything the kernel does not
    take, and if the launch fails."""
    out = _launch(call, "taps")
    correlate_pallas_taps.launches += 1
    return out


def launch_fused(call: ChannelCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fused.cu`` for a prepared ``kernel="fused"`` call on CUDA
    tensors. Returns ``[A, L]`` accumulators and adds one to
    ``correlate_pallas_fused.launches``; raises on anything the kernel does
    not take, and if the launch fails."""
    out = _launch(call, "fused")
    correlate_pallas_fused.launches += 1
    return out


_LAUNCH = {"taps": launch_taps, "fused": launch_fused}


def _run(call: ChannelCall) -> tuple[torch.Tensor, torch.Tensor]:
    if call.device.type == "cpu":
        return call.finish(*_PLAIN[call.kernel](call))
    if call.device.type != "cuda":
        raise ValueError(f"{call.kernel} runs on CPU or CUDA tensors, not {call.device}")
    return call.finish(*_LAUNCH[call.kernel](call))


def correlate_taps_reference(
    signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
    carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `correlate_pallas_taps`, on any device."""
    call = ChannelCall(signal_re, signal_im, codes, prn, carrier_frequency,
                       sampling_frequency, carrier_phase, code_frequency,
                       code_phase, sample_shifts, code_length, "taps")
    return call.finish(*_taps_plain(call))


def correlate_fused_reference(
    signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
    carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `correlate_pallas_fused`, on any device."""
    call = ChannelCall(signal_re, signal_im, codes, prn, carrier_frequency,
                       sampling_frequency, carrier_phase, code_frequency,
                       code_phase, sample_shifts, code_length, "fused")
    return call.finish(*_fused_plain(call))


def correlate_pallas_taps(
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
    """One channel: the replica from the plain path as an ``[L, N]`` tap
    matrix; carrier NCO, wipe-off and tap MAC in ``csrc/taps.cu``.

    ``signal_*``: ``[N]`` or ``[A, N]``. Returns ``[L]`` / ``[A, L]`` f32
    accumulators. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise.
    """
    return _run(ChannelCall(signal_re, signal_im, codes, prn, carrier_frequency,
                            sampling_frequency, carrier_phase, code_frequency,
                            code_phase, sample_shifts, code_length, "taps"))


def correlate_pallas_fused(
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
    """One channel fully fused in ``csrc/fused.cu``: code replica, carrier
    NCO, wipe-off and tap MAC, at any tap span.

    ``signal_*``: ``[N]`` or ``[A, N]``. Returns ``[L]`` / ``[A, L]`` f32
    accumulators. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise.
    """
    return _run(ChannelCall(signal_re, signal_im, codes, prn, carrier_frequency,
                            sampling_frequency, carrier_phase, code_frequency,
                            code_phase, sample_shifts, code_length, "fused"))


correlate_pallas_taps.launches = 0
correlate_pallas_fused.launches = 0

registry.register("pallas_taps", correlate_pallas_taps)
registry.register("pallas_fused", correlate_pallas_fused)
