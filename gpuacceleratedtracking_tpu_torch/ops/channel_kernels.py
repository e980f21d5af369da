"""The per-channel correlator kernels' wrappers and their plain versions.

Port of the per-channel half of `gpuacceleratedtracking_tpu.ops.pallas_epl`:
`correlate_pallas_taps` (the reference's 3431 kernel: replica from plain ops
as an ``[L, N]`` tap matrix, carrier NCO, wipe-off and tap MAC in the kernel)
and `correlate_pallas_fused` (the 5431 mega-kernel: the replica too is made
in the kernel, from the PRN's code column). Both take the 11-argument
registry signature for one channel and return ``[L]`` / ``[A, L]`` f32
accumulators.

The kernels are instantiated for A <= 4 antennas and L in {3, 5, 7} taps; a
call outside them is split into launches that are (`epl_kernels.launch_groups`).

Each wrapper dispatches on where its tensors lie. CUDA tensors launch the
hand-written kernel (``csrc/taps.cu``, ``csrc/fused.cu``, built at first use
by `_build`) or raise; CPU tensors run the plain version
(`correlate_taps_reference`, `correlate_fused_reference`), the same formula
in PyTorch with the same f32 phase arithmetic. Every launch adds one to the
wrapper's ``launches``.

Launch contract: a `pallas_fused` call is one device op, the kernel. The
kernel takes the raw channel parameters (Python scalars by value, one-element
device tensors by pointer), derives ``(f_cyc, phi_cyc, rho, phi_code)`` with
the roundings of `_channel_params`, reads the PRN's column from the code
table itself, and takes the tap offsets by value; its scratch comes from a
cache (`_scratch`). A `pallas_taps` call is two device ops: the replica
kernel (``csrc/replica.cu``, `replica_kernel.launch_replica`, the
counterpart of XLA's fusion of the JAX wrapper's replica build), which
writes the ``[L, N]`` tap matrix (per launch group, its own rows: `_tap_rows`),
and the taps kernel. The plain taps version builds its tap matrix with the
plain replica ops on every device (`ChannelCall.replica`), so the card's
kernels are held against a version that runs neither. Nothing here reads a
device value on the host or copies a host value to the card, so a tracking
loop never waits on the card.

Phase arithmetic shared by the kernels and the plain versions: the block is
cut into tiles of `TILE` samples; per tile the carrier cycles ``f_cyc * n0``
and code chips ``rho * n0`` at the tile start are computed exactly in float64
from the channel's own rates (``csrc/channel.cuh``), then

    carrier cycles at tile sample j: j * f_cyc + (phi_cyc + f32(frac(f_cyc * n0))),
                                     wrapped to [0, 1)
    phi_code + rho * n0 = c0 + frac    (whole chips added as integers, c0 in [0, Lc))
    replica row of the tile:  chip(m) = (floor(m * rho + frac) + c0) mod Lc, m >= 0
    tap l at tile sample j reads chip(j + delta_l)

each product and sum rounded to f32 on its own (no fused multiply-add). The
row is the per-tap formula ``floor((j + delta_l) * rho + frac)`` evaluated
once per position; ``j + delta_l`` is an exact small integer, so both round
alike, bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from . import _build, registry, replica_kernel
from .epl_kernels import _channel_params, split_launches
from .replica import _TWO_PI_F32, code_columns
from .replica_kernel import _param_arg, _prn_arg, tap_matrix_plain

TILE = 1024                  # samples per phase tile and CTA: N = 2^18 spans 256 CTAs
MAX_CLUSTER = 16             # a channel of up to 16 tiles is one thread block cluster
CLUSTER = 8                  # larger channels: clusters of 8, one partial each
_SCRATCH_HEAD = 4            # floats before the partials: the finish counter, padded


@dataclasses.dataclass(frozen=True)
class Split:
    """How a launch covers a channel's tiles: CTA ``b`` (256 threads) takes
    tile ``b`` (CTAs past the last tile add zeros), and each ``cluster``
    consecutive CTAs form a thread block cluster."""
    tiles: int
    grid: int
    cluster: int

    @property
    def clusters(self) -> int:
        return self.grid // self.cluster


def work_split(num_samples: int) -> Split:
    """The kernels' work split for ``num_samples`` samples, one tile per
    CTA. Up to `MAX_CLUSTER` tiles are one cluster (a power of two of CTAs),
    whose CTAs sum through distributed shared memory and write the result.
    Past that, clusters of `CLUSTER`, which leave one partial each for the
    last cluster to sum (at N = 2^18, 256 CTAs: two per SM of an H100)."""
    tiles = -(-int(num_samples) // TILE)
    if tiles < 1:
        raise ValueError("a per-channel kernel needs at least one sample")
    cluster = 1 << (tiles - 1).bit_length() if tiles <= MAX_CLUSTER else CLUSTER
    return Split(tiles, -(-tiles // cluster) * cluster, cluster)


def _one_channel(kernel, *params) -> None:
    """Raise unless every channel parameter holds one value."""
    for p in params:
        if isinstance(p, torch.Tensor) and p.numel() != 1:
            raise ValueError(f"{kernel} correlates one channel; got parameters of "
                             f"{p.numel()} channels")


class ChannelCall:
    """Everything a per-channel kernel and its plain version take, from the
    registry signature's arguments.

    ``kernel`` is ``"taps"`` (the ``[L, N]`` tap matrix is built from the
    code table, as the JAX wrapper builds it: by ``csrc/replica.cu`` in the
    launch, by the plain replica ops in the plain version, `replica`) or
    ``"fused"`` (the kernel makes the replica from the code table). The
    channel parameters are scalars or one-element tensors and stay as given:
    the kernels derive their f32 parameters themselves, and the plain
    versions' `params`, `column` and `replica` are computed on first use.
    """

    def __init__(self, signal_re, signal_im, codes, prn, carrier_frequency,
                 sampling_frequency, carrier_phase, code_frequency, code_phase,
                 sample_shifts, code_length, kernel):
        if kernel not in ("taps", "fused"):
            raise ValueError(f"unknown per-channel kernel {kernel!r}")
        self.kernel = kernel
        self.squeeze = signal_re.ndim == 1
        if self.squeeze:
            signal_re, signal_im = signal_re[None], signal_im[None]
        self.sre, self.sim = signal_re, signal_im
        self.device = signal_re.device
        self.num_ants, self.num_samples = signal_re.shape
        self.codes, self.prn = codes, prn
        self.carrier_frequency, self.carrier_phase = carrier_frequency, carrier_phase
        self.code_frequency, self.code_phase = code_frequency, code_phase
        _one_channel(kernel, prn, carrier_frequency, carrier_phase, code_frequency,
                     code_phase)
        self.shifts = tuple(int(d) for d in sample_shifts)
        self.d_min = min(self.shifts)
        self.deltas = tuple(d - self.d_min for d in self.shifts)
        self.span = max(self.deltas)
        self.code_length = int(code_length)
        self.fs = float(sampling_frequency)
        self.num_tiles = -(-self.num_samples // TILE)
        # taps: each launch group's tap matrix from csrc/replica.cu, made at the
        # call's first launch (`_tap_rows`); a prepared call launched again
        # runs the taps kernel alone.
        self.tap_tables = {}

    @functools.cached_property
    def params(self) -> torch.Tensor:
        """``[4]`` f32 ``(f_cyc, phi_cyc, rho, phi_code)`` (`_channel_params`),
        for the plain versions."""
        return _channel_params(self.carrier_frequency, self.fs, self.carrier_phase,
                               self.code_frequency, self.code_phase, self.d_min,
                               self.device).reshape(-1)

    @functools.cached_property
    def replica(self) -> torch.Tensor:
        """The ``[L, N]`` tap matrix from the plain replica ops, on any device,
        for the plain taps version."""
        return tap_matrix_plain(self.codes, self.prn, self.code_frequency, self.fs,
                                self.code_phase, self.num_samples, self.shifts,
                                self.code_length)

    @functools.cached_property
    def column(self) -> torch.Tensor:
        """The PRN's ``[Lc]`` code column, for the plain fused version."""
        return code_columns(self.codes, self.prn).reshape(-1)

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


def _replica_row(call: ChannelCall, chip0: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """``[tiles, TILE + span]`` chip indices of the tiles' replica rows,
    ``(floor(m * rho + frac) + c0) mod Lc`` at position m — ``csrc/fused.cu``'s
    row; tap l at tile sample j reads position ``j + delta_l``."""
    m = torch.arange(TILE + call.span, dtype=torch.float32, device=call.device)
    x = m * call.params[2] + frac[:, None]
    return torch.remainder(torch.floor(x).long() + chip0[:, None], call.code_length)


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
    row = call.column[_replica_row(call, chip0, frac)]                   # [nt, T + span]
    shape = (call.num_ants, len(call.deltas))
    out_re = torch.empty(shape, dtype=torch.float32, device=call.device)
    out_im = torch.empty_like(out_re)
    for l, delta in enumerate(call.deltas):
        rep = row[:, delta:delta + TILE]
        out_re[:, l] = (dw_re * rep).sum(dim=(-2, -1))
        out_im[:, l] = (dw_im * rep).sum(dim=(-2, -1))
    return out_re, out_im


_PLAIN = {"taps": _taps_plain, "fused": _fused_plain}


def _check_kernel_inputs(call: ChannelCall) -> None:
    tensors = {"signal_re": call.sre, "signal_im": call.sim, "codes": call.codes}
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
    if call.codes.ndim != 2 or call.codes.shape[0] != call.code_length:
        raise ValueError(f"codes must be [Lc={call.code_length}, P], got "
                         f"{tuple(call.codes.shape)}")
    if not 0 < call.num_samples < 1 << 24:
        raise ValueError(f"{call.kernel} kernel takes 0 < N < 2^24")


# Scratch of eager launches per (device, stream, size), and of the launches
# of the CUDA graph capture under way per (device, stream, size, capture id):
# word 0 is the finish counter, which a launch finds at zero and leaves at
# zero, then the per-cluster partials.
_SCRATCH: dict = {}
_CAPTURE_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int, capture: int, num_floats: int) -> torch.Tensor:
    """The zeroed scratch of a launch on ``stream`` that takes ``num_floats``,
    under the CUDA graph capture ``capture`` (0: none).

    Two kernels running at once must not share a scratch: both would count
    on word 0 and overwrite each other's partials. Launches on one stream run
    one after the other, so eager launches share one buffer per stream. A
    captured launch runs wherever and whenever its graph is replayed, beside
    other graphs captured on the same stream, so each capture takes buffers
    of its own, made and zeroed inside the capture (one zero fill in the
    graph per stream and size). They lie in the graph's private memory pool,
    which holds them for as long as the graph lives, so only the latest
    capture keeps them here: the next capture drops them.
    """
    if capture:
        if any(key[3] != capture for key in _CAPTURE_SCRATCH):
            _CAPTURE_SCRATCH.clear()
        cache, key = _CAPTURE_SCRATCH, (device, stream, num_floats, capture)
    else:
        cache, key = _SCRATCH, (device, stream, num_floats)
    buf = cache.get(key)
    if buf is None:
        buf = cache[key] = torch.zeros(num_floats, dtype=torch.float32, device=device)
    return buf


@functools.lru_cache(maxsize=64)
def _deltas_arg(deltas: tuple) -> ctypes.Array:
    return (ctypes.c_int * len(deltas))(*deltas)


def _launch(call: ChannelCall, kernel: str):
    if call.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, not {call.device}")
    if call.kernel != kernel:
        raise ValueError(f"a call prepared for {call.kernel!r} cannot launch {kernel!r}")
    _check_kernel_inputs(call)
    split = work_split(call.num_samples)
    lib = _build.load_library(kernel)
    # The current stream's handle (what torch.cuda.current_stream(device)
    # .cuda_stream gives, without building a Stream object per call).
    stream = torch._C._cuda_getCurrentRawStream(call.device.index)
    keep = []
    fcar = _param_arg(call.carrier_frequency, call.device, keep)
    phicar = _param_arg(call.carrier_phase, call.device, keep)
    if kernel == "fused":
        prn = _prn_arg(call.prn, call.device, call.codes.shape[1], keep)
        fcode = _param_arg(call.code_frequency, call.device, keep)
        phicode = _param_arg(call.code_phase, call.device, keep)
    counter = _WRAPPERS[kernel]

    def launch(a0, a1, taps):
        # Antennas a0:a1 against the taps indexed by `taps` (taps: the tap
        # matrix's rows of those taps), with the call's phase origin d_min:
        # the unsplit call's chips.
        num_ants, num_taps = a1 - a0, len(taps)
        out = torch.empty((2, num_ants, num_taps), dtype=torch.float32, device=call.device)
        scratch = 0                        # a one-cluster grid takes none
        if split.clusters > 1:
            scratch = _scratch(call.device, stream, lib.channel_capture_id(stream),
                               _SCRATCH_HEAD + split.clusters * 2 * num_ants * num_taps
                               ).data_ptr()
        row = 4 * a0 * call.num_samples                  # bytes to antenna a0's plane
        sre, sim = call.sre.data_ptr() + row, call.sim.data_ptr() + row
        if kernel == "taps":
            table = call.tap_tables.get(taps)
            if table is None:
                table = call.tap_tables[taps] = _tap_rows(call, taps)
            rows = (sre, sim, table.data_ptr())
        else:
            table, rows = call.codes, (sre, sim)
        vec = int(call.num_samples % 4 == 0 and all(ptr % 16 == 0 for ptr in rows))
        if kernel == "taps":
            err = lib.taps_launch(
                sre, sim, table.data_ptr(), out.data_ptr(), scratch,
                fcar[0], phicar[0], fcar[1], phicar[1], call.fs, num_ants, num_taps,
                call.num_samples, vec, split.grid, split.cluster, stream)
        else:
            err = lib.fused_launch(
                sre, sim, table.data_ptr(), out.data_ptr(), scratch,
                prn[0], fcar[0], phicar[0], fcode[0], phicode[0], prn[1], prn[2], fcar[1],
                phicar[1], fcode[1], phicode[1], call.fs,
                _deltas_arg(tuple(call.deltas[i] for i in taps)), call.d_min,
                num_ants, num_taps, call.num_samples, call.code_length, table.shape[1], vec,
                split.grid, split.cluster, stream)
        if err != 0:
            raise RuntimeError(f"{kernel}_launch failed with CUDA error {err}")
        counter.launches += 1
        return out.unbind(0)

    return split_launches(launch, call.num_ants, len(call.deltas), (), call.device)


def _tap_rows(call: ChannelCall, taps: tuple) -> torch.Tensor:
    """The ``[len(taps), N]`` tap matrix of a launch group's tap indices
    (a padded group repeats its last tap), from one launch of
    ``csrc/replica.cu``: row r holds the chips of samples ``n + shift`` of
    tap ``taps[r]``, the same chips as that row of the whole call's matrix."""
    return replica_kernel.launch_replica(
        call.codes, call.prn, call.code_frequency, call.fs, call.code_phase,
        [call.shifts[i] for i in taps], call.num_samples, call.d_min, call.code_length)


def _tap_rows_plain(call: ChannelCall, taps: tuple) -> torch.Tensor:
    """The plain version of `_tap_rows`, from the plain replica ops."""
    return tap_matrix_plain(call.codes, call.prn, call.code_frequency, call.fs,
                            call.code_phase, call.num_samples, [call.shifts[i] for i in taps],
                            call.code_length)


def launch_taps(call: ChannelCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/taps.cu`` for a prepared ``kernel="taps"`` call on CUDA
    tensors. Returns ``[A, L]`` accumulators and adds one to
    ``correlate_pallas_taps.launches`` per launch (one inside the kernel's
    instantiations, else one per group of `epl_kernels.launch_groups`). The
    call's first launch writes each tap group's tap matrix with one launch
    of ``csrc/replica.cu`` (`_tap_rows`). Raises on anything the kernels do
    not take, and if a launch fails."""
    return _launch(call, "taps")


def launch_fused(call: ChannelCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fused.cu`` for a prepared ``kernel="fused"`` call on CUDA
    tensors. Returns ``[A, L]`` accumulators and adds one to
    ``correlate_pallas_fused.launches`` per launch, as `launch_taps`; raises
    on anything the kernel does not take, and if a launch fails."""
    return _launch(call, "fused")


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
    """One channel: the code replica as an ``[L, N]`` tap matrix from
    ``csrc/replica.cu``; carrier NCO, wipe-off and tap MAC in ``csrc/taps.cu``.

    ``signal_*``: ``[N]`` or ``[A, N]``. Returns ``[L]`` / ``[A, L]`` f32
    accumulators. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise. The kernel's scratch is cached as `_scratch` says.
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
    kernel or raise. On the card a call is one device op: the kernel reads
    the raw channel parameters (device tensors by pointer) and the PRN's
    column itself. Its scratch, a finish counter that every launch leaves at
    zero and the per-cluster partials (a channel of more than 16 tiles), is
    cached per (device, stream, size) for eager launches and per capture for
    launches captured in a CUDA graph (`_scratch`): two kernels that may run
    at once, on two streams or in two graphs, never share one, since both
    would count on the one counter and overwrite each other's partials.
    """
    return _run(ChannelCall(signal_re, signal_im, codes, prn, carrier_frequency,
                            sampling_frequency, carrier_phase, code_frequency,
                            code_phase, sample_shifts, code_length, "fused"))


correlate_pallas_taps.launches = 0
correlate_pallas_fused.launches = 0
_WRAPPERS = {"taps": correlate_pallas_taps, "fused": correlate_pallas_fused}

registry.register("pallas_taps", correlate_pallas_taps)
registry.register("pallas_fused", correlate_pallas_fused)
