"""The code-replica kernel's wrappers and their plain versions.

The JAX package has no Pallas kernel for the replica: XLA fuses
`gen_code_replica` (or `gen_code_replica_quantized`) and the tap matrix built
from it into the program around `correlate_pallas_taps`. Here that fusion is
``csrc/replica.cu``, for one channel (a scalar PRN), written as the haloed
row ``[N + span]`` (`code_replica`) or as the ``[L, N]`` tap matrix the taps
kernel reads (`code_tap_matrix`), f32 like the plain path: one launch for
every row whose offsets lie within `MAX_SPAN` of each other
(`launch_plan`), since a launch reads all of its rows from one haloed tile
of chips.

Each wrapper dispatches on where the code table lies: CUDA launches the
kernel or raises, the CPU runs the plain version (`replica.gen_code_replica`
/ `gen_code_replica_quantized`, with `correlate._tap_matrix` for the tap
matrix), which the kernel matches bit for bit on the card. The kernel takes
the raw channel parameters (Python scalars by value, one-element CUDA
tensors by pointer), so a call copies nothing to the card and reads nothing
back. Every launch, either layout, adds one to ``code_replica.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build
from .correlate import _tap_matrix
from .replica import gen_code_replica, gen_code_replica_quantized

MODES = ("exact", "quantized")
MAX_ROWS = 64                # rows per launch: the kernel's offsets come by value
MAX_SPAN = 1024              # largest offset less the smallest, per launch: the shared halo


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"replica mode is one of {MODES}, not {mode!r}")


def replica_plain(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                  num_samples: int, min_shift: int, max_shift: int, code_length: int,
                  mode: str = "exact", phase_bits: int = 12) -> torch.Tensor:
    """The plain version of `code_replica`, on any device."""
    _check_mode(mode)
    args = (codes, prn, code_frequency, sampling_frequency, start_code_phase, num_samples,
            min_shift, max_shift, code_length)
    if mode == "exact":
        return gen_code_replica(*args)
    return gen_code_replica_quantized(*args, phase_bits=phase_bits)


def tap_matrix_plain(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                     num_samples: int, sample_shifts: Sequence[int], code_length: int,
                     mode: str = "exact", phase_bits: int = 12) -> torch.Tensor:
    """The plain version of `code_tap_matrix`, on any device: the taps of the
    haloed row, as the JAX `correlate_pallas_taps` builds them."""
    rep = replica_plain(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                        num_samples, int(min(sample_shifts)), int(max(sample_shifts)),
                        code_length, mode, phase_bits)
    return _tap_matrix(rep, sample_shifts, num_samples)


@functools.lru_cache(maxsize=64)
def launch_plan(offsets: tuple) -> tuple:
    """The launches that write rows with these offsets: ``(r0, r1)`` per
    launch, consecutive rows, as many as `MAX_ROWS` and `MAX_SPAN` let one
    launch take (one CTA reads all of its rows from one haloed tile, so their
    offsets must lie within `MAX_SPAN`). Every row of a tap matrix, one
    launch."""
    plan, r0 = [], 0
    while r0 < len(offsets):
        lo = hi = offsets[r0]
        r1 = r0 + 1
        while r1 < len(offsets) and r1 - r0 < MAX_ROWS:
            lo, hi = min(lo, offsets[r1]), max(hi, offsets[r1])
            if hi - lo > MAX_SPAN:
                break
            r1 += 1
        plan.append((r0, r1))
        r0 = r1
    return tuple(plan)


@functools.lru_cache(maxsize=64)
def _offsets_arg(offsets: tuple) -> ctypes.Array:
    return (ctypes.c_int * len(offsets))(*offsets)


def _param_arg(x, device: torch.device, keep: list):
    """``(pointer, value)`` of one channel parameter for a kernel on
    ``device``: a CUDA tensor by pointer (as f32; a converted copy goes into
    ``keep``), anything else by value. The per-channel correlators take
    their parameters so too (`channel_kernels`)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        if x.device != device:
            raise ValueError(f"a channel parameter is on {x.device}, the call on {device}")
        if x.numel() != 1:
            raise ValueError(f"a channel parameter of one channel holds one value, not "
                             f"{x.numel()}")
        if x.dtype != torch.float32:
            x = x.float()
            keep.append(x)
        return x.data_ptr(), 0.0
    return None, float(x)


def _prn_arg(prn, device: torch.device, num_prns: int, keep: list):
    """``(pointer, value, is_int64)`` of the PRN: a CUDA tensor by pointer
    (the kernels trap on one outside ``[0, P)``), anything else by value,
    with Python's negative indexing."""
    if isinstance(prn, torch.Tensor) and prn.device.type == "cuda":
        if prn.device != device:
            raise ValueError(f"prn is on {prn.device}, the call on {device}")
        if prn.numel() != 1:
            raise ValueError(f"the PRN of one channel is one value, not {prn.numel()}")
        if prn.dtype not in (torch.int32, torch.int64):
            prn = prn.long()
            keep.append(prn)
        return prn.data_ptr(), 0, int(prn.dtype == torch.int64)
    value = int(prn)
    if not -num_prns <= value < num_prns:
        raise IndexError(f"PRN {value} is outside a table of {num_prns} codes")
    return None, value % num_prns, 0


def launch_replica(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                   offsets: Sequence[int], width: int, min_shift: int, code_length: int,
                   mode: str = "exact", phase_bits: int = 12) -> torch.Tensor:
    """Launch ``csrc/replica.cu``: ``[len(offsets), width]`` f32 rows, row r
    the chips of samples ``j + offsets[r]`` (quantized: on the grid that
    starts at ``min_shift``), one launch per entry of `launch_plan`. Adds one to
    ``code_replica.launches`` per launch; raises on anything the kernel does
    not take, and if a launch fails."""
    _check_mode(mode)
    device = codes.device
    if device.type != "cuda":
        raise ValueError(f"the replica kernel takes CUDA tensors, not {device}")
    if codes.dtype != torch.float32 or codes.ndim != 2 or not codes.is_contiguous():
        raise TypeError(f"codes must be a contiguous float32 [Lc, P] table, got "
                        f"{codes.dtype} {tuple(codes.shape)}")
    if codes.shape[0] != code_length:
        raise ValueError(f"codes must be [Lc={code_length}, P], got {tuple(codes.shape)}")
    offsets = tuple(int(o) for o in offsets)
    if width < 1 or not offsets:
        raise ValueError(f"the replica kernel writes at least one chip, got "
                         f"{len(offsets)} x {width}")
    if not all(abs(o) + width < 1 << 24 for o in offsets + (min_shift,)):
        raise ValueError("the replica kernel takes samples below 2^24")
    keep = []
    prn_ptr, prn_value, prn_is64 = _prn_arg(prn, device, codes.shape[1], keep)
    fcode = _param_arg(code_frequency, device, keep)
    phase = _param_arg(start_code_phase, device, keep)
    scale = float(2 ** phase_bits)
    out = torch.empty((len(offsets), width), dtype=torch.float32, device=device)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    lib = _build.load_library("replica")
    for r0, r1 in launch_plan(offsets):
        rows = offsets[r0:r1]
        err = lib.replica_launch(
            codes.data_ptr(), out[r0].data_ptr(), prn_ptr, fcode[0], phase[0], prn_value,
            prn_is64, fcode[1], phase[1], 1.0 / float(sampling_frequency),
            _offsets_arg(rows), len(rows), width, int(min_shift), code_length,
            codes.shape[1], int(mode == "quantized"), scale, 1.0 / scale, stream)
        if err != 0:
            raise RuntimeError(f"replica_launch failed with CUDA error {err}")
        code_replica.launches += 1
    return out


def code_replica(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                 num_samples: int, min_shift: int, max_shift: int, code_length: int,
                 mode: str = "exact", phase_bits: int = 12) -> torch.Tensor:
    """One channel's upsampled +/-1 code replica with tap halo, ``[N + span]``
    (``mode`` "exact": `gen_code_replica`; "quantized":
    `gen_code_replica_quantized`): element ``j`` holds the chip of sample
    ``j + min_shift``. CPU tensors run the plain version; CUDA tensors launch
    ``csrc/replica.cu`` or raise."""
    if codes.device.type == "cpu":
        return replica_plain(codes, prn, code_frequency, sampling_frequency,
                             start_code_phase, num_samples, min_shift, max_shift,
                             code_length, mode, phase_bits)
    return launch_replica(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                          (int(min_shift),), num_samples + int(max_shift) - int(min_shift),
                          min_shift, code_length, mode, phase_bits)[0]


def code_tap_matrix(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                    num_samples: int, sample_shifts: Sequence[int], code_length: int,
                    mode: str = "exact", phase_bits: int = 12) -> torch.Tensor:
    """One channel's ``[L, N]`` tap matrix: row l holds the chips of samples
    ``n + d_l``, the taps kernel's replica. CPU tensors run the plain version
    (`tap_matrix_plain`); CUDA tensors launch ``csrc/replica.cu`` or raise."""
    if codes.device.type == "cpu":
        return tap_matrix_plain(codes, prn, code_frequency, sampling_frequency,
                                start_code_phase, num_samples, sample_shifts, code_length,
                                mode, phase_bits)
    return launch_replica(codes, prn, code_frequency, sampling_frequency, start_code_phase,
                          sample_shifts, num_samples, int(min(sample_shifts)), code_length,
                          mode, phase_bits)


code_replica.launches = 0
