"""Mesh-sharded EPL correlation: the sample axis over ``time``, antennas over ``ant``.

Port of `gpuacceleratedtracking_tpu.parallel.correlate`. No halo crosses a
device: code and carrier replicas are pure phase arithmetic from (frequency,
start phase, sample index), so each time shard makes its own replica, the tap
lookahead past its block edge included, from phases advanced to its first
sample, and the only exchange is a sum of the tiny ``[(A,) L]`` partial
accumulators. Sample indices never cross a device; phases do, exactly.

f32 phase-advance accuracy over big blocks (N up to 2**18) is kept by
splitting the advance into a *nominal* part, computed per shard index in
float64 on the host and reduced mod one cycle / the code length into a table
(`nominal_advance_tables`), and a small *Doppler residual* computed in f32 on
the device (`advance_phases`), in the JAX package's f32 operation order.

One process drives every shard. A shard's work is issued on its own device
(under ``torch.cuda.device`` for a CUDA one), so shards on different cards
run at once. The sum over ``time`` moves each shard's partials to the first
device of its row of the mesh and adds them in shard order 0..T-1: a fixed
order, so the result does not depend on which shard finishes first. XLA's
``psum`` adds in an order of its own, so results differ from the JAX
package's at f32 rounding.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import registry
from ..ops.replica import _TWO_PI_F32
from .mesh import TIME_AXIS, Mesh


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float: an op with a tensor takes it
    as an argument, with no copy to the device."""
    return float(np.float32(x))


def on_device(device: torch.device):
    """The context a shard's work is issued in: its CUDA device made current
    (the kernel launchers launch on the current device), nothing for a CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def nominal_advance_tables(
    nominal_carrier_frequency: float,
    nominal_code_frequency: float,
    sampling_frequency: float,
    samples_per_shard: int,
    num_shards: int,
    code_length: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard phase advances, exact in f64, reduced, then cast to f32.

    Entry ``t``: the carrier advance in cycles mod 1 and the code advance in
    chips mod ``code_length`` over ``t * samples_per_shard`` samples at the
    nominal frequencies. Host (CPU) tensors: a shard reads its entry as a
    Python float.
    """
    t = np.arange(num_shards, dtype=np.float64)
    n0 = t * float(samples_per_shard)
    car = np.mod(float(nominal_carrier_frequency) / float(sampling_frequency) * n0, 1.0)
    code = np.mod(
        float(nominal_code_frequency) / float(sampling_frequency) * n0,
        float(code_length),
    )
    return (torch.from_numpy(car.astype(np.float32)),
            torch.from_numpy(code.astype(np.float32)))


def advance_phases(
    carrier_phase: torch.Tensor,
    code_phase: torch.Tensor,
    carrier_frequency: torch.Tensor,
    code_frequency: torch.Tensor,
    shard_index: int,
    tables: tuple[torch.Tensor, torch.Tensor],
    nominal_carrier_frequency: float,
    nominal_code_frequency: float,
    sampling_frequency: float,
    samples_per_shard: int,
    code_length: int,
):
    """Phases (carrier rad, code chips) advanced to shard ``shard_index``'s
    first sample.

    The nominal advance comes from the table; only the Doppler residual
    ``(f - f_nom) / fs * n0`` is evaluated in f32, in the JAX function's
    operation order. The channel parameters are f32 tensors of any shape;
    ``shard_index`` is a Python int, so the table entries and ``n0`` enter as
    f32-rounded Python floats and nothing is copied to the device.
    """
    car_tab, code_tab = tables
    shard_index = int(shard_index)
    n0 = _f32(shard_index * int(samples_per_shard))
    inv_fs = _f32(1.0 / sampling_frequency)

    dcar_cyc = (carrier_frequency - _f32(nominal_carrier_frequency)) * inv_fs * n0
    cyc = float(car_tab[shard_index]) + dcar_cyc
    cyc = cyc - torch.floor(cyc)
    carrier_local = torch.remainder(carrier_phase + _TWO_PI_F32 * cyc, _TWO_PI_F32)

    dcode = (code_frequency - _f32(nominal_code_frequency)) * inv_fs * n0
    code_local = torch.remainder(
        code_phase + float(code_tab[shard_index]) + dcode, _f32(code_length)
    )
    return carrier_local, code_local


def time_piece(x: torch.Tensor, t: int, num_time: int, device: torch.device) -> torch.Tensor:
    """Piece ``t`` of ``num_time`` of ``x`` along its last axis, contiguous, on
    ``device``: a slice along N is not contiguous, and the kernel wrappers
    take contiguous planes. Made once per call, before any block loop, as
    `shard_map`'s ``in_specs`` cut the signal."""
    local_n = x.shape[-1] // num_time
    return x[..., t * local_n:(t + 1) * local_n].to(device).contiguous()


def sum_in_order(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` on ``device``, in that order (the port's
    ``psum``): each part is copied there first, a no-op where it lies."""
    total = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        total = total + p.to(device, non_blocking=True)
    return total


def correlate_sharded(
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    codes: torch.Tensor,
    prn,
    carrier_frequency,
    sampling_frequency: float,
    carrier_phase,
    code_frequency,
    code_phase,
    sample_shifts: Sequence[int],
    code_length: int,
    *,
    mesh: Mesh,
    nominal_carrier_frequency: float = 0.0,
    nominal_code_frequency: Optional[float] = None,
    algorithm: str = "fused_xla",
    time_axis: str = TIME_AXIS,
    ant_axis: Optional[str] = None,
    beamform: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Correlate one block with its sample axis sharded over ``time_axis``.

    The registry signature plus the mesh layout. ``signal_*`` is ``[N]`` or
    ``[A, N]``; ``N`` is split over ``time_axis`` and, with ``ant_axis``,
    ``A`` over that axis. ``sampling_frequency`` and the two nominal
    frequencies are Python floats (they seed the f64 advance tables);
    ``nominal_code_frequency`` is required. Returns ``[L]`` with
    ``beamform`` (the antenna axis summed over every antenna shard), else
    ``[(A,) L]``, on the mesh's first device.
    """
    if nominal_code_frequency is None:
        raise ValueError("nominal_code_frequency (static) is required")
    num_samples = signal_re.shape[-1]
    num_time = mesh.shape[time_axis]
    if num_samples % num_time:
        raise ValueError(f"N={num_samples} not divisible by {num_time} time shards")
    local_n = num_samples // num_time
    has_ant = signal_re.ndim == 2
    ant_axis = ant_axis if has_ant else None
    num_ant = mesh.shape[ant_axis] if ant_axis is not None else 1
    if has_ant and signal_re.shape[0] % num_ant:
        raise ValueError(f"A={signal_re.shape[0]} not divisible by {num_ant} antenna shards")
    tables = nominal_advance_tables(
        nominal_carrier_frequency, nominal_code_frequency, sampling_frequency,
        local_n, num_time, code_length,
    )
    corr = registry.get(algorithm)
    grid = mesh.grid(ant_axis, time_axis)                 # [ant shards, time shards]
    first = mesh.devices.flat[0]

    def f32_on(x, dev):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    out_re, out_im = [], []
    for a in range(num_ant):
        if has_ant:
            per = signal_re.shape[0] // num_ant
            rows = slice(a * per, (a + 1) * per)
            sre, sim = signal_re[rows], signal_im[rows]
        else:
            sre, sim = signal_re, signal_im
        sre_t = [time_piece(sre, t, num_time, grid[a, t]) for t in range(num_time)]
        sim_t = [time_piece(sim, t, num_time, grid[a, t]) for t in range(num_time)]
        parts_re, parts_im = [], []
        for t in range(num_time):
            dev = grid[a, t]
            with on_device(dev):
                prn_d = prn.to(dev) if isinstance(prn, torch.Tensor) else prn
                f_car, f_code = f32_on(carrier_frequency, dev), f32_on(code_frequency, dev)
                phi_car, phi_code = advance_phases(
                    f32_on(carrier_phase, dev), f32_on(code_phase, dev), f_car, f_code, t,
                    tables, nominal_carrier_frequency, nominal_code_frequency,
                    sampling_frequency, local_n, code_length)
                are, aim = corr(sre_t[t], sim_t[t], codes.to(dev), prn_d, f_car,
                                sampling_frequency, phi_car, f_code, phi_code,
                                sample_shifts, code_length)
            parts_re.append(are)
            parts_im.append(aim)
        lead = grid[a, 0]
        with on_device(lead):
            are, aim = sum_in_order(parts_re, lead), sum_in_order(parts_im, lead)
            if beamform and has_ant:
                are, aim = are.sum(dim=-2), aim.sum(dim=-2)
        out_re.append(are)
        out_im.append(aim)
    with on_device(first):
        if beamform and has_ant:
            return sum_in_order(out_re, first), sum_in_order(out_im, first)
        if has_ant:
            return (torch.cat([x.to(first) for x in out_re]),
                    torch.cat([x.to(first) for x in out_im]))
        return out_re[0].to(first), out_im[0].to(first)
