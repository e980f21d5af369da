"""Plain reference of a closed-loop EPL channel bank: the bank correlator and
the loop closure, in plain PyTorch.

The correlator is the problem's own: every carrier and code phase exact in
float64 from the state's values, each sample wiped off and weighed by its
chip, and summed (`correlate`). No kernel's tiling or phase formulation
enters it. An f32 formulation puts a sample whose exact code phase lies
within a few f32 roundings of a chip boundary on one side or the other, so
`correlate` lists those samples (`Flips`) and `explained_gap` lets each take
either side before it reads a gap: subset by subset where an accumulator has
up to `SEARCH_FLIPS` of them, else by the box that every subset's sum lies in
(at 256 samples a chip an accumulator has ~63, 2^63 subsets).

The loop closure is a frozen copy, rewritten to import nothing of the
program, of (commit d8875d6) `gpuacceleratedtracking_tpu_torch/tracking/
track.py::loop_update_plain` with `_beamform`, `_select`, and
`tracking/discriminators.py`, `tracking/loop_filter.py::step`,
`tracking/cn0.py::update` / `estimate`, op for op.

The code columns come from the benchmark's own table (`benchmark/gold.py`),
not from the program's packed tiles. The control (`track_bank_control`) is
the reference one precision step below the f32 that the configurations
state: its correlator in a single TF32 pass (``mac="tf32"``) and its loop in
bfloat16 (``precision="bf16"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

CHUNK_ELEMENTS = 1 << 23     # float64 elements of one channel chunk's planes
SEARCH_ELEMENTS = 1 << 24    # elements of one chunk of the subset search
SEARCH_FLIPS = 24            # most ambiguous samples of one accumulator searched subset by subset


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """The tracking fields a configuration states (the program's `TrackConfig`
    field names; the program's routing fields are left out)."""

    code_frequency: float
    code_length: int
    center_frequency: float
    sampling_frequency: float
    num_samples: int
    intermediate_frequency: float = 0.0
    sample_shifts: tuple = (-1, 0, 1)
    pll_bandwidth: float = 18.0
    pll_order: int = 3
    dll_bandwidth: float = 1.0
    dll_order: int = 2
    fll_bandwidth: float = 4.0
    cn0_window: int = 20
    secondary_code: tuple = ()
    pll_discriminator: str = "costas"
    coherent_blocks: int = 1

    @classmethod
    def from_fields(cls, fields: dict) -> "LoopConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in fields.items() if k in names}
        for key in ("sample_shifts", "secondary_code"):
            if key in kept:
                kept[key] = tuple(kept[key])
        return cls(**kept)

    @property
    def integration_time(self) -> float:
        return self.num_samples / self.sampling_frequency

    @property
    def prompt_index(self) -> int:
        return (len(self.sample_shifts) - 1) // 2

    @property
    def spacing_chips(self) -> float:
        return ((self.sample_shifts[-1] - self.sample_shifts[0]) * self.code_frequency
                / self.sampling_frequency)


class LoopFilterState(NamedTuple):
    x1: torch.Tensor
    x2: torch.Tensor


class CN0State(NamedTuple):
    prompts_re: torch.Tensor
    prompts_im: torch.Tensor
    index: torch.Tensor


class TrackState(NamedTuple):
    prn: torch.Tensor
    carrier_doppler: torch.Tensor
    carrier_phase: torch.Tensor
    code_doppler: torch.Tensor
    code_phase: torch.Tensor
    pll_filter: LoopFilterState
    dll_filter: LoopFilterState
    cn0: CN0State
    ms_elapsed: torch.Tensor
    prev_prompt_re: torch.Tensor
    prev_prompt_im: torch.Tensor
    coh_re: torch.Tensor
    coh_im: torch.Tensor


class TrackOutput(NamedTuple):
    accum_re: torch.Tensor
    accum_im: torch.Tensor
    prompt_re: torch.Tensor
    prompt_im: torch.Tensor
    carrier_doppler: torch.Tensor
    code_doppler: torch.Tensor
    carrier_phase: torch.Tensor
    code_phase: torch.Tensor
    pll_error: torch.Tensor
    dll_error: torch.Tensor
    cn0_dbhz: torch.Tensor


NESTED = {"pll_filter": LoopFilterState, "dll_filter": LoopFilterState, "cn0": CN0State}


def state_from_leaves(leaves: dict) -> TrackState:
    """A `TrackState` from ``{"carrier_doppler": t, "pll_filter.x1": t, ...}``."""
    fields = {}
    for name in TrackState._fields:
        cls = NESTED.get(name)
        fields[name] = (cls(*(leaves[f"{name}.{f}"] for f in cls._fields)) if cls
                        else leaves[name])
    return TrackState(**fields)


# --- The bank correlator.

class Flips(NamedTuple):
    """The samples of a block at which a chip boundary lies within
    ``ambiguous`` chips of the sample, where the chips on its two sides
    differ: an f32 phase of another formulation may put such a sample on
    either side. One row per (channel, tap, sample): what the accumulators
    ``[k, :, tap]`` move by if that sample takes the other chip."""

    channel: torch.Tensor    # [M] int64
    tap: torch.Tensor        # [M] int64
    delta_re: torch.Tensor   # [M, A] float64
    delta_im: torch.Tensor   # [M, A] float64


def ambiguous_chips(config: LoopConfig) -> float:
    """How near a chip boundary a sample's exact code phase lies for the
    sample to count on either side: four f32 roundings (ulps) at the code's
    length. The port's rows and composite placements and a plain f32
    ``p + rho n`` put a sample at most two ulps across a boundary (1.2e-4
    chips at 1023 chips)."""
    exponent = math.floor(math.log2(float(config.code_length)))
    return 4.0 * 2.0 ** (exponent - 23)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, to nearest, ties away
    from zero, as the tensor cores' conversion rounds), kept in f32 storage."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def correlate(config: LoopConfig, table: torch.Tensor, state, signal_re, signal_im,
              mac: str = "f64", ambiguous: float = 0.0):
    """One block's accumulators of every channel of ``state`` against ``[A, N]``
    planes (``[K, A, L]``) or ``[N]`` planes (``[K, L]``); ``table`` is the
    ``[Lc, P]`` code table. Returns ``(acc_re, acc_im)`` and, where
    ``ambiguous`` > 0, the block's `Flips` as well.

    Every phase is exact in float64, from the state's values: sample ``n``
    of channel ``k`` is wiped off by ``exp(-i 2 pi (phi / 2 pi + f n / fs))``,
    ``f`` the intermediate frequency plus the carrier Doppler, and tap ``d``
    weighs it by the code's chip ``floor(p + (f_c + f_cd) (n + d) / fs)``
    modulo the code's length, ``p`` the code phase. ``mac="f64"`` multiplies
    and sums in float64; ``mac="tf32"`` rounds the wiped-off samples to TF32
    and sums in f32, the single TF32 pass of a tensor-core kernel.
    """
    if mac not in ("f64", "tf32"):
        raise ValueError(f"mac is 'f64' or 'tf32', not {mac!r}")
    squeeze = signal_re.ndim == 1
    if squeeze:
        signal_re, signal_im = signal_re[None], signal_im[None]
    dev = signal_re.device
    f64 = torch.float64
    num_ants, num_samples = signal_re.shape
    shifts = [int(s) for s in config.sample_shifts]
    fs = float(config.sampling_frequency)
    code_length = int(config.code_length)
    num_k = state.prn.shape[0]
    cols = table.T.index_select(0, state.prn.long()).to(f64)                # [K, Lc]
    n = torch.arange(num_samples, dtype=f64, device=dev)
    s_re, s_im = signal_re.to(f64)[None], signal_im.to(f64)[None]          # [1, A, N]
    f_car = (float(config.intermediate_frequency) + state.carrier_doppler.to(f64)) / fs
    phi_car = state.carrier_phase.to(f64) / (2 * math.pi)
    rho = (float(config.code_frequency) + state.code_doppler.to(f64)) / fs
    phi_code = state.code_phase.to(f64)
    acc_dtype = f64 if mac == "f64" else torch.float32
    out_re = torch.empty(num_k, num_ants, len(shifts), dtype=acc_dtype, device=dev)
    out_im = torch.empty_like(out_re)
    flips = []
    per_chunk = max(1, CHUNK_ELEMENTS // (num_ants * num_samples))
    for k0 in range(0, num_k, per_chunk):
        k1 = min(k0 + per_chunk, num_k)
        cyc = phi_car[k0:k1, None] + f_car[k0:k1, None] * n
        theta = (cyc - torch.floor(cyc)) * (2 * math.pi)
        cos, sin = torch.cos(theta)[:, None], torch.sin(theta)[:, None]     # [kc, 1, N]
        dw_re = s_re * cos + s_im * sin                                      # [kc, A, N]
        dw_im = s_im * cos - s_re * sin
        if mac == "tf32":
            dw_re, dw_im = round_tf32(dw_re.float()), round_tf32(dw_im.float())
        for tap, shift in enumerate(shifts):
            x = phi_code[k0:k1, None] + rho[k0:k1, None] * (n + shift)        # [kc, N]
            whole = torch.floor(x)
            code = torch.gather(cols[k0:k1], 1,
                                torch.remainder(whole, code_length).long())  # [kc, N]
            w = code.to(acc_dtype)[:, None]
            out_re[k0:k1, :, tap] = (dw_re * w).sum(-1)
            out_im[k0:k1, :, tap] = (dw_im * w).sum(-1)
            if ambiguous > 0.0:
                flips.append(_flips(x, code, cols[k0:k1], dw_re, dw_im, ambiguous,
                                    code_length, k0, tap))
    acc = (out_re[:, 0], out_im[:, 0]) if squeeze else (out_re, out_im)
    if ambiguous <= 0.0:
        return acc
    return acc + (Flips(*(torch.cat(part) for part in zip(*flips))),)


def _flips(x, code, cols, dw_re, dw_im, ambiguous, code_length, k0, tap):
    """The `Flips` of one tap of a chunk of channels."""
    boundary = torch.round(x)
    near = (x - boundary).abs() < ambiguous
    below = torch.remainder(boundary - 1, code_length).long()
    above = torch.remainder(boundary, code_length).long()
    other = torch.where(x >= boundary, below, above)       # the chip on the boundary's far side
    alt = torch.gather(cols, 1, other)
    k, s = torch.nonzero(near & (alt != code), as_tuple=True)
    change = (alt - code)[k, s][:, None]
    return (k + k0, torch.full_like(k, tap), change * dw_re[k, :, s].double(),
            change * dw_im[k, :, s].double())


def explained_gap(got: tuple, want: tuple, flips: Flips) -> torch.Tensor:
    """Per accumulator ``(k, tap)``, the widest gap over antennas and the
    real and imaginary parts, after the best choice of sides for its
    ambiguous samples: ``min over S of max |got - want - sum_{i in S} delta_i|``,
    each subset ``S`` of its flips tried (a float64 ``[K, L]``). An
    accumulator with more than `SEARCH_FLIPS` flips reads its `_box_gap`."""
    got_re, got_im = (g.double() for g in got)
    want_re, want_im = (w.double() for w in want)
    if got_re.ndim == 2:
        got_re, got_im, want_re, want_im = (t[:, None] for t in
                                            (got_re, got_im, want_re, want_im))
    num_k, num_ants, taps = want_re.shape
    diff = torch.cat([got_re - want_re, got_im - want_im], dim=1)          # [K, 2A, L]
    diff = diff.permute(0, 2, 1).reshape(num_k * taps, 2 * num_ants)
    gap = diff.abs().amax(-1)
    key = flips.channel * taps + flips.tap
    order = torch.argsort(key, stable=True)
    delta = torch.cat([flips.delta_re, flips.delta_im], dim=1)[order]      # [M, 2A]
    counts = torch.bincount(key, minlength=num_k * taps)
    starts = torch.cumsum(counts, 0) - counts
    for m in sorted(set(counts.tolist()) - {0}):
        acc = torch.nonzero(counts == m).flatten()
        rows = delta[starts[acc][:, None] + torch.arange(m, device=delta.device)]  # [G, m, 2A]
        search = _best_subset if m <= SEARCH_FLIPS else _box_gap
        gap[acc] = search(diff[acc], rows)
    return gap.view(num_k, taps)


def _box_gap(target: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``max |target - clamp(target, lo, hi)|`` for each of ``G`` targets
    ``[G, C]``, where component c's ``[lo, hi]`` spans the sums of every
    subset of its ``m`` rows ``[G, m, C]``: every subset's sum lies in that
    box, so this bounds `_best_subset` from below. Inside the box, where a
    program's own flips put its accumulators, many rows' 2^m sums lie far
    closer together than any limit, and the two read alike; a gap that no
    choice of sides explains (a wrong channel, a lost half of the bank) lies
    far outside it."""
    lo = rows.clamp(max=0.0).sum(1)
    hi = rows.clamp(min=0.0).sum(1)
    return (target - torch.maximum(torch.minimum(target, hi), lo)).abs().amax(-1)


def _best_subset(target: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``min over subsets S of max |target - sum_S rows|`` for each of ``G``
    targets ``[G, C]`` and its ``m`` rows ``[G, m, C]``: every subset is tried,
    in chunks."""
    groups, m, width = rows.shape
    subsets = 1 << m
    per_subsets = min(subsets, 1 << 20)
    per_groups = max(1, SEARCH_ELEMENTS // (per_subsets * width))
    best = torch.full((groups,), math.inf, dtype=target.dtype, device=target.device)
    bits = torch.arange(m, device=rows.device)
    for s0 in range(0, subsets, per_subsets):
        index = torch.arange(s0, min(s0 + per_subsets, subsets), device=rows.device)
        masks = ((index[:, None] >> bits) & 1).to(rows.dtype)                # [S, m]
        for g0 in range(0, groups, per_groups):
            g1 = min(g0 + per_groups, groups)
            sums = torch.einsum("sm,gmc->gsc", masks, rows[g0:g1])
            left = (target[g0:g1, None] - sums).abs().amax(-1).amin(-1)
            best[g0:g1] = torch.minimum(best[g0:g1], left)
    return best


# --- The loop closure.

def _f32(x) -> float:
    return float(np.float32(x))


def pll_costas(prompt_re, prompt_im):
    safe_re = torch.where(prompt_re == 0, 1e-12, prompt_re)
    return torch.atan(prompt_im / safe_re) / (2 * math.pi)


def pll_atan2(prompt_re, prompt_im):
    return torch.atan2(prompt_im, prompt_re) / (2 * math.pi)


def dll_emle(early_re, early_im, late_re, late_im, spacing_chips):
    e = torch.sqrt(early_re**2 + early_im**2)
    l = torch.sqrt(late_re**2 + late_im**2)
    return (e - l) / torch.clamp(e + l, min=1e-12) * (2.0 - spacing_chips) / 2.0


def fll_atan2(prev_re, prev_im, curr_re, curr_im, dt):
    cross = prev_re * curr_im - prev_im * curr_re
    dot = prev_re * curr_re + prev_im * curr_im
    return torch.atan2(cross, dot) / (2 * math.pi * dt)


def fll_atan(prev_re, prev_im, curr_re, curr_im, dt):
    cross = prev_re * curr_im - prev_im * curr_re
    dot = prev_re * curr_re + prev_im * curr_im
    safe = torch.where(torch.abs(dot) < 1e-12, 1e-12, dot)
    return torch.atan(cross / safe) / (2 * math.pi * dt)


def filter_step(state: LoopFilterState, error, integration_time, bandwidth, order: int = 2,
                fll_error=None, fll_bandwidth: float = 0.0):
    device = state.x1.device
    t = float(np.float32(integration_time))
    err = torch.as_tensor(error, dtype=torch.float32, device=device)
    fll = None
    if fll_error is not None and fll_bandwidth > 0.0:
        fll = torch.as_tensor(fll_error, dtype=torch.float32, device=device)
    if order == 1:
        omega0 = 4.0 * bandwidth
        return state, omega0 * err
    if order == 2:
        omega0 = bandwidth / 0.53
        dx1 = omega0**2 * err * t
        if fll is not None:
            omega0f = 4.0 * fll_bandwidth
            dx1 = dx1 + omega0f * fll * t
        x1 = state.x1 + dx1
        out = 0.5 * (state.x1 + x1) + math.sqrt(2.0) * omega0 * err
        return LoopFilterState(x1, state.x2), out
    if order == 3:
        omega0 = bandwidth / 0.7845
        x2 = state.x2 + omega0**3 * err * t
        dx1 = (0.5 * (state.x2 + x2) + 1.1 * omega0**2 * err) * t
        if fll is not None:
            omega0f = fll_bandwidth / 0.53
            x2 = x2 + omega0f**2 * fll * t
            dx1 = dx1 + math.sqrt(2.0) * omega0f * fll * t
        x1 = state.x1 + dx1
        out = 0.5 * (state.x1 + x1) + 2.4 * omega0 * err
        return LoopFilterState(x1, x2), out
    raise ValueError(f"order must be 1, 2 or 3, got {order}")


def cn0_update(state: CN0State, prompt_re, prompt_im) -> CN0State:
    window = state.prompts_re.shape[-1]
    slot = torch.remainder(state.index, window).long().unsqueeze(-1)

    def write(buf, value):
        value = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
        return buf.scatter(-1, slot, value.reshape(slot.shape))

    return CN0State(write(state.prompts_re, prompt_re), write(state.prompts_im, prompt_im),
                    state.index + 1)


def cn0_estimate(state: CN0State, integration_time) -> torch.Tensor:
    p2 = state.prompts_re**2 + state.prompts_im**2
    m2 = p2.mean(dim=-1)
    m4 = (p2**2).mean(dim=-1)
    pd = torch.sqrt(torch.clamp(2.0 * m2**2 - m4, min=1e-20))
    pn = torch.clamp(m2 - pd, min=1e-20)
    cn0 = pd / (pn * integration_time)
    return 10.0 * torch.log10(torch.clamp(cn0, min=1e-20))


def _beamform(accum_re, accum_im, ant_weights, single_antenna: bool):
    if single_antenna:
        return accum_re, accum_im
    if ant_weights is None:
        return accum_re.sum(dim=-2), accum_im.sum(dim=-2)
    w_re, w_im = (torch.as_tensor(w, dtype=torch.float32, device=accum_re.device)[..., :, None]
                  for w in ant_weights)
    bf_re = (w_re * accum_re + w_im * accum_im).sum(dim=-2)
    bf_im = (w_re * accum_im - w_im * accum_re).sum(dim=-2)
    return bf_re, bf_im


def _select(mask, new, old):
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def _bf16(tree):
    """Every float leaf of a tree of tensors rounded to bfloat16 (kept in f32)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.bfloat16).to(torch.float32) if tree.is_floating_point() else tree
    if tree is None:
        return None
    return type(tree)(*(_bf16(x) for x in tree))


def loop_update(config: LoopConfig, state: TrackState, accum_re, accum_im,
                ant_weights: Optional[tuple] = None, precision: str = "f32"):
    """One block's loop closure: discriminate, filter, advance the NCOs.
    ``ant_weights``: ``(w_re, w_im)`` of shape ``[K, A]``."""
    if precision == "bf16":
        state, accum_re, accum_im = _bf16(state), _bf16(accum_re), _bf16(accum_im)
        new_state, output = loop_update(config, state, accum_re, accum_im, ant_weights)
        return _bf16(new_state), _bf16(output)
    if precision != "f32":
        raise ValueError(f"precision is 'f32' or 'bf16', not {precision!r}")
    device = accum_re.device
    t = config.integration_time
    f32 = _f32
    carrier_freq = config.intermediate_frequency + state.carrier_doppler
    code_freq = config.code_frequency + state.code_doppler
    single_antenna = accum_re.ndim == state.prn.ndim + 1

    if config.secondary_code:
        sc = torch.tensor(config.secondary_code, dtype=torch.float32, device=device)
        sign = sc[torch.remainder(state.ms_elapsed, len(config.secondary_code)).long()]
        sign = sign.reshape(sign.shape + (1,) * (accum_re.ndim - sign.ndim))
        accum_re = accum_re * sign
        accum_im = accum_im * sign

    bf_re, bf_im = _beamform(accum_re, accum_im, ant_weights, single_antenna)
    pidx = config.prompt_index

    k_coh = max(int(config.coherent_blocks), 1)
    if k_coh > 1:
        coh_re = state.coh_re + bf_re
        coh_im = state.coh_im + bf_im
        boundary = torch.remainder(state.ms_elapsed + 1, k_coh) == 0
    else:
        coh_re, coh_im = bf_re, bf_im
    t_coh = f32(t * k_coh)
    prompt_re, prompt_im = coh_re[..., pidx], coh_im[..., pidx]

    atan2 = config.pll_discriminator == "atan2"
    pll_err = (pll_atan2 if atan2 else pll_costas)(prompt_re, prompt_im)
    dll_err = dll_emle(coh_re[..., -1], coh_im[..., -1], coh_re[..., 0], coh_im[..., 0],
                       config.spacing_chips)
    fll_err = (fll_atan2 if atan2 else fll_atan)(
        state.prev_prompt_re, state.prev_prompt_im, prompt_re, prompt_im, t_coh)
    fll_err = torch.where(state.ms_elapsed >= k_coh, fll_err, 0.0)

    pll_state, doppler_cmd = filter_step(
        state.pll_filter, pll_err, t_coh, config.pll_bandwidth, config.pll_order,
        fll_error=fll_err, fll_bandwidth=config.fll_bandwidth)
    dll_state, code_cmd = filter_step(state.dll_filter, dll_err, t_coh, config.dll_bandwidth,
                                      config.dll_order)

    new_carrier_doppler = doppler_cmd
    new_code_doppler = (
        code_cmd + new_carrier_doppler * config.code_frequency / config.center_frequency)

    if k_coh > 1:
        pll_state = LoopFilterState(*(_select(boundary, a, b)
                                      for a, b in zip(pll_state, state.pll_filter)))
        dll_state = LoopFilterState(*(_select(boundary, a, b)
                                      for a, b in zip(dll_state, state.dll_filter)))
        new_carrier_doppler = _select(boundary, new_carrier_doppler, state.carrier_doppler)
        new_code_doppler = _select(boundary, new_code_doppler, state.code_doppler)
        prompt_keep = _select(boundary, prompt_re, state.prev_prompt_re)
        prompt_keep_im = _select(boundary, prompt_im, state.prev_prompt_im)
        coh_re = _select(boundary, torch.zeros_like(coh_re), coh_re)
        coh_im = _select(boundary, torch.zeros_like(coh_im), coh_im)
        pll_err = _select(boundary, pll_err, torch.zeros_like(pll_err))
        dll_err = _select(boundary, dll_err, torch.zeros_like(dll_err))
    else:
        prompt_keep, prompt_keep_im = prompt_re, prompt_im
        coh_re = torch.zeros_like(state.coh_re)
        coh_im = torch.zeros_like(state.coh_im)

    two_pi = f32(2 * math.pi)
    carrier_phase = torch.remainder(state.carrier_phase + two_pi * carrier_freq * f32(t), two_pi)
    code_phase = torch.remainder(state.code_phase + code_freq * f32(t),
                                 f32(float(config.code_length)))

    cn0_state = cn0_update(state.cn0, bf_re[..., pidx], bf_im[..., pidx])
    cn0_dbhz = cn0_estimate(cn0_state, f32(t))

    new_state = TrackState(
        prn=state.prn, carrier_doppler=new_carrier_doppler, carrier_phase=carrier_phase,
        code_doppler=new_code_doppler, code_phase=code_phase, pll_filter=pll_state,
        dll_filter=dll_state, cn0=cn0_state, ms_elapsed=state.ms_elapsed + 1,
        prev_prompt_re=prompt_keep, prev_prompt_im=prompt_keep_im, coh_re=coh_re,
        coh_im=coh_im)
    output = TrackOutput(
        accum_re=accum_re, accum_im=accum_im, prompt_re=prompt_re, prompt_im=prompt_im,
        carrier_doppler=new_carrier_doppler, code_doppler=new_code_doppler,
        carrier_phase=carrier_phase, code_phase=code_phase, pll_error=pll_err,
        dll_error=dll_err, cn0_dbhz=cn0_dbhz)
    return new_state, output


def expand_weights(ant_weights, num_k: int, num_ants: int, device):
    """``(w_re, w_im)`` ``[A]`` as the ``[K, A]`` f32 tensors the loop takes."""
    if ant_weights is None:
        return None
    return tuple(torch.as_tensor(w, dtype=torch.float32, device=device).expand(num_k, num_ants)
                 for w in ant_weights)


def track_bank_control(config: LoopConfig, table: torch.Tensor):
    """The control: the reference in the program's place (``track_bank``'s
    signature), its correlator in TF32 and its loop in bfloat16, block by
    block. Its accumulators are the TF32 correlator's, as a program's are
    its correlator's. Returns the final state and the stacked ``[B, ...]``
    outputs."""
    def run(_config, _codes, states, signal_re, signal_im, ant_weights=None):
        num_k = states.prn.shape[0]
        num_ants = signal_re.shape[-2] if signal_re.ndim == 3 else 1
        weights = expand_weights(ant_weights, num_k, num_ants, signal_re.device)
        state = states
        outs = []
        for b in range(signal_re.shape[0]):
            acc = correlate(config, table, state, signal_re[b], signal_im[b], mac="tf32")
            state, out = loop_update(config, state, *acc, weights, precision="bf16")
            outs.append(out._replace(accum_re=acc[0], accum_im=acc[1]))
        stacked = TrackOutput(*(torch.stack(leaf) for leaf in zip(*outs)))
        return state, stacked

    return run
