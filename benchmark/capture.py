"""The traffic's signal: a recorded capture that sits on the card, and the bank
that tracks it, both drawn from the seed.

Frozen, in plain torch, from the pattern of `chip_smoke.py` at commit d8875d6
(`bank_states`, `mixed_blocks`, `steering_weights`) and the signal model of
`gpuacceleratedtracking_tpu_torch/models/signal.py::gen_signal_mixed`: each
satellite's chips are upsampled from the code phase
``phi0 + n * f_code / fs`` with ``f_code = 1.023 MHz * (1 + doppler / f_L1)``,
modulated onto ``exp(i (2 pi doppler n / fs + phi_c))``, scaled to its C/N0
against complex white noise of unit variance per component, and summed.
Antenna a of an array sees the sum rotated by its steering phase ``psi_a``
(antenna 0 at 0) plus noise of its own. Phases are taken in float64 over the
whole capture, so the signal has no block seams. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .reference.bank_epl import CN0State, LoopFilterState, TrackState

CHUNK_BLOCKS = 50            # blocks synthesised per pass over the satellites


class Scenario(NamedTuple):
    """The satellites in view and the array, as drawn from the seed."""

    prns: np.ndarray             # [S] 0-based, distinct
    dopplers: np.ndarray         # [S] Hz
    code_phases: np.ndarray      # [S] chips at sample 0
    carrier_phases: np.ndarray   # [S] rad at sample 0
    cn0_dbhz: np.ndarray         # [S]
    doppler_errors: np.ndarray   # [S] Hz: channel minus truth at the start
    code_errors: np.ndarray      # [S] chips: channel minus truth at the start
    steering: np.ndarray         # [A] rad, antenna 0 at 0


def draw_scenario(config: dict, traffic: dict, seed: int) -> Scenario:
    """The scenario of ``seed``: every seed draws the same kinds and counts."""
    rng = np.random.default_rng(seed)
    sats = int(traffic["satellites"])
    lo, hi = traffic["cn0_dbhz"]
    max_dop = float(traffic["doppler_hz"])
    prns = rng.choice(int(config["bank"]["prn_cycle"]), size=sats, replace=False)
    return Scenario(
        prns=np.sort(prns),
        dopplers=rng.uniform(-max_dop, max_dop, sats),
        code_phases=rng.uniform(0.0, float(config["track"]["code_length"]), sats),
        carrier_phases=rng.uniform(0.0, 2 * math.pi, sats),
        cn0_dbhz=rng.uniform(lo, hi, sats),
        doppler_errors=rng.uniform(-1.0, 1.0, sats) * float(traffic["pull_in_doppler_hz"]),
        code_errors=rng.uniform(-1.0, 1.0, sats) * float(traffic["pull_in_code_chips"]),
        steering=np.concatenate(
            [[0.0], rng.uniform(0.0, 2 * math.pi, int(config["bank"]["antennas"]) - 1)]),
    )


def synthesise(config: dict, traffic: dict, scenario: Scenario, table: torch.Tensor,
               seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The capture's ``[B, N]`` (one antenna) or ``[B, A, N]`` f32 planes on
    ``device``, ``B = traffic["capture_blocks"]``, in chunks of blocks."""
    track = config["track"]
    fs = float(track["sampling_frequency"])
    n_block = int(track["num_samples"])
    f_code0 = float(track["code_frequency"])
    f_center = float(track["center_frequency"])
    code_length = int(track["code_length"])
    num_ants = int(config["bank"]["antennas"])
    blocks = int(traffic["capture_blocks"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    shape = (blocks, num_ants, n_block)
    sre = torch.empty(shape, dtype=torch.float32, device=device)
    sim = torch.empty(shape, dtype=torch.float32, device=device)
    steer = torch.tensor(scenario.steering, dtype=torch.float64, device=device)
    steer_c, steer_s = torch.cos(steer).float()[:, None], torch.sin(steer).float()[:, None]
    amps = np.sqrt(2.0 * 10.0 ** (scenario.cn0_dbhz / 10.0) / fs)
    for b0 in range(0, blocks, CHUNK_BLOCKS):
        b1 = min(b0 + CHUNK_BLOCKS, blocks)
        n = torch.arange(b0 * n_block, b1 * n_block, dtype=torch.float64, device=device)
        acc_re = torch.zeros(n.shape, dtype=torch.float32, device=device)
        acc_im = torch.zeros(n.shape, dtype=torch.float32, device=device)
        for s in range(len(scenario.prns)):
            dop = float(scenario.dopplers[s])
            f_code = f_code0 * (1.0 + dop / f_center)
            phase = n * (f_code / fs) + float(scenario.code_phases[s])
            chip_idx = torch.remainder(torch.floor(phase).long(), code_length)
            chips = table[:, int(scenario.prns[s])][chip_idx]
            cycles = n * (dop / fs) + float(scenario.carrier_phases[s]) / (2 * math.pi)
            theta = ((cycles - torch.floor(cycles)) * (2 * math.pi)).float()
            amp = float(amps[s])
            acc_re += amp * chips * torch.cos(theta)
            acc_im += amp * chips * torch.sin(theta)
        rows = b1 - b0
        noise = torch.randn((2, rows, num_ants, n_block), generator=gen, dtype=torch.float32,
                            device=device)
        sig_re = acc_re.view(rows, 1, n_block)
        sig_im = acc_im.view(rows, 1, n_block)
        # Antenna a: the sum rotated by e^{i psi_a}, plus its own noise.
        sre[b0:b1] = sig_re * steer_c - sig_im * steer_s + noise[0]
        sim[b0:b1] = sig_re * steer_s + sig_im * steer_c + noise[1]
    if num_ants == 1:
        return sre[:, 0].contiguous(), sim[:, 0].contiguous()
    return sre, sim


def steering_weights(scenario: Scenario) -> tuple[np.ndarray, np.ndarray]:
    """``(w_re, w_im)`` ``[A]`` f32: the array's steering, which the beamformer
    undoes (``conj(w_a) x_a``)."""
    return (np.cos(scenario.steering).astype(np.float32),
            np.sin(scenario.steering).astype(np.float32))


def initial_state(config: dict, scenario: Scenario) -> TrackState:
    """The bank's set-up states, as numpy leaves: channel k tracks PRN
    ``k % prn_cycle`` from a Doppler spread evenly over the bank's range, and
    one channel of each satellite's PRN starts within pull-in range of that
    satellite (its Doppler and code phase off by the scenario's errors).

    The live channels are spread over the channel shards of the
    configuration's ``mesh`` (``chan`` contiguous shards of ``K / chan``
    channels; one without a mesh): satellite s, in the scenario's order,
    takes the first channel of its PRN in shard ``s % chan``, channel
    ``shard * K / chan + prn``; each shard has to hold whole PRN cycles.
    Without a mesh that is channel ``prn``."""
    bank, track = config["bank"], config["track"]
    num_k = int(bank["channels"])
    cycle = int(bank["prn_cycle"])
    span = float(bank["doppler_span_hz"])
    window = int(track["cn0_window"])
    taps = len(track["sample_shifts"])
    chan = int(config.get("mesh", {}).get("chan", 1))
    per = num_k // chan
    if num_k % chan or per % cycle:
        raise ValueError(f"K={num_k} channels are not {chan} shards of whole PRN cycles "
                         f"of {cycle}")
    dops = np.linspace(-span, span, num_k)
    code_phases = np.zeros(num_k)
    for s, prn in enumerate(scenario.prns):
        k = (s % chan) * per + int(prn)    # the first channel of this PRN in its shard
        dops[k] = scenario.dopplers[s] + scenario.doppler_errors[s]
        code_phases[k] = (scenario.code_phases[s] + scenario.code_errors[s]) % track["code_length"]
    f32 = lambda x: np.asarray(x, dtype=np.float32).copy()  # noqa: E731
    zeros = np.zeros(num_k, dtype=np.float32)
    return TrackState(
        prn=(np.arange(num_k) % cycle).astype(np.int32),
        carrier_doppler=f32(dops),
        carrier_phase=zeros.copy(),
        code_doppler=zeros.copy(),
        code_phase=f32(code_phases),
        pll_filter=LoopFilterState(f32(dops), zeros.copy()),
        dll_filter=LoopFilterState(zeros.copy(), zeros.copy()),
        cn0=CN0State(np.zeros((num_k, window), np.float32), np.zeros((num_k, window), np.float32),
                     np.zeros(num_k, np.int32)),
        ms_elapsed=np.zeros(num_k, np.int32),
        prev_prompt_re=zeros.copy(),
        prev_prompt_im=zeros.copy(),
        coh_re=np.zeros((num_k, taps), np.float32),
        coh_im=np.zeros((num_k, taps), np.float32),
    )


def to_torch(state: TrackState, device) -> TrackState:
    """A numpy `TrackState` as the reference's torch `TrackState` on ``device``."""
    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    fields = {}
    for name in TrackState._fields:
        value = getattr(state, name)
        fields[name] = (type(value)(*(conv(v) for v in value)) if isinstance(value, tuple)
                        else conv(value))
    return TrackState(**fields)
