#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py [--out results.json] [--seed N]``

Drives the port's main paths once on the card and exits nonzero on any failure:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles ``gpuacceleratedtracking_tpu_torch/csrc/*.cu`` with nvcc,
   one compiler per source, all started together.
3. Each kernel vs its plain version on the card, channel parameters from a
   numpy seed:
   - ``bank_rows`` (route ``pallas_bank_rows``), GPS L1: the golden prompt
     (K=3), K=64, A=2, a wide tap span at N=2^18 through
     ``pallas_bank_auto``, and K=1024;
   - ``bank_comp`` (route ``pallas_bank_comp``), GPS L1 at 32.768 MHz: the
     golden prompt (K=3), K=64 at A=4 L=7, K=5 (a padded channel group),
     N=20000, a wide span at A=2, K=1024 at A=4 L=7, and bf16 z-planes at
     K=64 A=4 L=7 against the f32 plain version;
   - the transition route (``pallas_bank``, served by ``bank_rows.cu``): GPS
     L5 K=128, the L5 A=4 L=7 cell at K=8, GPS L1 at 4.096 MHz K=64.
4. Main paths, each through the entry point a user calls, with every launch
   count set to 0 just before it and read just after:
   - rows: ``track_bank`` on a K=1024 GPS L1 bank at 32.768 MHz through
     ``pallas_bank_auto``, 20 noiseless blocks of an 8-satellite signal (one
     launch per block, agreement with the plain ``xla_bank`` run), then 600
     blocks at 50 dB-Hz from a 20 Hz / 0.2 chip start: the 8 satellites hold
     lock;
   - A, the steered array: the same bank on A=4 antennas with L=7 taps,
     antenna a rotated by a * 120 degrees, steering weights ``ant_weights``;
     ``pallas_bank_auto`` resolves it to ``pallas_bank_comp``. 20 noiseless
     blocks (one launch per block, against ``xla_bank``), 300 noisy blocks
     (lock within 5 Hz, steered |prompt| above the uniform sum), and the 20
     blocks again with bf16 z-planes against f32;
   - B, GPS L5 dual: ``track_bank_dual`` on K=64 I5/Q5 channels at
     32.768 MHz, one 128-channel ``pallas_bank`` launch per block; 8
     satellites with planted overlay phases and nav symbols at 45 dB-Hz per
     component. A Costas run without wipe-off feeds
     ``detect_secondary_offset``, which must recover the planted phases; the
     pilot-driven run aligned with them must show lock
     (``phase_lock_metric``) and the planted symbols in the data prompts.
5. Times (CUDA events, after warm-up; medians and minima): each kernel vs its
   plain version at its main-path shape, and the closed-loop block of each
   path.

Its last lines are one JSON object describing the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

L1_FS = 32.768e6
N_1MS = 32768
N_WIDE = 1 << 18
NUM_K = 1024
NUM_ANTS = 4
ANT_PHASE = 2.0 * math.pi / 3.0      # antenna a is rotated by a * ANT_PHASE
SAT_DOPPLERS = np.array([-3500.0, -2200.0, -1100.0, -300.0, 450.0, 1300.0, 2600.0, 3750.0])
SAT_CODE_PHASES = np.array([0.0, 97.3, 211.6, 345.2, 480.9, 612.4, 777.7, 901.1])
# Per-component noise sigma: C/N0 = 1 / (2 sigma^2 / fs) = 50 dB-Hz at 32.768 MHz.
NOISE_STD = math.sqrt(L1_FS / 1e5 / 2)
# GPS L5 dual path: K dual channels, 8 of them on satellites.
DUAL_K = 64
L5_PRNS = np.array([2, 5, 9, 13, 17, 22, 27, 31])
L5_DOPPLERS = np.array([-3100.0, -1900.0, -700.0, 150.0, 900.0, 1750.0, 2450.0, 3300.0])
# Code phases stay small: a block integrates one overlay bit only when the
# satellite's code period starts near the block start (here within 27 chips,
# < 0.3 % of the 10230-chip period).
L5_CODE_PHASES = np.array([0.0, 3.5, 7.25, 11.0, 14.5, 18.75, 22.0, 26.5])
# Per-component sigma for 45 dB-Hz per L5 component at 32.768 MHz.
L5_NOISE_STD = math.sqrt(L1_FS / 10 ** 4.5 / 2)
TIMING_REPS = 20
DEVICE = "cuda"


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def counters():
    """Every kernel's launch count, by kernel name."""
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp, epl_kernels

    return {"bank_rows": epl_kernels.correlate_pallas_bank_rows,
            "bank_comp": bank_comp.correlate_pallas_bank_comp,
            "bank_transition": epl_kernels.correlate_pallas_bank}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def random_case(system, n, k, seed, num_ants=1, taps=3, fs=None):
    """Bank inputs as in tests/test_pallas.py: PRN 0 at 1500 Hz, random channels."""
    from gpuacceleratedtracking_tpu_torch.models import (
        EPLCorrelator, correlator_sample_shifts, gen_signal, soa)

    rng = np.random.default_rng(seed)
    fs = n / 1e-3 if fs is None else fs
    signal, _ = gen_signal(system, 0, 1500.0, n, duration=n / fs,
                           num_ants=None if num_ants == 1 else num_ants, device=DEVICE)
    sre, sim = soa(signal)
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=DEVICE)  # noqa: E731
    return dict(
        signal_re=sre, signal_im=sim,
        codes=torch.as_tensor(system.codes, device=DEVICE),
        prn=t(np.arange(k) % 32, torch.int32),
        carrier_frequency=t(1500.0 + rng.uniform(-4000.0, 4000.0, k)),
        sampling_frequency=fs,
        carrier_phase=t(rng.uniform(0, 2 * np.pi, k)),
        code_frequency=t(system.code_frequency + rng.uniform(-3, 3, k)),
        code_phase=t(rng.uniform(0, system.code_length, k)),
        sample_shifts=tuple(int(s) for s in correlator_sample_shifts(
            system, EPLCorrelator(taps), fs)),
        code_length=system.code_length,
        nominal_code_frequency=system.code_frequency,
    )


def golden(case, system, k):
    z = torch.zeros(k, device=DEVICE)
    case.update(carrier_frequency=z + 1500.0, carrier_phase=z,
                code_frequency=z + system.code_frequency, code_phase=z,
                prn=torch.zeros(k, dtype=torch.int32, device=DEVICE))
    return case


def kernel_cells(system, seed):
    """Phase 3, bank_rows: each cell through the kernel and its plain version."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    cells = [
        # name, N, K, A, route, atol
        ("golden_k3", N_1MS, 3, 1, "pallas_bank_rows", 4.5),
        ("k64", N_1MS, 64, 1, "pallas_bank_rows", 4.5),
        ("a2_k8", N_1MS, 8, 2, "pallas_bank_rows", 4.5),
        # The kernel and the plain version share their f32 phase arithmetic,
        # so no chip flip is expected; 8.0 is the JAX suite's envelope at
        # N=2^17 (four +/-2 flips), kept at 2^18.
        ("wide_n262144_k8", N_WIDE, 8, 1, "pallas_bank_auto", 8.0),
        ("k1024", N_1MS, NUM_K, 1, "pallas_bank_rows", 4.5),
    ]
    worst = 0.0
    for i, (name, n, k, a, route, atol) in enumerate(cells):
        case = random_case(system, n, k, seed + i, num_ants=a)
        if name.startswith("golden"):
            golden(case, system, k)
        if route == "pallas_bank_auto":
            check(epl_kernels.bank_algorithm_for(
                n, case["sampling_frequency"], system.code_length,
                system.code_frequency) == "pallas_bank_rows", f"{name} routes to rows")
            check(max(case["sample_shifts"]) - min(case["sample_shifts"]) >= 128,
                  f"{name} has a wide tap span")
            fn = epl_kernels.correlate_pallas_bank_auto
        else:
            fn = epl_kernels.correlate_pallas_bank_rows
        before = epl_kernels.correlate_pallas_bank_rows.launches
        got = fn(**case)
        torch.cuda.synchronize()
        check(epl_kernels.correlate_pallas_bank_rows.launches == before + 1,
              f"{name} launched the rows kernel once")
        want = epl_kernels.correlate_bank_rows_reference(**case)
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape == ((k, 3) if a == 1 else (k, a, 3)), f"{name} shape")
            check(bool(torch.isfinite(g).all()), f"{name} finite")
            err = max(err, float((g - w).abs().max()))
            ok = bool(((g - w).abs() <= atol + 2e-3 * w.abs()).all())
            check(ok, f"{name}: kernel vs plain within rtol=2e-3 atol={atol}")
        if name.startswith("golden"):
            check(bool((got[0][:, 1] == float(n)).all()),
                  f"{name}: prompt exactly {n}, got {got[0][:, 1].tolist()}")
        worst = max(worst, err)
        log(f"[kernel] bank_rows {name}: N={n} K={k} A={a} via {route}: "
            f"max|kernel-plain|={err!r} (atol {atol}, rtol 2e-3) ok")
    return worst


def comp_cells(system, seed):
    """Phase 3, bank_comp: f32 cells within 3e-5 of the largest accumulator
    (the kernel and the plain version build Z with the same phase arithmetic
    and differ in summation order only), bf16 within 4e-3 of it against the
    f32 plain version (the JAX suite's tracking-grade bound)."""
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp

    cells = [
        # name, N, K, A, L, shifts or None, z_dtype
        ("golden_k3", N_1MS, 3, 1, 3, None, "f32"),
        ("k64_a4_l7", N_1MS, 64, 4, 7, None, "f32"),
        ("padded_k5", N_1MS, 5, 1, 3, None, "f32"),
        ("unaligned_n20000", 20000, 3, 1, 3, None, "f32"),
        ("wide_span_a2_n8192", 8192, 3, 2, 3, (-160, 0, 170), "f32"),
        ("k1024_a4_l7", N_1MS, NUM_K, 4, 7, None, "f32"),
        ("bf16_k64_a4_l7", N_1MS, 64, 4, 7, None, "bf16"),
    ]
    worst = 0.0
    for i, (name, n, k, a, taps, shifts, z_dtype) in enumerate(cells):
        case = random_case(system, n, k, seed + 20 + i, num_ants=a, taps=taps,
                           fs=L1_FS if n == 20000 else None)
        if shifts is not None:
            case["sample_shifts"] = shifts
        if name.startswith("golden"):
            golden(case, system, k)
        before = bank_comp.correlate_pallas_bank_comp.launches
        got = bank_comp.correlate_pallas_bank_comp(**case, z_dtype=z_dtype)
        torch.cuda.synchronize()
        check(bank_comp.correlate_pallas_bank_comp.launches == before + 1,
              f"comp {name} launched once")
        plain = bank_comp.correlate_bank_comp_reference(**case, z_dtype=z_dtype)
        f32 = (plain if z_dtype == "f32"
               else bank_comp.correlate_bank_comp_reference(**case))
        scale = float(f32[0].abs().max())
        tol = 3e-5 * scale + 1e-3 if z_dtype == "f32" else 4e-3 * scale
        err = err_f32 = 0.0
        for g, w, f in zip(got, plain, f32):
            check(g.shape == w.shape == ((k, taps) if a == 1 else (k, a, taps)),
                  f"comp {name} shape")
            check(bool(torch.isfinite(g).all()), f"comp {name} finite")
            err = max(err, float((g - w).abs().max()))
            err_f32 = max(err_f32, float((g - f).abs().max()))
        check(err_f32 <= tol, f"comp {name}: kernel vs f32 plain {err_f32!r} <= {tol!r}")
        if z_dtype == "bf16":
            check(err <= 3e-5 * scale + 1e-3,
                  f"comp {name}: kernel vs bf16 plain {err!r}")
        if name.startswith("golden"):
            rel = float(((got[0][:, 1] - n) / n).abs().max())
            check(rel <= 1e-5, f"comp {name}: prompt within rtol 1e-5 of {n} ({rel!r})")
        worst = max(worst, err)
        log(f"[kernel] bank_comp {name}: N={n} K={k} A={a} L={taps} z={z_dtype}: "
            f"max|kernel-plain|={err!r}, max|kernel-f32 plain|={err_f32!r} "
            f"(bound {tol!r}) ok")
    return worst


def transition_cells(seed):
    """Phase 3, the transition route: GPS L5 and low-rate GPS L1 through
    ``pallas_bank_auto`` (which must resolve them to ``pallas_bank``)."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    cells = [
        # name, system, N, K, A, L
        ("l5_k128", GPSL5(), N_1MS, 2 * DUAL_K, 1, 3),
        ("l5_a4_l7_k8", GPSL5(), N_1MS, 8, 4, 7),
        ("l1_4096khz_k64", GPSL1(), 4096, 64, 1, 3),
    ]
    worst = 0.0
    for i, (name, system, n, k, a, taps) in enumerate(cells):
        case = random_case(system, n, k, seed + 40 + i, num_ants=a, taps=taps)
        check(epl_kernels.bank_algorithm_for(
            n, case["sampling_frequency"], system.code_length, system.code_frequency,
            num_ants=a) == "pallas_bank", f"{name} routes to pallas_bank")
        before = epl_kernels.correlate_pallas_bank.launches
        got = epl_kernels.correlate_pallas_bank_auto(**case)
        torch.cuda.synchronize()
        check(epl_kernels.correlate_pallas_bank.launches == before + 1,
              f"{name} launched the transition route once")
        want = epl_kernels.correlate_bank_rows_reference(**case, route="pallas_bank")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape == ((k, taps) if a == 1 else (k, a, taps)),
                  f"{name} shape")
            check(bool(torch.isfinite(g).all()), f"{name} finite")
            err = max(err, float((g - w).abs().max()))
            check(bool(((g - w).abs() <= 4.5 + 2e-3 * w.abs()).all()),
                  f"{name}: kernel vs plain within rtol=2e-3 atol=4.5")
        worst = max(worst, err)
        log(f"[kernel] bank_transition {name}: {system.name} N={n} K={k} A={a} L={taps}: "
            f"max|kernel-plain|={err!r} (atol 4.5, rtol 2e-3) ok")
    return worst


def bank_states(system, init_errors: bool, num_taps: int = 3):
    from gpuacceleratedtracking_tpu_torch.tracking import init_state

    dops = np.linspace(-4000.0, 4000.0, NUM_K)
    phases = np.zeros(NUM_K)
    nsat = len(SAT_DOPPLERS)
    dops[:nsat] = SAT_DOPPLERS + (20.0 if init_errors else 0.0)
    phases[:nsat] = (SAT_CODE_PHASES - (0.2 if init_errors else 0.0)) % system.code_length
    return init_state(np.arange(NUM_K) % 32, carrier_doppler=dops,
                      code_phase=phases, num_taps=num_taps, device=DEVICE)


def mixed_blocks(system, num_blocks, noise_std=0.0, generator=None, num_ants=None):
    """``[B, N]`` planes of the 8-satellite GPS L1 signal at 32.768 MHz, or
    ``[B, A, N]`` with antenna a rotated by ``a * ANT_PHASE``."""
    from gpuacceleratedtracking_tpu_torch.models import gen_signal_mixed, soa

    signal, fs = gen_signal_mixed(
        system, np.arange(len(SAT_DOPPLERS)), SAT_DOPPLERS, N_1MS * num_blocks,
        duration=num_blocks * 1e-3, start_code_phases=SAT_CODE_PHASES,
        noise_std=0.0 if num_ants else noise_std, generator=generator, device=DEVICE)
    if not num_ants:
        sre, sim = (x.reshape(num_blocks, N_1MS) for x in soa(signal))
        return sre, sim, fs
    steer = torch.polar(torch.ones(num_ants, device=DEVICE),
                        ANT_PHASE * torch.arange(num_ants, dtype=torch.float32, device=DEVICE))
    array = signal[None, :] * steer[:, None]                         # [A, B*N]
    del signal
    if noise_std:
        noise = torch.randn(array.shape + (2,), generator=generator, device=DEVICE)
        array += noise_std * torch.complex(noise[..., 0], noise[..., 1])
        del noise
    array = array.view(num_ants, num_blocks, N_1MS).transpose(0, 1)
    sre, sim = soa(array)
    return sre, sim, fs


def steering_weights():
    """``(w_re, w_im)`` ``[A]``: the array's per-antenna rotation."""
    phase = ANT_PHASE * np.arange(NUM_ANTS)
    return np.cos(phase), np.sin(phase)


def main_path(system, seed, num_blocks_lock: int = 600):
    """Phase 4, rows: the K=1024 closed loop through the kernel, vs the plain bank.

    The comparison with ``xla_bank`` runs on the noiseless mix, where a chip
    boundary that lands one sample apart moves an accumulator by a bounded
    amount; the lock run adds noise for C/N0 = 50 dB-Hz.
    """
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    sre, sim, fs = mixed_blocks(system, 20)
    codes = torch.as_tensor(system.codes, device=DEVICE)
    config = TrackConfig.for_system(system, fs, N_1MS, algorithm="pallas_bank_auto")
    plain = TrackConfig.for_system(system, fs, N_1MS, algorithm="xla_bank")
    states = bank_states(system, init_errors=True)

    # Counted run: 20 blocks through the entry point a user calls.
    reset_counts()
    _, out = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["bank_rows"]
    check(counts == {"bank_rows": 20, "bank_comp": 0, "bank_transition": 0},
          f"20 bank_rows launches in 20 blocks and no other kernel, got {counts}")
    for field, x in out._asdict().items():
        check(bool(torch.isfinite(x.float()).all()), f"main path {field} finite")
    check(out.prompt_re.shape == (20, NUM_K), "prompt_re shape")
    _, ref = track_bank(plain, codes, states, sre, sim)
    torch.cuda.synchronize()
    # Channels 8..1023 track no signal: their loops run on cross-correlation
    # noise and are chaotic, so one f32 rounding apart in block 0 grows into
    # unrelated trajectories within ~10 blocks. They are compared in block 0,
    # where both runs start from the same state; the 8 locked channels are
    # compared over every block.
    nsat = len(SAT_DOPPLERS)
    diff = (out.prompt_re - ref.prompt_re).abs()
    bound = 40.0 + 5e-3 * ref.prompt_re.abs()
    d_first = float(diff[0].max())
    d_locked = float(diff[:, :nsat].max())
    d_dop = float((out.carrier_doppler - ref.carrier_doppler)[:, :nsat].abs().max())
    check(bool((diff[0] <= bound[0]).all()),
          f"block 0 prompt_re vs xla_bank within rtol=5e-3 atol=40 ({d_first!r})")
    check(bool((diff[:, :nsat] <= bound[:, :nsat]).all()),
          f"locked prompt_re vs xla_bank within rtol=5e-3 atol=40 ({d_locked!r})")
    log(f"[main] track_bank K={NUM_K} N={N_1MS} 20 blocks via pallas_bank_auto: "
        f"launches={counts}; vs xla_bank: block 0 all channels max|d prompt_re|="
        f"{d_first!r}, 8 locked channels all blocks max|d prompt_re|={d_locked!r}, "
        f"max|d carrier_doppler|={d_dop!r} Hz; all finite")

    # Lock: the 8 matched channels over num_blocks_lock noisy blocks.
    del out, ref
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    noisy_re, noisy_im, _ = mixed_blocks(system, num_blocks_lock, NOISE_STD, gen)
    _, out = track_bank(config, codes, states, noisy_re, noisy_im)
    torch.cuda.synchronize()
    dop = out.carrier_doppler[-50:, :nsat].double().mean(0).cpu().numpy()
    mag = torch.hypot(out.prompt_re[-50:, :nsat], out.prompt_im[-50:, :nsat])
    mag = mag.double().mean(0).cpu().numpy()
    cn0 = out.cn0_dbhz[-1, :nsat].cpu().numpy()
    dop_err = np.abs(dop - SAT_DOPPLERS)
    for i in range(nsat):
        log(f"[lock] sat {i}: truth {float(SAT_DOPPLERS[i])!r} Hz, mean Doppler"
            f"(last 50) {float(dop[i])!r} Hz, mean |prompt| {float(mag[i])!r}, "
            f"C/N0 {float(cn0[i])!r} dB-Hz")
    check(bool(np.all(dop_err < 5.0)), f"Doppler within 5 Hz: {dop_err.tolist()}")
    check(bool(np.all(mag > N_1MS / 2)), f"|prompt| > N/2: {mag.tolist()}")
    check(bool(torch.isfinite(out.prompt_re).all()), "lock run finite")
    return launches, sre, sim


def array_path(system, seed, num_blocks_lock: int = 300):
    """Phase 4, path A: the steered K=1024, A=4, L=7 bank through the composite kernel."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    sre, sim, fs = mixed_blocks(system, 20, num_ants=NUM_ANTS)
    codes = torch.as_tensor(system.codes, device=DEVICE)
    config = TrackConfig.for_system(system, fs, N_1MS, num_correlators=7,
                                    algorithm="pallas_bank_auto")
    check(epl_kernels.bank_algorithm_for(N_1MS, fs, system.code_length,
                                         system.code_frequency, num_ants=NUM_ANTS)
          == "pallas_bank_comp", "path A routes to pallas_bank_comp")
    states = bank_states(system, init_errors=True, num_taps=7)
    weights = steering_weights()
    nsat = len(SAT_DOPPLERS)

    reset_counts()
    _, out = track_bank(config, codes, states, sre, sim, ant_weights=weights)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["bank_comp"]
    check(counts == {"bank_rows": 0, "bank_comp": 20, "bank_transition": 0},
          f"20 bank_comp launches in 20 blocks and no other kernel, got {counts}")
    for field, x in out._asdict().items():
        check(bool(torch.isfinite(x.float()).all()), f"path A {field} finite")
    check(out.accum_re.shape == (20, NUM_K, NUM_ANTS, 7), "path A accum shape")
    plain = dataclasses.replace(config, algorithm="xla_bank")
    _, ref = track_bank(plain, codes, states, sre, sim, ant_weights=weights)
    torch.cuda.synchronize()
    diff = (out.prompt_re - ref.prompt_re).abs()
    bound = 40.0 + 5e-3 * ref.prompt_re.abs()
    d_first, d_locked = float(diff[0].max()), float(diff[:, :nsat].max())
    check(bool((diff[0] <= bound[0]).all()),
          f"path A block 0 prompt_re vs xla_bank within rtol=5e-3 atol=40 ({d_first!r})")
    check(bool((diff[:, :nsat] <= bound[:, :nsat]).all()),
          f"path A locked prompt_re vs xla_bank within rtol=5e-3 atol=40 ({d_locked!r})")
    log(f"[path A] track_bank K={NUM_K} A={NUM_ANTS} L=7 N={N_1MS} 20 blocks, steered, "
        f"via pallas_bank_auto: launches={counts}; vs xla_bank: block 0 max|d prompt_re|="
        f"{d_first!r}, 8 locked channels all blocks {d_locked!r}; all finite")

    # bf16 z-planes against f32, the JAX suite's tracking-grade tolerances
    # (tests/test_tracking.py:282-291): prompts on block 0 of every channel
    # and every block of the locked channels; Doppler and code phase on the
    # locked channels (an unmatched channel's discriminators act on
    # cross-correlation noise, where the bf16 rounding moves them freely).
    bf16 = dataclasses.replace(config, z_dtype="bf16")
    before = read_counts()["bank_comp"]
    _, outb = track_bank(bf16, codes, states, sre, sim, ant_weights=weights)
    torch.cuda.synchronize()
    check(read_counts()["bank_comp"] == before + 20, "bf16 run: one comp launch per block")
    scale = float(out.prompt_re.abs().max())
    d_p = (outb.prompt_re - out.prompt_re).abs()
    d_d = (outb.carrier_doppler - out.carrier_doppler)[:, :nsat].abs()
    d_c = (outb.code_phase - out.code_phase)[:, :nsat].abs()
    check(bool((d_p[0] <= 5e-3 * scale).all()),
          f"bf16 block 0 prompt_re within 5e-3*scale ({float(d_p[0].max())!r})")
    check(bool((d_p[:, :nsat] <= 5e-3 * scale).all()),
          f"bf16 locked prompt_re within 5e-3*scale ({float(d_p[:, :nsat].max())!r})")
    check(bool((d_d <= 1.0 + 1e-3 * out.carrier_doppler[:, :nsat].abs()).all()),
          f"bf16 locked Doppler within rtol 1e-3 atol 1 ({float(d_d.max())!r})")
    check(bool((d_c <= 5e-3 + 1e-4 * out.code_phase[:, :nsat].abs()).all()),
          f"bf16 locked code phase within rtol 1e-4 atol 5e-3 ({float(d_c.max())!r})")
    log(f"[path A] bf16 z vs f32: max|d prompt_re| block 0 {float(d_p[0].max())!r}, "
        f"locked {float(d_p[:, :nsat].max())!r} (bound {5e-3 * scale!r}); locked "
        f"max|d Doppler| {float(d_d.max())!r} Hz, max|d code phase| {float(d_c.max())!r} chips")
    del out, ref, outb

    # Lock with noise, and the array gain of the steering weights.
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    noisy_re, noisy_im, _ = mixed_blocks(system, num_blocks_lock, NOISE_STD, gen,
                                         num_ants=NUM_ANTS)
    _, out = track_bank(config, codes, states, noisy_re, noisy_im, ant_weights=weights)
    torch.cuda.synchronize()
    del noisy_re, noisy_im
    pidx = config.prompt_index
    dop = out.carrier_doppler[-50:, :nsat].double().mean(0).cpu().numpy()
    steered = torch.hypot(out.prompt_re[-50:, :nsat], out.prompt_im[-50:, :nsat])
    uniform = torch.hypot(out.accum_re[-50:, :nsat, :, pidx].sum(-1),
                          out.accum_im[-50:, :nsat, :, pidx].sum(-1))
    steered = steered.double().mean(0).cpu().numpy()
    uniform = uniform.double().mean(0).cpu().numpy()
    dop_err = np.abs(dop - SAT_DOPPLERS)
    for i in range(nsat):
        log(f"[path A lock] sat {i}: truth {float(SAT_DOPPLERS[i])!r} Hz, mean Doppler"
            f"(last 50) {float(dop[i])!r} Hz, steered |prompt| {float(steered[i])!r}, "
            f"uniform-sum |prompt| {float(uniform[i])!r}")
    check(bool(np.all(dop_err < 5.0)), f"path A Doppler within 5 Hz: {dop_err.tolist()}")
    check(bool(np.all(steered > uniform)), "steered |prompt| above the uniform sum")
    check(bool(np.all(steered > NUM_ANTS * N_1MS / 2)), f"steered |prompt|: {steered.tolist()}")
    check(bool(torch.isfinite(out.prompt_re).all()), "path A lock run finite")
    return launches


def l5_dual_blocks(num_blocks, offsets, navs, generator):
    """``[B, N]`` planes: 8 GPS L5 satellites, I5 = code x NH10 x nav and Q5 =
    code x NH20 in quadrature, satellite s starting at overlay phase
    ``offsets[s]`` (its millisecond count mod 20), plus noise."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5, gen_signal, gpsl5, soa

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    nh10 = gpsl5.neuman_hofman(False)
    total = None
    for s, (prn, dop, phi) in enumerate(zip(L5_PRNS, L5_DOPPLERS, L5_CODE_PHASES)):
        # Data overlay x nav symbols, indexed by the satellite's millisecond count.
        ms = np.arange(offsets[s] + num_blocks + 1)
        data_overlay = nh10[ms % 10] * navs[s][ms // 10]
        common = dict(duration=num_blocks * 1e-3, start_code_phase=float(phi),
                      code_frequency=sys_i.code_frequency * (1 + dop / sys_i.center_frequency),
                      secondary_phase=int(offsets[s]), device=DEVICE)
        sig_i, _ = gen_signal(sys_i, int(prn), float(dop), N_1MS * num_blocks,
                              secondary_code=data_overlay, **common)
        sig_q, _ = gen_signal(sys_q, int(prn), float(dop), N_1MS * num_blocks,
                              secondary_code=sys_q.secondary_code,
                              start_carrier_phase=np.pi / 2, **common)
        sig = sig_i + sig_q
        total = sig if total is None else total + sig
    noise = torch.randn(total.shape + (2,), generator=generator, device=DEVICE)
    total += L5_NOISE_STD * torch.complex(noise[..., 0], noise[..., 1])
    sre, sim = (x.reshape(num_blocks, N_1MS) for x in soa(total))
    return sre, sim


def dual_states(ms_elapsed, sat_dopplers):
    """K=64 dual channels: the 8 satellites first (at ``sat_dopplers``), then
    other PRNs spread over +/-4 kHz; ``ms_elapsed`` aligns the satellites'
    overlay wipe-off."""
    from gpuacceleratedtracking_tpu_torch.tracking import init_state

    nsat = len(L5_PRNS)
    others = np.setdiff1d(np.arange(37), L5_PRNS)
    prns = np.concatenate([L5_PRNS, np.resize(others, DUAL_K - nsat)])
    dops = np.linspace(-4000.0, 4000.0, DUAL_K)
    dops[:nsat] = sat_dopplers
    phases = np.zeros(DUAL_K)
    phases[:nsat] = L5_CODE_PHASES
    ms = np.zeros(DUAL_K, np.int64)
    ms[:nsat] = ms_elapsed
    return init_state(prns, carrier_doppler=dops, code_phase=phases, ms_elapsed=ms,
                      device=DEVICE)


def dual_path(seed, num_blocks: int = 200):
    """Phase 4, path B: GPS L5 dual-component bank, overlay sync, lock, symbols."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5, gpsl5
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, detect_secondary_offset, dual_config, phase_lock_metric,
        track_bank_dual)

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    rng = np.random.default_rng(seed + 2)
    nsat = len(L5_PRNS)
    offsets = rng.integers(0, 20, nsat)
    navs = rng.choice([-1.0, 1.0], (nsat, (20 + num_blocks) // 10 + 1))
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    sre, sim = l5_dual_blocks(num_blocks, offsets, navs, gen)
    fs = L1_FS
    check(epl_kernels.bank_algorithm_for(N_1MS, fs, sys_i.code_length,
                                         sys_i.code_frequency) == "pallas_bank",
          "path B routes to pallas_bank")
    codes_i = torch.as_tensor(sys_i.codes, device=DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=DEVICE)
    config = dual_config(TrackConfig.for_system(sys_i, fs, N_1MS, algorithm="pallas_bank_auto",
                                                use_secondary=False))
    # Secondary sync from a 10 Hz acquisition error: Costas (sign-tolerant)
    # on raw prompts, no wipe-off.
    sync_config = dataclasses.replace(config, pll_discriminator="costas")
    sync_blocks = 60
    reset_counts()
    _, sync = track_bank_dual(sync_config, codes_i, codes_q,
                              dual_states(0, L5_DOPPLERS + 10.0),
                              sre[:sync_blocks], sim[:sync_blocks],
                              data_secondary=np.ones(10), pilot_secondary=np.ones(20))
    settle = 20
    found, conf = detect_secondary_offset(sync.pilot.prompt_re[settle:, :nsat],
                                          gpsl5.neuman_hofman(True))
    # The window starts at block `settle`: block settle + i carries
    # NH20[(i + found) % 20], so the start phase is (found - settle) mod 20.
    found = ((found.long() - settle) % 20).cpu().numpy()
    conf = conf.cpu().numpy()
    handover = sync.pilot.carrier_doppler[-40:, :nsat].double().mean(0).cpu().numpy()
    log(f"[path B sync] planted overlay phases {offsets.tolist()}, found "
        f"{found.tolist()}, confidence {[float(c) for c in conf]}; Doppler handed "
        f"over with errors {np.abs(handover - L5_DOPPLERS).tolist()} Hz")
    check(bool(np.array_equal(found, offsets)), "detect_secondary_offset recovers the phases")
    check(bool(np.all(conf > 0.9)), "overlay sync confidence > 0.9")

    # Pilot-driven tracking from the start of the record, overlays aligned by
    # the sync, Doppler handed over from the sync run's last 40 blocks.
    _, out = track_bank_dual(config, codes_i, codes_q, dual_states(found, handover), sre, sim)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["bank_transition"]
    check(counts == {"bank_rows": 0, "bank_comp": 0,
                     "bank_transition": sync_blocks + num_blocks},
          f"one 128-channel pallas_bank launch per block and no other kernel, got {counts}")
    for field, x in out.pilot._asdict().items():
        check(bool(torch.isfinite(x.float()).all()), f"path B {field} finite")
    check(out.data_prompt_re.shape == (num_blocks, DUAL_K), "data prompt shape")
    lock = phase_lock_metric(out.pilot.prompt_re[-100:, :nsat],
                             out.pilot.prompt_im[-100:, :nsat]).cpu().numpy()
    dop = out.pilot.carrier_doppler[-50:, :nsat].double().mean(0).cpu().numpy()
    dsign = np.sign(out.data_prompt_re[-100:, :nsat].cpu().numpy())
    ms = found[None, :] + np.arange(num_blocks - 100, num_blocks)[:, None]
    want = navs[np.arange(nsat)[None, :], ms // 10]
    wrong = (dsign != want).sum(0)
    log(f"[path B] track_bank_dual K={DUAL_K} (128-channel bank) N={N_1MS} "
        f"{sync_blocks}+{num_blocks} blocks: launches={counts}; lock metric (last 100, "
        f"20-block windows) min {float(lock.min())!r}; Doppler error "
        f"{np.abs(dop - L5_DOPPLERS).tolist()} Hz; wrong data signs (last 100) "
        f"{wrong.tolist()}")
    check(bool(np.all(lock > 0.85)), f"phase lock: {lock.tolist()}")
    check(bool(np.all(np.abs(dop - L5_DOPPLERS) < 5.0)), "path B Doppler within 5 Hz")
    check(bool(np.all(wrong == 0)), "data prompt signs reproduce the planted symbols")
    return launches, sre, sim, found


def ptxas_summary(log_path):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    its name and template arguments, registers, and spills."""
    if not log_path.exists():
        return []
    lines, kernel = [], None
    for line in log_path.read_text().splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d+(bank_[a-z_]+?(?:kernel|finish))"
                          r"(I(?:L[ib]\d+E)+E)?", line)
        if entry:
            args = re.findall(r"L[ib](\d+)E", entry.group(2) or "")
            kernel = entry.group(1) + (f"<{','.join(args)}>" if args else "")
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line:
            lines.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
            kernel = None
    return lines


def time_cuda(fn, reps=TIMING_REPS, warmup=3):
    """Per-call milliseconds with CUDA events: (median, min)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), min(times)


def kernel_vs_plain(name, launch, plain, card, per_rep=10, samples=None):
    """Kernel alone (``per_rep`` launches back to back) vs the plain version,
    in turns: plain, kernel, kernel, plain."""
    def kern():
        for _ in range(per_rep):
            launch()

    p1 = time_cuda(plain)
    k1 = time_cuda(kern)
    k2 = time_cuda(kern)
    p2 = time_cuda(plain)
    k_med = statistics.median([k1[0], k2[0]]) / per_rep
    k_min = min(k1[1], k2[1]) / per_rep
    p_med, p_min = statistics.median([p1[0], p2[0]]), min(p1[1], p2[1])
    res = dict(kernel_ms=k_med, kernel_min_ms=k_min, plain_ms=p_med, plain_min_ms=p_min)
    rate = ""
    if samples:
        res["msamples_per_s"] = samples / (k_med * 1e-3) / 1e6
        rate = f"; kernel {res['msamples_per_s']!r} Msample-channels/s"
    log(f"[time] {name}: kernel median {k_med!r} ms (min {k_min!r}); plain median "
        f"{p_med!r} ms (min {p_min!r}){rate} [{card}]")
    return res


def timings(system, seed, sre, sim, sre_l5, sim_l5, l5_offsets, card):
    """Phase 5: kernels vs their plain versions, and the closed-loop blocks."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp, epl_kernels
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, loop_update, track_bank, track_bank_dual)

    results = {}
    for n in (N_1MS, N_WIDE):
        case = random_case(system, n, NUM_K, seed + 100 + n)
        case["code_tiles"] = epl_kernels.prepare_bank_code_tiles_rows(
            case["codes"], case["prn"])
        prepared = epl_kernels.BankRowsCall(**case)
        res = kernel_vs_plain(
            f"bank_rows K={NUM_K} N={n}", lambda: epl_kernels.launch_bank_rows(prepared),
            lambda: epl_kernels.correlate_bank_rows_reference(**case), card,
            samples=NUM_K * n)
        w = time_cuda(lambda: epl_kernels.correlate_pallas_bank_rows(**case))
        res.update(wrapper_ms=w[0], wrapper_min_ms=w[1])
        log(f"[time] bank_rows K={NUM_K} N={n}: wrapper call incl. per-call set-up "
            f"median {w[0]!r} ms (min {w[1]!r}) [{card}]")
        results[f"bank_rows_n{n}"] = res

    case = random_case(system, N_1MS, NUM_K, seed + 200, num_ants=NUM_ANTS, taps=7)
    case["code_tiles"] = epl_kernels.prepare_bank_code_tiles_rows(case["codes"], case["prn"])
    for z in ("f32", "bf16"):
        prepared = bank_comp.BankCompCall(**case, z_dtype=z)
        results[f"bank_comp_{z}"] = kernel_vs_plain(
            f"bank_comp K={NUM_K} A={NUM_ANTS} L=7 N={N_1MS} z={z}",
            lambda: bank_comp.launch_bank_comp(prepared),
            lambda: bank_comp.correlate_bank_comp_reference(**case, z_dtype=z), card,
            samples=NUM_K * N_1MS)
    del case, prepared

    l5 = GPSL5()
    case = random_case(l5, N_1MS, 2 * DUAL_K, seed + 300)
    case["code_tiles"] = epl_kernels.prepare_bank_code_tiles_rows(case["codes"], case["prn"])
    prepared = epl_kernels.BankRowsCall(**case, route="pallas_bank")
    results["bank_transition"] = kernel_vs_plain(
        f"bank_transition (pallas_bank) GPS L5 K={2 * DUAL_K} N={N_1MS}",
        lambda: epl_kernels.launch_bank_rows(prepared),
        lambda: epl_kernels.correlate_bank_rows_reference(**case, route="pallas_bank"),
        card, samples=2 * DUAL_K * N_1MS)
    del case, prepared

    codes = torch.as_tensor(system.codes, device=DEVICE)
    fs = N_1MS / 1e-3
    config = TrackConfig.for_system(system, fs, N_1MS, algorithm="pallas_bank_auto")
    states = bank_states(system, init_errors=False)
    acc = torch.randn((NUM_K, 3), generator=torch.Generator(device=DEVICE).manual_seed(seed),
                      device=DEVICE) * 1000.0
    med, mn = time_cuda(lambda: loop_update(config, states, acc, acc))
    results["loop_update"] = dict(ms=med, min_ms=mn)
    log(f"[time] loop_update alone K={NUM_K}: median {med!r} ms (min {mn!r}) [{card}]")

    blocks = 10

    def closed_loop(name, run, channels):
        med, mn = time_cuda(run, reps=TIMING_REPS, warmup=2)
        med, mn = med / blocks, mn / blocks
        results[name] = dict(block_ms=med, block_min_ms=mn, realtime_channels=channels / med)
        log(f"[time] closed-loop block {name}: median {med!r} ms (min {mn!r}); "
            f"real-time channels at 1 ms blocks: {channels / med!r} [{card}]")

    for algo in ("pallas_bank_auto", "xla_bank"):
        config = TrackConfig.for_system(system, fs, N_1MS, algorithm=algo)
        states = bank_states(system, init_errors=False)
        closed_loop(f"rows_K{NUM_K}_{algo}",
                    lambda: track_bank(config, codes, states, sre[:blocks], sim[:blocks]),
                    NUM_K)

    are, aim, _ = mixed_blocks(system, blocks, num_ants=NUM_ANTS)
    weights = steering_weights()
    for z in ("f32", "bf16"):
        config = TrackConfig.for_system(system, fs, N_1MS, num_correlators=7,
                                        algorithm="pallas_bank_auto", z_dtype=z)
        states = bank_states(system, init_errors=False, num_taps=7)
        closed_loop(f"array_K{NUM_K}_A{NUM_ANTS}_L7_{z}",
                    lambda: track_bank(config, codes, states, are, aim, ant_weights=weights),
                    NUM_K)
    del are, aim

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    codes_i = torch.as_tensor(sys_i.codes, device=DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=DEVICE)
    config = dual_config(TrackConfig.for_system(sys_i, fs, N_1MS, algorithm="pallas_bank_auto",
                                                use_secondary=False))
    states = dual_states(l5_offsets, L5_DOPPLERS)
    closed_loop(f"l5_dual_K{DUAL_K}",
                lambda: track_bank_dual(config, codes_i, codes_q, states,
                                        sre_l5[:blocks], sim_l5[:blocks]),
                DUAL_K)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    # Phase 1: device.
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions' matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    from gpuacceleratedtracking_tpu_torch.models import GPSL1
    from gpuacceleratedtracking_tpu_torch.ops import _build

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_paths = _build.build()
    for stem in _build.SIGNATURES:
        _build.load_library(stem)
    build_s = time.perf_counter() - t0
    log(f"[build] {[p.name for p in lib_paths]} in {build_s!r} s")
    for path in lib_paths:
        for line in ptxas_summary(path.with_suffix(".log")):
            log(f"[build] {line}")

    system = GPSL1()
    t0 = time.perf_counter()
    errs = {"bank_rows": kernel_cells(system, args.seed),
            "bank_comp": comp_cells(system, args.seed),
            "bank_transition": transition_cells(args.seed)}
    log(f"[phase] kernel cells in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    rows_launches, sre, sim = main_path(system, args.seed)
    launches = {"bank_rows": rows_launches}
    launches["bank_comp"] = array_path(system, args.seed)
    launches["bank_transition"], sre_l5, sim_l5, l5_offsets = dual_path(args.seed)
    log(f"[phase] main paths in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    times = timings(system, args.seed, sre, sim, sre_l5, sim_l5, l5_offsets, card)
    log(f"[phase] timings in {time.perf_counter() - t0!r} s")

    entries = [
        ("bank_rows", "gpuacceleratedtracking_tpu_torch/csrc/bank_rows.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:1448", times[f"bank_rows_n{N_1MS}"]),
        ("bank_comp", "gpuacceleratedtracking_tpu_torch/csrc/bank_comp.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:1886", times["bank_comp_f32"]),
        ("bank_transition", "gpuacceleratedtracking_tpu_torch/csrc/bank_rows.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:602", times["bank_transition"]),
    ]
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": errs[name],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
    } for name, source, replaces, t in entries]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": card, "build_s": build_s,
                       "kernels": kernels["kernels"], "times": times}, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
