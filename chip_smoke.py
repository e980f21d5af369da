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
     L5 K=128, the L5 A=4 L=7 cell at K=8, GPS L1 at 4.096 MHz K=64;
   - the one-hot route (``pallas_bank_onehot``, served by ``bank_rows.cu``):
     K=2 with the span (-160, 0, 170) at N=4096, and K=1024 at N=32768;
   - ``taps`` and ``fused`` (one channel): the cases of tests/test_pallas.py
     (golden N=2500, PRN 5 with offsets, A=4, L=7, GPS L5, a wide span,
     N=1000, L=7 natively at N=131072), N=2^18 at A=4, L=7, the sweep's
     launch-weighted corner N=32768 and its smallest block N=2^11, ragged
     blocks at A=4 (N=20000, and N=2^11+1, which takes the scalar loads),
     ~2 chips per sample and a negative chip rate (the general chip wrap),
     and a span past the fused kernel's replica row (its per-tap lookup).
4. Main paths, each through the entry points a user calls, with every launch
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
     (``phase_lock_metric``) and the planted symbols in the data prompts;
   - C, the paper's per-channel kernel sweep: ``bench.run_sweep`` over
     ``bench.run_kernel_benchmark`` on the grids of
     scripts/run_benchmarks_gpsl1.py (N = 2^11..2^18, M in {1, 4},
     L in {3, 7}, fused_xla / unfused_xla / pallas_fused / pallas_taps: 128
     configurations) and scripts/run_benchmarks_gpsl5.py (N = 2^15..2^18: 64),
     on the GPU with ``reps="auto"``; every kernel call must have launched
     ``taps.cu`` or ``fused.cu``. The blocks of N <= 32768 run first, then
     the larger ones, each part with the counts set to 0 before it and read
     after it (``launches_n_le_32768`` in the ``kernels`` line is the first
     part's count). One JSON file per configuration goes to
     ``kernel_sweep/`` beside ``--out`` (else under ``build/``);
   - D, closed loops on the new kernels: ``track`` on one GPS L1 satellite
     through ``pallas_fused`` (600 blocks at 50 dB-Hz from a 20 Hz / 0.2 chip
     start hold lock), ``track_bank`` with ``pallas_fused`` at K=8 against
     ``fused_xla``, ``track_bank`` with ``pallas_bank_onehot`` at K=1024 (one
     launch per block, against ``xla_bank``), and the port's
     ``run_track_benchmark`` (K=1024) and ``run_dual_track_benchmark`` (K=64).
5. Times (CUDA events, after warm-up; medians and minima): each kernel vs its
   plain version at main-path shapes (every kernel, and the per-channel
   kernels' plain versions, also as device time from a CUDA graph replay:
   ``ms`` in the ``kernels`` line, ``eager_ms`` beside it; for ``taps`` and
   ``fused`` at both sweep corners, N=32768 A=1 L=3 and N=2^18 A=4 L=7, with
   the wrapper call's time and its device ops per call from torch.profiler,
   under ``corners``), the closed-loop
   block of each path, and for ``bank_comp`` the library yardstick: one
   ``torch.matmul`` of a materialized ``[2K, U]`` Z against ``[U, 2AL]`` S
   (f32 with TF32 off, and bf16), which the port never calls.

Its last lines are one JSON object describing the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Each kernel's entry
holds its launches on its main path and per block (or per call), its largest
error against its plain version, its device time (``ms``; ``eager_ms`` with
the host's launch work) and its plain version's (``plain_ms``; ``clock``
says how each was read), ``library_ms`` (null where no single PyTorch call computes
the function), and ``bound_ms``: the least time the card could take for the
same work, the larger of this run's input and output bytes over 3.35 TB/s
and the correlator's floating-point operations over the peak of their type
(``bound_by`` "bytes" or "operations"; ``bound_unit`` "memory", "f32"
(67 TFLOP/s), "tf32x3" (three TF32 tensor-core passes, 495 TFLOP/s each) or
"bf16" (989 TFLOP/s): the H100 SXM's published dense peaks).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
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
# Published dense peaks of one H100 SXM: FLOP/s per operand type, bytes/s of HBM3.
PEAK_FLOPS = {"f32": 67e12, "tf32x3": 495e12 / 3, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# Trials per sweep configuration: 3 keeps the 192-configuration sweep near
# 2 minutes of chip time (7, the scripts' default, takes ~4).
SWEEP_TRIALS = 3
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
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp, channel_kernels, epl_kernels

    return {"bank_rows": epl_kernels.correlate_pallas_bank_rows,
            "bank_comp": bank_comp.correlate_pallas_bank_comp,
            "bank_transition": epl_kernels.correlate_pallas_bank,
            "bank_onehot": epl_kernels.correlate_pallas_bank_onehot,
            "taps": channel_kernels.correlate_pallas_taps,
            "fused": channel_kernels.correlate_pallas_fused}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def only(**launches) -> dict:
    """The counts expected when just the named kernels ran."""
    return {name: launches.get(name, 0) for name in counters()}


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


# Phase 3, the per-channel kernels: the cases of tests/test_pallas.py:42-110
# and :715-726, and the sweep's top corner.
# name -> (GNSS, N, A, taps or shifts, prn, f_carrier, carrier phase, code phase)
CHANNEL_CELLS = {
    "golden_n2500": ("GPSL1", 2500, 1, 3, 0, 1500.0, 0.0, 0.0),
    "offsets_prn5_n4096": ("GPSL1", 4096, 1, 3, 5, -2345.0, 0.9, 517.3),
    "a4_n2500": ("GPSL1", 2500, 4, 3, 0, 1500.0, 0.0, 0.0),
    "l7_n8192": ("GPSL1", 8192, 1, 7, 0, 1500.0, 0.0, 0.0),
    "l5_n32768": ("GPSL5", 32768, 1, 3, 3, 2000.0, 0.0, 0.0),
    "wide_span_n4096": ("GPSL1", 4096, 1, (-150, 0, 163), 0, 1500.0, 0.0, 0.0),
    "sub_tile_n1000": ("GPSL1", 1000, 1, 3, 0, 500.0, 0.0, 0.0),
    "wide_n131072_l7": ("GPSL1", 131072, 1, 7, 0, 1500.0, 0.0, 0.0),
    "n262144_a4_l7": ("GPSL1", 262144, 4, 7, 0, 1500.0, 0.0, 0.0),
    "n32768_l3": ("GPSL1", 32768, 1, 3, 7, -1200.0, 1.1, 311.7),
    "n2048": ("GPSL1", 2048, 1, 3, 2, 900.0, 0.4, 17.25),
    "ragged_n20000_a4": ("GPSL1", 20000, 4, 3, 1, 300.0, 2.0, 600.5),
    "ragged_n2049_a4_l5": ("GPSL1", 2049, 4, 5, 1, 300.0, 2.0, 600.5),
    "two_chips_per_sample_n512": ("GPSL1", 512, 1, 3, 0, 100.0, 0.0, 3.5),
    "negative_rate_a2": ("GPSL1", 8192, 2, 3, 0, 100.0, 0.0, 3.5, -1.023e6),
    "span_past_the_row": ("GPSL1", 8192, 1, (-4000, 0, 4000), 0, 1500.0, 0.0, 0.0),
}


def channel_args(gnss, n, a, taps, prn, fcar, phicar, phicode, fcode=None):
    """The registry signature's arguments for one channel, on the card
    (``fcode``: the code frequency, by default the system's)."""
    from gpuacceleratedtracking_tpu_torch.models import (
        EPLCorrelator, correlator_sample_shifts, gen_signal, get_system, soa)

    system = get_system(gnss)
    signal, fs = gen_signal(system, prn, fcar, n, num_ants=None if a == 1 else a,
                            start_code_phase=phicode, start_carrier_phase=phicar,
                            device=DEVICE)
    if isinstance(taps, int):
        taps = correlator_sample_shifts(system, EPLCorrelator(taps), fs)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=DEVICE)  # noqa: E731
    return (*soa(signal), torch.as_tensor(system.codes, device=DEVICE), t(prn, torch.int32),
            t(fcar), fs, t(phicar), t(system.code_frequency if fcode is None else fcode),
            t(phicode), tuple(int(d) for d in taps), system.code_length)


def channel_cells():
    """Phase 3, ``taps`` and ``fused``: each cell through the wrapper and the
    plain version. Both compute the same phases and chips with the same
    roundings, so they differ in summation order only: within 1e-6 of the
    block length (+1e-3). The golden cells must also hold the JAX golden
    tolerance (rtol 3.5e-4 of [1476, 2500, 1476])."""
    from gpuacceleratedtracking_tpu_torch.ops import channel_kernels

    worst = {"taps": 0.0, "fused": 0.0}
    golden = torch.tensor([1476.0, 2500.0, 1476.0], device=DEVICE)
    for name, cell in CHANNEL_CELLS.items():
        args = channel_args(*cell)
        n, a = cell[1], cell[2]
        num_taps = len(args[-2])
        tol = 1e-6 * n + 1e-3
        for kind in ("taps", "fused"):
            fn = getattr(channel_kernels, f"correlate_pallas_{kind}")
            before = fn.launches
            got = fn(*args)
            torch.cuda.synchronize()
            check(fn.launches == before + 1, f"{kind} {name} launched once")
            want = getattr(channel_kernels, f"correlate_{kind}_reference")(*args)
            err = 0.0
            for g, w in zip(got, want):
                check(g.shape == w.shape == ((num_taps,) if a == 1 else (a, num_taps)),
                      f"{kind} {name} shape")
                check(bool(torch.isfinite(g).all()), f"{kind} {name} finite")
                err = max(err, float((g - w).abs().max()))
            check(err <= tol, f"{kind} {name}: kernel vs plain {err!r} <= {tol!r}")
            note = ""
            if name in ("golden_n2500", "a4_n2500"):
                prompt = got[0].reshape(-1, 3)
                check(bool(((prompt - golden).abs() <= 3.5e-4 * golden).all()),
                      f"{kind} {name}: golden within rtol 3.5e-4, got {prompt.tolist()}")
                note = f"; EPL re {prompt[0].tolist()}, im {got[1].reshape(-1, 3)[0].tolist()}"
            worst[kind] = max(worst[kind], err)
            log(f"[kernel] {kind} {name}: {cell[0]} N={n} A={a} L={num_taps}: "
                f"max|kernel-plain|={err!r} (bound {tol!r}){note} ok")
    return worst


def onehot_cells(system, seed):
    """Phase 3, the one-hot route (``bank_rows.cu``, no envelope, no nominal
    rates): the wide-span K=2 cell of tests/test_pallas.py:370-394 and
    K=1024 at N=32768, within the rows route's tolerance."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    worst = 0.0
    for i, (name, n, k, shifts) in enumerate((("wide_span_k2", 4096, 2, (-160, 0, 170)),
                                              ("k1024", N_1MS, NUM_K, None))):
        case = random_case(system, n, k, seed + 60 + i)
        del case["nominal_code_frequency"]
        if shifts is not None:
            case["sample_shifts"] = shifts
            golden(case, system, k)
        before = epl_kernels.correlate_pallas_bank_onehot.launches
        got = epl_kernels.correlate_pallas_bank_onehot(**case)
        torch.cuda.synchronize()
        check(epl_kernels.correlate_pallas_bank_onehot.launches == before + 1,
              f"onehot {name} launched once")
        want = epl_kernels.correlate_bank_rows_reference(**case, route="pallas_bank_onehot")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape == (k, 3), f"onehot {name} shape")
            check(bool(torch.isfinite(g).all()), f"onehot {name} finite")
            err = max(err, float((g - w).abs().max()))
            check(bool(((g - w).abs() <= 4.5 + 2e-3 * w.abs()).all()),
                  f"onehot {name}: kernel vs plain within rtol=2e-3 atol=4.5")
        worst = max(worst, err)
        log(f"[kernel] bank_onehot {name}: N={n} K={k} shifts={case['sample_shifts']}: "
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
    check(counts == only(bank_rows=20),
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
    check(counts == only(bank_comp=20),
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
    check(counts == only(bank_transition=sync_blocks + num_blocks),
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


def sweep_path(out_dir):
    """Phase 4, C: the paper's per-channel kernel sweep through the port's
    `run_sweep` + `run_kernel_benchmark`, the grids of
    scripts/run_benchmarks_gpsl1.py and run_benchmarks_gpsl5.py on the card,
    in two parts: the blocks of N <= N_1MS, where most of the sweep's
    launches are, then the larger ones, each read from the launch counters
    of its own run. Returns the two kernels' launch counts in all and in the
    first part, and the results."""
    from gpuacceleratedtracking_tpu_torch.bench import run_kernel_benchmark, run_sweep

    algorithms = ["fused_xla", "unfused_xla", "pallas_fused", "pallas_taps"]
    grids = {"GPSL1": [2 ** e for e in range(11, 19)],
             "GPSL5": [2 ** e for e in range(15, 19)]}
    results = []
    parts = {}
    for part, keep in (("small", lambda n: n <= N_1MS), ("large", lambda n: n > N_1MS)):
        expected = {"taps": 0, "fused": 0}
        reset_counts()
        for gnss, sizes in grids.items():
            params = {"GNSS": gnss, "num_samples": [n for n in sizes if keep(n)],
                      "num_ants": [1, 4], "num_correlators": [3, 7], "algorithm": algorithms,
                      "processor": "GPU", "reps": "auto", "trials": SWEEP_TRIALS}
            paths = run_sweep(params, run_kernel_benchmark, out_dir, resume=False,
                              progress=False, skip_errors=False)
            for path in paths:
                r = json.loads(path.read_text())
                tag = (f"{r['GNSS']} N={r['num_samples']} M={r['num_ants']} "
                       f"L={r['num_correlators']} {r['algorithm']}")
                check("error" not in r, f"sweep {tag}: {r.get('error')}")
                check(all(math.isfinite(r[k]) and r[k] >= 0 for k in ("Minimum", "Median")),
                      f"sweep {tag}: finite times")
                check(r["backend"] == "cuda" and r["gpu_name"], f"sweep {tag} ran on the card")
                if r["algorithm"].startswith("pallas_"):
                    # Warm-up and every trial run reps + 2 reps calls.
                    calls = 3 * r["reps_resolved"] * (SWEEP_TRIALS + 1)
                    expected[r["algorithm"][len("pallas_"):]] += calls
                results.append(r)
                log(f"[sweep] {tag}: median {r['Median'] * 1e3!r} ms, min "
                    f"{r['Minimum'] * 1e3!r} ms, realtime_ratio {r['realtime_ratio']!r} "
                    f"(reps {r['reps_resolved']})")
        counts = read_counts()
        check(counts == only(**expected) and min(expected.values()) > 0,
              f"the sweep's kernel calls ({part} blocks) all launched taps.cu / fused.cu and "
              f"no other kernel: got {counts}, want {only(**expected)}")
        parts[part] = counts
    check(len(results) == 192, f"192 sweep configs, got {len(results)}")
    total = {name: parts["small"][name] + parts["large"][name] for name in counters()}
    small = {name: parts["small"][name] for name in ("taps", "fused")}
    log(f"[sweep] 192 configs, launches={total}, of which at N <= {N_1MS}: {small} "
        f"(counted in a run of their own); results in {out_dir}")
    return total, small, results


def channel_loops(system, seed, sre, sim, num_blocks_lock: int = 600):
    """Phase 4, D: closed loops on the per-channel kernels and the one-hot
    route through `track` / `track_bank`, and the port's closed-loop
    benchmarks. Returns the one-hot route's launch count."""
    from gpuacceleratedtracking_tpu_torch.bench import (
        run_dual_track_benchmark, run_track_benchmark)
    from gpuacceleratedtracking_tpu_torch.models import gen_signal, soa
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, init_state, track, track_bank)

    codes = torch.as_tensor(system.codes, device=DEVICE)
    fs = L1_FS
    nsat = len(SAT_DOPPLERS)

    # One satellite through `track` on pallas_fused: 600 noisy blocks at
    # 50 dB-Hz from a 20 Hz / 0.2 chip start.
    prn, dop, phi = 3, float(SAT_DOPPLERS[5]), float(SAT_CODE_PHASES[5])
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    f_code = system.code_frequency * (1 + dop / system.center_frequency)
    signal, _ = gen_signal(system, prn, dop, N_1MS * num_blocks_lock,
                           duration=num_blocks_lock * 1e-3, start_code_phase=phi,
                           code_frequency=f_code, noise_std=NOISE_STD, generator=gen,
                           device=DEVICE)
    one_re, one_im = (x.reshape(num_blocks_lock, N_1MS) for x in soa(signal))
    del signal
    config = TrackConfig.for_system(system, fs, N_1MS, algorithm="pallas_fused")
    state = init_state(prn, carrier_doppler=dop + 20.0, code_phase=phi - 0.2, device=DEVICE)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = track(config, codes, state, one_re, one_im)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) / num_blocks_lock * 1e3
    counts = read_counts()
    check(counts == only(fused=num_blocks_lock),
          f"track: one fused launch per block and no other kernel, got {counts}")
    del one_re, one_im
    mean_dop = float(out.carrier_doppler[-50:].double().mean())
    mag = float(torch.hypot(out.prompt_re[-50:], out.prompt_im[-50:]).double().mean())
    log(f"[loops] track, 1 satellite (PRN {prn + 1}), N={N_1MS}, {num_blocks_lock} blocks at "
        f"50 dB-Hz via pallas_fused: {block_ms!r} ms per block (host clock, first call "
        f"included); launches={counts}; truth {dop!r} Hz, mean Doppler "
        f"(last 50) {mean_dop!r} Hz, mean |prompt| {mag!r}, C/N0 "
        f"{float(out.cn0_dbhz[-1])!r} dB-Hz")
    check(abs(mean_dop - dop) < 5.0, "track via pallas_fused: Doppler within 5 Hz")
    check(mag > N_1MS / 2, "track via pallas_fused: |prompt| > N/2")
    check(bool(torch.isfinite(out.prompt_re).all()), "track via pallas_fused finite")

    # K=8 bank on the 8 satellites: K launches per block, against fused_xla.
    states = init_state(np.arange(nsat), carrier_doppler=SAT_DOPPLERS + 20.0,
                        code_phase=SAT_CODE_PHASES - 0.2, device=DEVICE)
    outs = {}
    for algo in ("pallas_fused", "fused_xla"):
        reset_counts()
        _, outs[algo] = track_bank(TrackConfig.for_system(system, fs, N_1MS, algorithm=algo),
                                   codes, states, sre, sim)
        torch.cuda.synchronize()
        want = only(fused=nsat * sre.shape[0]) if algo == "pallas_fused" else only()
        check(read_counts() == want, f"track_bank {algo}: launches {read_counts()}")
    diff = (outs["pallas_fused"].prompt_re - outs["fused_xla"].prompt_re).abs()
    check(bool((diff <= 40.0 + 5e-3 * outs["fused_xla"].prompt_re.abs()).all()),
          f"track_bank K=8 pallas_fused vs fused_xla within rtol=5e-3 atol=40 "
          f"({float(diff.max())!r})")
    log(f"[loops] track_bank K={nsat} N={N_1MS} {sre.shape[0]} blocks via pallas_fused "
        f"({nsat} launches per block) vs fused_xla: max|d prompt_re| {float(diff.max())!r}")

    # K=1024 through the one-hot route: one launch per block, against xla_bank.
    states = bank_states(system, init_errors=True)
    reset_counts()
    _, out = track_bank(TrackConfig.for_system(system, fs, N_1MS,
                                               algorithm="pallas_bank_onehot"),
                        codes, states, sre, sim)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["bank_onehot"]
    check(counts == only(bank_onehot=sre.shape[0]),
          f"one onehot launch per block and no other kernel, got {counts}")
    _, ref = track_bank(TrackConfig.for_system(system, fs, N_1MS, algorithm="xla_bank"),
                        codes, states, sre, sim)
    torch.cuda.synchronize()
    diff = (out.prompt_re - ref.prompt_re).abs()
    bound = 40.0 + 5e-3 * ref.prompt_re.abs()
    check(bool((diff[0] <= bound[0]).all()),
          f"onehot block 0 prompt_re vs xla_bank ({float(diff[0].max())!r})")
    check(bool((diff[:, :nsat] <= bound[:, :nsat]).all()),
          f"onehot locked prompt_re vs xla_bank ({float(diff[:, :nsat].max())!r})")
    log(f"[loops] track_bank K={NUM_K} N={N_1MS} {sre.shape[0]} blocks via pallas_bank_onehot: "
        f"launches={counts}; vs xla_bank: block 0 max|d prompt_re| {float(diff[0].max())!r}, "
        f"8 locked channels {float(diff[:, :nsat].max())!r}")
    del out, ref

    # The port's closed-loop benchmarks.
    benches = {"track_pallas_fused_block_ms": block_ms}
    for name, fn, cfg, kernel in (
            ("track", run_track_benchmark,
             {"GNSS": "GPSL1", "num_samples": N_1MS, "num_channels": NUM_K,
              "algorithm": "pallas_bank_auto"}, "bank_rows"),
            ("dual_track", run_dual_track_benchmark,
             {"GNSS": "GPSL5", "num_samples": N_1MS, "num_channels": DUAL_K,
              "algorithm": "pallas_bank_auto"}, "bank_transition")):
        reset_counts()
        r = fn(dict(cfg, processor="GPU", blocks=8, trials=7))
        counts = read_counts()
        check(counts[kernel] > 0 and sum(counts.values()) == counts[kernel],
              f"{name} benchmark launched {kernel} only: {counts}")
        check(math.isfinite(r["realtime_channels"]) and r["realtime_channels"] > 0,
              f"{name} benchmark realtime_channels")
        benches[name] = {k: r[k] for k in ("Median", "Minimum", "realtime_channels",
                                           "samples_per_s")}
        log(f"[loops] run_{name}_benchmark {cfg}: median {r['Median'] * 1e3!r} ms/block "
            f"(min {r['Minimum'] * 1e3!r}), realtime_channels {r['realtime_channels']!r}, "
            f"launches {counts}")
    return launches, benches


def ptxas_summary(log_path):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    its name and template arguments, registers, and spills."""
    if not log_path.exists():
        return []
    lines, kernel = [], None
    for line in log_path.read_text().splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d+"
                          r"((?:bank_[a-z_]+?|taps_|fused_)(?:kernel|finish))"
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


def device_ops_per_call(fn, calls=10):
    """Device ops (kernels, copies, memsets) per call of ``fn``, counted by
    torch.profiler over ``calls`` calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ops) / calls


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


def graph_ms(fn, per_graph=20):
    """Device milliseconds per call of ``fn``: ``per_graph`` calls captured in
    one CUDA graph, replayed, so no host work enters the span: (median, min)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    med, mn = time_cuda(graph.replay, warmup=2)
    return med / per_graph, mn / per_graph


def bound(flops, unit, *tensors, out_elems=0):
    """The least time for a kernel's work: its floating-point operations at
    the peak of ``unit``, or its bytes (each input tensor read once, each of
    ``out_elems`` f32 outputs written once) at the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + 4 * out_elems
    t_ops, t_mem = flops / PEAK_FLOPS[unit], nbytes / PEAK_BYTES
    ops = t_ops >= t_mem
    return {"bound_ms": max(t_ops, t_mem) * 1e3, "bound_by": "operations" if ops else "bytes",
            "bound_unit": unit if ops else "memory", "flops": flops, "bytes": nbytes}


def bank_bound(bank, unit="f32", comp=False):
    """`bound` of a bank kernel's call: the correlator's arithmetic, (6 + 4L)
    FLOP per antenna, sample and channel (derotation and L complex tap MACs);
    for the composite kernel the ``[2K, U] x [U, 2AL]`` product's 8 FLOP per
    antenna, tap, sample and channel."""
    k, a, taps, n = bank.num_k, bank.num_ants, len(bank.deltas), bank.num_samples
    flops = 8 * k * a * taps * n if comp else (6 + 4 * taps) * a * k * n
    return bound(flops, unit, bank.sre, bank.sim, bank.code_tiles, bank.params, bank.base,
                 out_elems=2 * k * a * taps)


def device_time(name, launch, card):
    """A bank kernel's device time per launch, from a CUDA graph replay: an
    eager launch also carries the wrapper's host work (~0.03 ms), which hides
    a kernel that runs for less."""
    med, mn = graph_ms(launch)
    log(f"[time] {name}: kernel device time (CUDA graph) median {med!r} ms (min {mn!r}) [{card}]")
    return {"kernel_graph_ms": med, "kernel_graph_min_ms": mn}


def kernel_vs_plain(name, launch, plain, card, per_rep=10, samples=None, graphs=False):
    """Kernel alone (``per_rep`` launches back to back) vs the plain version,
    in turns: plain, kernel, kernel, plain. With ``graphs``, also each one's
    device time from a CUDA graph replay (the host's per-call work left out)."""
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
    if graphs:
        res["kernel_graph_ms"], res["kernel_graph_min_ms"] = graph_ms(launch)
        res["plain_graph_ms"], res["plain_graph_min_ms"] = graph_ms(plain)
        rate += (f"; device time (CUDA graph) kernel {res['kernel_graph_ms']!r} ms, plain "
                 f"{res['plain_graph_ms']!r} ms")
    log(f"[time] {name}: kernel median {k_med!r} ms (min {k_min!r}); plain median "
        f"{p_med!r} ms (min {p_min!r}){rate} [{card}]")
    return res


def timings(system, seed, sre, sim, sre_l5, sim_l5, l5_offsets, card):
    """Phase 5: kernels vs their plain versions, and the closed-loop blocks."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp, channel_kernels, epl_kernels
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
        res.update(bank_bound(prepared), **device_time(
            f"bank_rows K={NUM_K} N={n}", lambda: epl_kernels.launch_bank_rows(prepared), card))
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
        results[f"bank_comp_{z}"].update(
            bank_bound(prepared, "tf32x3" if z == "f32" else "bf16", comp=True),
            **device_time(f"bank_comp z={z}", lambda: bank_comp.launch_bank_comp(prepared), card))
    # The library yardstick: the contraction alone, [2K, U] x [U, 2AL], with Z
    # already built (the kernel builds it too), as one torch.matmul.
    num_u = N_1MS + prepared.span
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    z_planes = torch.randn((2 * NUM_K, num_u), generator=gen, device=DEVICE)
    s_planes = torch.randn((num_u, 2 * NUM_ANTS * 7), generator=gen, device=DEVICE)
    for z, (zp, sp) in (("f32", (z_planes, s_planes)),
                        ("bf16", (z_planes.bfloat16(), s_planes.bfloat16()))):
        med, mn = time_cuda(lambda: torch.matmul(zp, sp))
        results[f"bank_comp_{z}"].update(library_ms=med, library_min_ms=mn)
        log(f"[time] bank_comp library yardstick: torch.matmul [{2 * NUM_K}, {num_u}] x "
            f"[{num_u}, {2 * NUM_ANTS * 7}] {z} (TF32 off) median {med!r} ms (min {mn!r}) [{card}]")
    del case, prepared, z_planes, s_planes

    l5 = GPSL5()
    case = random_case(l5, N_1MS, 2 * DUAL_K, seed + 300)
    case["code_tiles"] = epl_kernels.prepare_bank_code_tiles_rows(case["codes"], case["prn"])
    prepared = epl_kernels.BankRowsCall(**case, route="pallas_bank")
    results["bank_transition"] = kernel_vs_plain(
        f"bank_transition (pallas_bank) GPS L5 K={2 * DUAL_K} N={N_1MS}",
        lambda: epl_kernels.launch_bank_rows(prepared),
        lambda: epl_kernels.correlate_bank_rows_reference(**case, route="pallas_bank"),
        card, samples=2 * DUAL_K * N_1MS)
    results["bank_transition"].update(bank_bound(prepared), **device_time(
        "bank_transition", lambda: epl_kernels.launch_bank_rows(prepared), card))
    del case, prepared

    # The per-channel kernels alone at the sweep's corners, and the one-hot
    # route at K=1024. The plain versions of taps and fused take no host copy,
    # so their device time is read from a CUDA graph too.
    for n in (N_1MS, N_WIDE):
        for a, taps in ((1, 3), (NUM_ANTS, 7)):
            args = channel_args("GPSL1", n, a, taps, 0, 1500.0, 0.3, 17.5)
            for kind in ("taps", "fused"):
                call = channel_kernels.ChannelCall(*args, kind)
                launch = getattr(channel_kernels, f"launch_{kind}")
                plain = getattr(channel_kernels, f"correlate_{kind}_reference")
                wrapper = getattr(channel_kernels, f"correlate_pallas_{kind}")
                res = kernel_vs_plain(f"{kind} N={n} A={a} L={taps}", lambda: launch(call),
                                      lambda: plain(*args), card, samples=n, graphs=True)
                # The inputs the kernel reads: the signal, the tap matrix or
                # the PRN's code column, and the channel parameters.
                replica = call.replica if kind == "taps" else call.column
                res.update(bound((6 + 4 * taps) * a * n, "f32", call.sre, call.sim, replica,
                                 call.params, out_elems=2 * a * taps))
                w = time_cuda(lambda: wrapper(*args))
                ops = device_ops_per_call(lambda: wrapper(*args))
                res.update(wrapper_ms=w[0], wrapper_min_ms=w[1], device_ops_per_call=ops)
                log(f"[time] {kind} N={n} A={a} L={taps}: wrapper call incl. per-call "
                    f"set-up median {w[0]!r} ms (min {w[1]!r}); {ops!r} device ops per "
                    f"wrapper call (torch.profiler) [{card}]")
                results[f"{kind}_n{n}_a{a}_l{taps}"] = res
    del args, call

    case = random_case(system, N_1MS, NUM_K, seed + 400)
    del case["nominal_code_frequency"]
    case["code_tiles"] = epl_kernels.prepare_bank_code_tiles_rows(case["codes"], case["prn"])
    prepared = epl_kernels.BankRowsCall(**case, route="pallas_bank_onehot")
    results["bank_onehot"] = kernel_vs_plain(
        f"bank_onehot (pallas_bank_onehot) K={NUM_K} N={N_1MS}",
        lambda: epl_kernels.launch_bank_rows(prepared),
        lambda: epl_kernels.correlate_bank_rows_reference(**case, route="pallas_bank_onehot"),
        card, samples=NUM_K * N_1MS)
    results["bank_onehot"].update(bank_bound(prepared), **device_time(
        "bank_onehot", lambda: epl_kernels.launch_bank_rows(prepared), card))
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
            "bank_transition": transition_cells(args.seed),
            "bank_onehot": onehot_cells(system, args.seed),
            **channel_cells()}
    log(f"[phase] kernel cells in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    rows_launches, sre, sim = main_path(system, args.seed)
    launches = {"bank_rows": rows_launches}
    launches["bank_comp"] = array_path(system, args.seed)
    launches["bank_transition"], sre_l5, sim_l5, l5_offsets = dual_path(args.seed)
    log(f"[phase] main paths A, B and rows in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    sweep_dir = (pathlib.Path(args.out).parent if args.out else pathlib.Path("build")) / \
        "kernel_sweep"
    sweep_counts, sweep_small, sweep = sweep_path(sweep_dir)
    launches.update(taps=sweep_counts["taps"], fused=sweep_counts["fused"])
    log(f"[phase] main path C, the kernel sweep, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    launches["bank_onehot"], benches = channel_loops(system, args.seed, sre, sim)
    log(f"[phase] main path D, per-channel and one-hot loops, in "
        f"{time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    times = timings(system, args.seed, sre, sim, sre_l5, sim_l5, l5_offsets, card)
    times.update(benches)
    log(f"[phase] timings in {time.perf_counter() - t0!r} s")

    # `ms` is each kernel's device time from a replayed CUDA graph: an eager
    # launch also carries the wrapper's host work, which on a busy host can
    # rival a bank kernel's time (`eager_ms` keeps the eager reading). The
    # plain bank versions copy host values to the card and cannot be
    # captured, so their `plain_ms` is eager; the per-channel ones are
    # captured too.
    eager = ("plain_ms", "ms: device time, CUDA graph replay; plain_ms: CUDA events, eager calls")
    graph = ("plain_graph_ms", "ms and plain_ms: device time, CUDA graph replay")
    top = f"n{N_WIDE}_a{NUM_ANTS}_l7"
    entries = [
        ("bank_rows", "gpuacceleratedtracking_tpu_torch/csrc/bank_rows.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:1448", times[f"bank_rows_n{N_1MS}"],
         eager),
        ("bank_comp", "gpuacceleratedtracking_tpu_torch/csrc/bank_comp.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:1886", times["bank_comp_f32"], eager),
        ("bank_transition", "gpuacceleratedtracking_tpu_torch/csrc/bank_rows.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:602", times["bank_transition"], eager),
        ("bank_onehot", "gpuacceleratedtracking_tpu_torch/csrc/bank_rows.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:410", times["bank_onehot"], eager),
        ("taps", "gpuacceleratedtracking_tpu_torch/csrc/taps.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:90", times[f"taps_{top}"], graph),
        ("fused", "gpuacceleratedtracking_tpu_torch/csrc/fused.cu",
         "gpuacceleratedtracking_tpu/ops/pallas_epl.py:238", times[f"fused_{top}"], graph),
    ]
    # Closed-loop blocks of each bank kernel's main path (rows: 20, A: 20,
    # B: 60 sync + 200 tracking, D's one-hot bank: 20); the per-channel
    # kernels' main path is the sweep, one launch per correlator call.
    per_block = {"bank_rows": (20, "block"), "bank_comp": (20, "block"),
                 "bank_transition": (260, "block"), "bank_onehot": (sre.shape[0], "block"),
                 "taps": (None, "call"), "fused": (None, "call")}
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": errs[name],
        "ms": t["kernel_graph_ms"], "eager_ms": t["kernel_ms"], "plain_ms": t[plain_key],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_unit": t["bound_unit"],
        "launches_per_block": (launches[name] / per_block[name][0] if per_block[name][0]
                               else 1.0),
        "per": per_block[name][1], "library_ms": t.get("library_ms"), "clock": clock,
    } for name, source, replaces, t, (plain_key, clock) in entries]}
    # taps and fused at both sweep corners: the launch-weighted one and the top.
    corner_keys = {"ms": "kernel_graph_ms", "eager_ms": "kernel_ms", "plain_ms": "plain_graph_ms",
                   "bound_ms": "bound_ms", "bound_by": "bound_by", "wrapper_ms": "wrapper_ms",
                   "device_ops_per_call": "device_ops_per_call"}
    for entry in kernels["kernels"][4:]:
        name = entry["name"]
        entry["launches_n_le_32768"] = sweep_small[name]
        entry["corners"] = {
            corner: {key: times[f"{name}_{corner}"][src] for key, src in corner_keys.items()}
            for corner in (f"n{N_1MS}_a1_l3", top)}
    comp_bf16 = times["bank_comp_bf16"]
    kernels["kernels"][1].update(ms_bf16=comp_bf16["kernel_graph_ms"],
                                 eager_ms_bf16=comp_bf16["kernel_ms"],
                                 plain_ms_bf16=comp_bf16["plain_ms"],
                                 bound_ms_bf16=comp_bf16["bound_ms"],
                                 library_ms_bf16=comp_bf16["library_ms"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": card, "build_s": build_s,
                       "kernels": kernels["kernels"], "times": times,
                       "sweep": sweep}, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
