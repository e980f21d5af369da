#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py [--out results.json] [--seed N]``

Drives the port's main path once on the card and exits nonzero on any failure:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles ``gpuacceleratedtracking_tpu_torch/csrc`` with nvcc.
3. Kernel vs its plain version on the card, GPS L1, random Doppler, phases
   and code rates from a numpy seed: the golden prompt (K=3), K=64, A=2,
   a wide tap span at N=2^18 through ``pallas_bank_auto``, and K=1024.
4. Main path: ``track_bank`` on a K=1024 GPS L1 bank at 32.768 MHz through
   ``pallas_bank_auto``, fed 20 blocks of a noiseless 8-satellite signal:
   one kernel launch per block, agreement with the plain ``xla_bank`` run,
   no NaN; then 600 blocks with noise (50 dB-Hz) from a 20 Hz / 0.2 chip
   start, and the 8 matched channels must hold lock.
5. Times (CUDA events, after warm-up): kernel vs plain version per bank block
   at K=1024, N=32768 and N=2^18, and the closed-loop block at K=1024.

Its last lines are one JSON object describing the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
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
SAT_DOPPLERS = np.array([-3500.0, -2200.0, -1100.0, -300.0, 450.0, 1300.0, 2600.0, 3750.0])
SAT_CODE_PHASES = np.array([0.0, 97.3, 211.6, 345.2, 480.9, 612.4, 777.7, 901.1])
# Per-component noise sigma: C/N0 = 1 / (2 sigma^2 / fs) = 50 dB-Hz at 32.768 MHz.
NOISE_STD = math.sqrt(L1_FS / 1e5 / 2)
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


def random_case(system, n, k, seed, num_ants=1):
    """Bank inputs as in tests/test_pallas.py: PRN 0 at 1500 Hz, random channels."""
    from gpuacceleratedtracking_tpu_torch.models import (
        EPLCorrelator, correlator_sample_shifts, gen_signal, soa)

    rng = np.random.default_rng(seed)
    fs = n / 1e-3
    signal, _ = gen_signal(system, 0, 1500.0, n,
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
            system, EPLCorrelator(3), fs)),
        code_length=system.code_length,
        nominal_code_frequency=system.code_frequency,
    )


def kernel_cells(system, seed):
    """Phase 3: each cell through the kernel and its plain version on the card."""
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
            z = torch.zeros(k, device=DEVICE)
            case.update(carrier_frequency=z + 1500.0, carrier_phase=z,
                        code_frequency=z + system.code_frequency, code_phase=z,
                        prn=torch.zeros(k, dtype=torch.int32, device=DEVICE))
        if route == "pallas_bank_auto":
            check(epl_kernels.bank_algorithm_for(
                n, case["sampling_frequency"], system.code_length,
                system.code_frequency) == "pallas_bank_rows", f"{name} routes to rows")
            check(max(case["sample_shifts"]) - min(case["sample_shifts"]) >= 128,
                  f"{name} has a wide tap span")
            fn = epl_kernels.correlate_pallas_bank_auto
        else:
            fn = epl_kernels.correlate_pallas_bank_rows
        got = fn(**case)
        torch.cuda.synchronize()
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
        log(f"[kernel] {name}: N={n} K={k} A={a} via {route}: max|kernel-plain|="
            f"{err!r} (atol {atol}, rtol 2e-3) ok")
    return worst


def bank_states(system, init_errors: bool):
    from gpuacceleratedtracking_tpu_torch.tracking import init_state

    dops = np.linspace(-4000.0, 4000.0, NUM_K)
    phases = np.zeros(NUM_K)
    nsat = len(SAT_DOPPLERS)
    dops[:nsat] = SAT_DOPPLERS + (20.0 if init_errors else 0.0)
    phases[:nsat] = (SAT_CODE_PHASES - (0.2 if init_errors else 0.0)) % system.code_length
    return init_state(np.arange(NUM_K) % 32, carrier_doppler=dops,
                      code_phase=phases, device=DEVICE)


def mixed_blocks(system, num_blocks, noise_std=0.0, generator=None):
    """``[B, N]`` planes of the 8-satellite GPS L1 signal at 32.768 MHz."""
    from gpuacceleratedtracking_tpu_torch.models import gen_signal_mixed, soa

    signal, fs = gen_signal_mixed(
        system, np.arange(len(SAT_DOPPLERS)), SAT_DOPPLERS, N_1MS * num_blocks,
        duration=num_blocks * 1e-3, start_code_phases=SAT_CODE_PHASES,
        noise_std=noise_std, generator=generator, device=DEVICE)
    sre, sim = (x.reshape(num_blocks, N_1MS) for x in soa(signal))
    return sre, sim, fs


def main_path(system, seed, num_blocks_lock: int = 600):
    """Phase 4: the K=1024 closed loop through the kernel, vs the plain bank.

    The comparison with ``xla_bank`` runs on the noiseless mix, where a chip
    boundary that lands one sample apart moves an accumulator by a bounded
    amount; the lock run adds noise for C/N0 = 50 dB-Hz.
    """
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    sre, sim, fs = mixed_blocks(system, 20)
    codes = torch.as_tensor(system.codes, device=DEVICE)
    config = TrackConfig.for_system(system, fs, N_1MS, algorithm="pallas_bank_auto")
    plain = TrackConfig.for_system(system, fs, N_1MS, algorithm="xla_bank")
    states = bank_states(system, init_errors=True)

    # Counted run: 20 blocks through the entry point a user calls.
    epl_kernels.correlate_pallas_bank_rows.launches = 0
    _, out = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    launches = epl_kernels.correlate_pallas_bank_rows.launches
    check(launches == 20, f"20 kernel launches in 20 blocks, got {launches}")
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
        f"launches={launches}; vs xla_bank: block 0 all channels max|d prompt_re|="
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


def timings(system, seed, sre, sim, card):
    """Phase 5: kernel vs plain version, and the closed-loop block."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, loop_update, track_bank)

    results = {}
    launches_per_rep = 10
    for n in (N_1MS, N_WIDE):
        case = random_case(system, n, NUM_K, seed + 100 + n)
        case["code_tiles"] = epl_kernels.prepare_bank_code_tiles_rows(
            case["codes"], case["prn"])
        prepared = epl_kernels.BankRowsCall(**case)

        def kern():  # the kernel alone, back to back on a prepared call
            for _ in range(launches_per_rep):
                epl_kernels.launch_bank_rows(prepared)

        wrap = lambda: epl_kernels.correlate_pallas_bank_rows(**case)  # noqa: E731
        ref = lambda: epl_kernels.correlate_bank_rows_reference(**case)  # noqa: E731
        # In turns: plain, kernel, kernel, plain.
        p1 = time_cuda(ref)
        k1 = time_cuda(kern)
        w = time_cuda(wrap)
        k2 = time_cuda(kern)
        p2 = time_cuda(ref)
        k_med = statistics.median([k1[0], k2[0]]) / launches_per_rep
        k_min = min(k1[1], k2[1]) / launches_per_rep
        p_med, p_min = statistics.median([p1[0], p2[0]]), min(p1[1], p2[1])
        msps = NUM_K * n / (k_med * 1e-3) / 1e6
        results[n] = dict(kernel_ms=k_med, kernel_min_ms=k_min,
                          wrapper_ms=w[0], wrapper_min_ms=w[1],
                          plain_ms=p_med, plain_min_ms=p_min, msamples_per_s=msps)
        log(f"[time] bank K={NUM_K} N={n}: kernel median {k_med!r} ms (min {k_min!r}); "
            f"wrapper call incl. per-call set-up median {w[0]!r} ms (min {w[1]!r}); "
            f"plain median {p_med!r} ms (min {p_min!r}); kernel {msps!r} Msamples/s "
            f"[{card}]")

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
    for algo in ("pallas_bank_auto", "xla_bank"):
        config = TrackConfig.for_system(system, fs, N_1MS, algorithm=algo)
        states = bank_states(system, init_errors=False)
        run = lambda: track_bank(config, codes, states, sre[:blocks], sim[:blocks])  # noqa: E731
        med, mn = time_cuda(run, reps=TIMING_REPS, warmup=2)
        med, mn = med / blocks, mn / blocks
        results[f"closed_loop_{algo}"] = dict(block_ms=med, block_min_ms=mn,
                                              realtime_channels=NUM_K * 1.0 / med)
        log(f"[time] closed-loop block K={NUM_K} N={N_1MS} via {algo}: median {med!r} ms "
            f"(min {mn!r}); real-time channels at 1 ms blocks: {NUM_K / med!r} "
            f"[{card}]")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    # Phase 1: device.
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain bank's einsum in full f32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    from gpuacceleratedtracking_tpu_torch.models import GPSL1
    from gpuacceleratedtracking_tpu_torch.ops import _build

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"[build] {lib_path.name} in {build_s!r} s")
    ptxas = lib_path.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    system = GPSL1()
    worst = kernel_cells(system, args.seed)
    launches, sre, sim = main_path(system, args.seed)
    times = timings(system, args.seed, sre, sim, card)

    kernels = {"kernels": [{
        "name": "bank_rows",
        "route": "cuda",
        "source": "gpuacceleratedtracking_tpu_torch/csrc/bank_rows.cu",
        "replaces": "gpuacceleratedtracking_tpu/ops/pallas_epl.py:1448",
        "launches": launches,
        "max_abs_err": worst,
        "ms": times[N_1MS]["kernel_ms"],
        "plain_ms": times[N_1MS]["plain_ms"],
    }]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": card, "build_s": build_s,
                       "kernels": kernels["kernels"],
                       "times": {str(k): v for k, v in times.items()}}, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
