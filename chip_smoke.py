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
   3c. Every antenna and tap count (``[AL]`` lines): the kernels are
   instantiated for A <= 4 and L in {3, 5, 7}, and the wrappers cover any
   other shape by launch groups (``epl_kernels.launch_groups``). Each route
   (rows, comp f32 and bf16, transition, one-hot, taps, fused) at A in
   {5, 6, 8} with L=3, A=1 with L in {4, 9, 11}, and A=8 with L=9, against
   its plain version at its in-envelope tolerance, one launch per group,
   with each cell's device time; GPS L1 at 32.768 MHz (K=64 for the banks),
   the transition route at GPS L5. Then one closed-loop ``track_bank``
   block at A=8 (K=1024) through ``pallas_bank_auto`` (the composite route,
   two launches) against ``xla_bank``.
   3d. The replica kernel (``csrc/replica.cu``, ``[replica]`` lines) against
   the plain replica ops, bit for bit: GPS L1 N=2^11..2^18 and GPS L5
   N=2^15..2^18, L in {3, 7} (a negative min_shift), exact and quantized,
   the haloed row and the ``[L, N]`` tap matrix, random PRN, code rate and
   code phase per cell.
   3b. The loop-closure kernel (``csrc/loop_update.cu``, one launch per
   ``tracking.loop_update`` call on CUDA tensors) against its plain version
   ``loop_update_plain`` over ``LOOP_CASES`` (filter orders 1/2/3, FLL
   assist on and off, Costas and atan2, coherent windows with and without an
   overlay, A = 2, 3, 4 unweighted, shared and per-channel weights, L = 7)
   at K=1024, K=8 and a scalar state, three blocks each side fed its own
   state back, fresh and under a sink (the outputs into rows of stacked
   buffers at a device-side index, the state written in place, the plain
   version doing the same by ``index_copy_``); the dual mode
   (``tracking.dual.dual_update``) against ``dual_update_plain`` over
   ``DUAL_CASES`` (K 8 and 64, no antenna axis and A = 1..4, both overlay
   tables, ``ms_elapsed`` across their periods), fresh and under a sink;
   every leaf bit for bit, ``cn0_dbhz`` included. Then ``track_bank``
   K=1024 GPS L1 over 200 blocks at 50 dB-Hz with the kernel (the replayed
   graph, writing its outputs and carry through the sink) against the same
   correlator closed by the plain version block by block: every output of
   every channel and the final state bit for bit.
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
     ``bench.run_kernel_benchmark`` on the ``params`` of the port's
     ``scripts.run_benchmarks_gpsl1`` (N = 2^11..2^18, M in {1, 4},
     L in {3, 7}, fused_xla / unfused_xla / pallas_fused / pallas_taps: 128
     configurations) and ``scripts.run_benchmarks_gpsl5`` (N = 2^15..2^18:
     64), at ``SWEEP_TRIALS`` trials, with ``reps="auto"`` and the default ``reps_mode``
     ``"unroll"`` (a timed call replays one CUDA graph of its r calls, so
     the figure is device time); every kernel call must have launched
     ``taps.cu`` (after ``replica.cu``, which builds its tap matrix) or
     ``fused.cu``. The blocks of N <= 32768 run first, then
     the larger ones, each part with the counts set to 0 before it and read
     after it (``launches_n_le_32768`` in the ``kernels`` line is the first
     part's count). One JSON file per configuration goes to
     ``kernel_sweep/`` beside ``--out`` (else under ``build/``). C2 (``[sweep
     modes]``): the two corners (N=32768 A=1 L=3, N=2^18 A=4 L=7) for the
     four algorithms in ``"unroll"``, ``"scan"`` and ``"calls"``, back to
     back, with the device memory each run reserved; at N=32768 the kernels'
     ``"unroll"`` medians must be below their ``"calls"`` medians. R: the
     port's ``run_replica_benchmark`` (N=32768, exact and quantized), one
     replica launch per rep, 32 reps per replayed graph;
   - D, closed loops on the new kernels: ``track`` on one GPS L1 satellite
     through ``pallas_fused`` (600 blocks at 50 dB-Hz from a 20 Hz / 0.2 chip
     start hold lock), ``track_bank`` with ``pallas_fused`` at K=8 against
     ``fused_xla``, ``track_bank`` with ``pallas_bank_onehot`` at K=1024 (one
     launch per block, against ``xla_bank``), and the port's
     ``run_track_benchmark`` (K=1024) and ``run_dual_track_benchmark`` (K=64).
   - E, the families: GLONASS L1OF, Galileo E1-C and BeiDou B1I through
     ``pallas_bank_auto`` against the plain version at N=32768 K=256 (the rows
     route) and at their low rates (E1 and B1I at 8.192 MHz, GLONASS at
     2.048 MHz with code phases 505..510.9 of its 511 chips, so the replica
     wraps the code twice: the transition route); then each family's K=256
     closed loop at 32.768 MHz with 8 planted satellites (overlays included):
     20 noiseless blocks against ``xla_bank``, 300 blocks at 50 dB-Hz that
     must lock, the block time and real-time channels, and
     ``run_track_benchmark`` at K in {64, 256};
   - F, acquisition: ``run_acquire_benchmark`` (GPS L1, 32 PRNs) at N =
     32768, 2^17 and 2^18, ms per call, and ``acquire`` on 4 planted
     satellites at each N (PRNs, Doppler bins and code phases found);
   - G, the cold start: the port's ``scripts.run_coldstart``, its L1, L5
     and B1I int8 captures (seeds and truth) written to a temporary directory, decoded by
     the native ``runtime.IQFile`` (the run fails without it), acquired over
     every PRN; L1 through ``StreamTracker`` with a checkpoint and a cold
     resume; L5 pilot pull-in, ``detect_secondary_offset``, then
     ``track_bank_dual``; B1I Costas pull-in,
     ``detect_secondary_offset_windowed``, then the NH20-wiped track. The
     script's checks: the accepted PRNs, Doppler errors under 10 Hz, the NH
     phases, and the nav symbols (L5, by the data prompt's sign) and bits
     (B1I, by differential decisions, which hold on a channel that is
     frequency but not phase locked); ``steady_block_s`` and the real-time
     factor of each leg;
   - H, streaming: a GPS L1 int8 capture at N=32768 through ``StreamTracker``
     into a K=256 bank, its ``steady_block_s`` beside the bare ``track_bank``
     block time of the same bank;
   - I, the dual bank on the per-channel kernels: ``track_bank_dual`` at K=4
     through ``pallas_fused`` and ``pallas_taps`` (2K launches per block)
     against ``xla_bank``, on noiseless GPS L5 blocks;
   - J, the distributed layer (``parallel``) on a mesh of every visible card
     in turn, or of ``cuda:0`` repeated on a one-card machine: J0 each kernel
     against its plain version at the shard-local shapes below; J1 the
     counterpart of the JAX dry run (``__graft_entry__.py:91-185``: the L1
     rows bank at N=8192 on (chan 2, time 2), whose shards must route to the
     rows kernel, against ``track_bank``, and the GPS L5 dual bank at
     N=16384 on the channel axis against ``track_bank_dual``); J2 the K=1024
     GPS L1 bank on ``main_path``'s 20 noiseless blocks on meshes 2 x 1, 1 x 2
     and 2 x 2 against ``track_bank`` (one rows launch per shard and block),
     100 blocks at 50 dB-Hz on 2 x 2 in which the 8 satellites hold lock, and
     each mesh's block time beside the unsharded block; J3 the K=1024 A=4
     L=7 bank through ``bank_comp`` on 2 x 2; J4 the K=64 L5 dual bank on
     chan 2; J5 ``correlate_sharded`` through ``pallas_taps`` and
     ``pallas_fused`` at N=2^18 A=4 L=7 over ant 4 x time 2 and N=2^17 over
     time 8, against the unsharded call; J6 the one-hot route at K=64 on
     2 x 2. Each kernel's launches here are ``parallel`` in
     ``launches_by_path``;
   - K, the figures: ``bench.plots.plot_kernel_benchmarks`` from C's
     ``kernel_sweep/`` records and ``plot_track_benchmark`` from the
     ``run_track_benchmark`` records of D and E (written to
     ``figures/track_records/``), each PNG over 10 KB, into ``figures/``
     beside ``kernel_sweep/``. Where matplotlib is not installed the frames
     are checked and the script says that no figure was drawn.
   - S, the sweep analogs (``[S]`` lines): each ``run_sweep`` call of the
     port's ``scripts.run_benchmarks_{gpsl1,gpsl5,track,acquire}`` and
     ``scripts.benchmark_{reduction,replica}`` on one cell of each of its
     dicts (the first value of each list), into a temporary directory: each
     record exists under its savename, has no error, ran on the card
     (``cpu_params`` on the CPU) and has the JAX record's keys.
   - L, the block loop as one captured program: the tracking entry points
     replay a CUDA graph of their block body on the card (every phase above
     runs so); here each path runs once under ``tracking.eager()`` and once
     through its graph, and every output and the final state must be equal
     bit for bit, with equal launch counts: rows K=1024 (``pallas_bank_auto``
     and ``xla_bank``), A=4 L=7 f32 and bf16 with steering weights, the L5
     dual K=64, Galileo E1-C at K=256, ``pallas_fused`` and ``pallas_taps``
     at K=8, ``track`` on one channel, the one-hot route, and
     ``track_bank_sharded`` 2 x 2 and ``track_bank_dual_sharded`` chan 2 on
     the phase J devices. A second call of each, a replay of the cached
     graph, runs under ``torch.cuda.set_sync_debug_mode("error")`` and must
     give the same outputs and launch counts (the loop kernels' included:
     one per block, ``dual_update`` on the dual paths);
     each call's counts are read after it. Device ops per block of every
     path, eager and graph (torch.profiler), beside the counts with the loop
     kernel writing fresh tensors and those
     with the loop closure as torch ops where PERF.md kept them; the device
     ops by name of rows K=1024, ``track`` and the L5 dual as graphs, which
     must hold no ``index_copy_`` (the loop kernel writes the outputs
     through the sink), against the sharded 2 x 2 bank's graph (no sink),
     which must. Each path's first graph call starts from an empty cache, and
     its entries' buffers and the device memory it reserved are logged.
     Then eager and graph block times and real-time channels of the timed
     paths (and streaming's ``steady_block_s`` both ways, from H, whose
     outputs must match too), the one-card sharded L5 dual bank at chan 2
     and 4 as a graph per shard (the library's path) against one graph for
     every shard (``dual_one_graph``), and the device's busy share
     (torch.profiler device time over wall time) for rows K=1024 and A=4 L=7.
5. Times (CUDA events, after warm-up; medians and minima): each kernel vs its
   plain version at main-path shapes (every kernel, and the per-channel
   kernels' plain versions, also as device time from a CUDA graph replay:
   ``ms`` in the ``kernels`` line, ``eager_ms`` beside it; for ``taps`` and
   ``fused`` at both sweep corners, N=32768 A=1 L=3 and N=2^18 A=4 L=7, with
   the wrapper call's time and its device ops per call from torch.profiler,
   under ``corners``), the loop kernel against its plain version at K=1024
   fresh and under a sink, and in dual mode at the L5 dual bank's K=64
   (all also as CUDA-graph device time), the closed-loop block of each
   path, and the library yardsticks, which the port never calls: for
   ``bank_comp`` one ``torch.matmul`` of a materialized ``[2K, U]`` Z
   against ``[U, 2AL]`` S (f32 with TF32 off, and bf16); for the other bank
   routes one complex64 ``torch.matmul`` of a built ``[K, N]``
   conj(carrier) x code plane against the ``[N, L]`` shifted signal planes
   (``bank_rows`` at N=32768 and N=2^18), and for the per-channel kernels of a built ``[L, N]`` wiped replica
   against the ``[N, A]`` signal (device time, CUDA graph); the replica
   kernel's tap matrix at both corners against the plain replica ops (no
   single PyTorch call computes it: ``library_ms`` null).
6. P, the profile (``[P]`` lines): the port's ``scripts.profile_trace`` at
   its defaults (``pallas_bank_auto``, K=1024, N=32768, 10 calls under
   torch.profiler), whose trace must give the ``bank_rows`` kernels within
   20 % of their CUDA-graph replay time from 5; then
   ``bench.profile.profile_calls`` on 10-block ``track_bank`` calls at the
   same shape through the graph path (``[P split]``): per-call wall time,
   device busy time and share, device ops by name and the longest idle gaps
   with the host events that fill them.

Its last lines are one JSON object describing the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Each kernel's entry
holds its launches on the paths run (``launches``, and per path in
``launches_by_path``, each path counted from 0 just before it), its launches
per block (or per call) on its first path, its largest
error against its plain version, its device time (``ms``; ``eager_ms`` with
the host's launch work) and its plain version's (``plain_ms``; ``clock``
says how each was read), ``library_ms`` (null where no single PyTorch call
computes the function: the loop kernel in both modes), and ``bound_ms``: the least time the
card could take for the same work, the larger of this run's input and output
bytes over 3.35 TB/s and the kernel's floating-point operations over the peak
of their type
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
    """Every correlator kernel's launch count, and the replica kernel's (one
    launch per ``pallas_taps`` call: its tap matrix), by kernel name."""
    from gpuacceleratedtracking_tpu_torch.ops import (
        bank_comp, channel_kernels, epl_kernels, replica_kernel)

    return {"bank_rows": epl_kernels.correlate_pallas_bank_rows,
            "bank_comp": bank_comp.correlate_pallas_bank_comp,
            "bank_transition": epl_kernels.correlate_pallas_bank,
            "bank_onehot": epl_kernels.correlate_pallas_bank_onehot,
            "taps": channel_kernels.correlate_pallas_taps,
            "fused": channel_kernels.correlate_pallas_fused,
            "replica": replica_kernel.code_replica}


def loop_counter():
    """The loop-closure kernel's wrapper, whose ``launches`` count its launches."""
    from gpuacceleratedtracking_tpu_torch.ops import loop_kernel

    return loop_kernel.loop_update_kernel


def dual_counter():
    """The wrapper of the loop kernel's dual mode (the GPS L5 dual block)."""
    from gpuacceleratedtracking_tpu_torch.ops import loop_kernel

    return loop_kernel.dual_update_kernel


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
    loop_counter().launches = 0
    dual_counter().launches = 0


def read_counts() -> dict:
    """The correlator kernels' launch counts (`loop_count` has the loop
    kernel's: every closed-loop path launches it once per block)."""
    return {name: fn.launches for name, fn in counters().items()}


def loop_count() -> int:
    return loop_counter().launches


# The loop kernel's launches on each path, single and dual mode, read where
# the path reads its correlator counts (each counted from 0 just before the
# path's run).
LOOP_BY_PATH: dict = {}
DUAL_BY_PATH: dict = {}


def note_loop(path: str, expected: int | None = None, dual: bool = False) -> int:
    """Record the loop kernel's launches since the last `reset_counts` as
    ``path``'s (``dual``: its dual mode's), and check that it ran
    (``expected`` times, if given)."""
    count = (dual_counter() if dual else loop_counter()).launches
    name = "dual_update" if dual else "loop_update"
    check(count > 0 and (expected is None or count == expected),
          f"{path}: {name} launched {count} times, expected "
          f"{expected if expected is not None else 'at least once'}")
    by_path = DUAL_BY_PATH if dual else LOOP_BY_PATH
    by_path[path] = by_path.get(path, 0) + count
    return count


def only(**launches) -> dict:
    """The counts expected when just the named kernels ran."""
    return {name: launches.get(name, 0) for name in counters()}


def json_record(result: dict) -> dict:
    """A benchmark result with every value as JSON gives it back (numpy
    scalars as Python numbers), as `run_sweep` writes its records."""
    return json.loads(json.dumps(result, default=float))


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
        prn=t(np.arange(k) % min(32, system.num_prns), torch.int32),
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


def check_tap_rows(call, tag):
    """Each tap group's tap matrix that the replica kernel wrote for a
    launched taps call, against the plain replica ops' rows, bit for bit."""
    from gpuacceleratedtracking_tpu_torch.ops import channel_kernels

    torch.cuda.synchronize()
    check(bool(call.tap_tables), f"{tag}: the replica kernel wrote the tap matrix")
    for taps, rows in call.tap_tables.items():
        check(torch.equal(rows, channel_kernels._tap_rows_plain(call, taps)),
              f"{tag}: the replica kernel's rows of taps {taps} bit for bit")


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
            if kind == "taps":
                call = channel_kernels.ChannelCall(*args, "taps")
                channel_kernels.launch_taps(call)
                check_tap_rows(call, f"taps {name}")
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


# Phase 3c, outside the correlator kernels' instantiations (A <= 4, L in
# {3, 5, 7}): each route at A in {5, 6, 8} with L=3, A=1 with L in {4, 9, 11},
# and A=8 with L=9, through the launch groups of `epl_kernels.launch_groups`.
# name -> (A, taps or explicit shifts)
AL_SHAPES = {"a5_l3": (5, 3), "a6_l3": (6, 3), "a8_l3": (8, 3), "a1_l4": (1, (-16, 0, 16, 32)),
             "a1_l9": (1, 9), "a1_l11": (1, 11), "a8_l9": (8, 9)}
AL_ROUTES = ("bank_rows", "bank_comp", "bank_comp_bf16", "bank_transition", "bank_onehot",
             "taps", "fused")
AL_K = 64


def al_cells(seed, card):
    """Phase 3c: every correlator route at the `AL_SHAPES` against its plain
    version, at the tolerance of its in-envelope cells (phase 3): GPS L1 at
    32.768 MHz N=32768 (K=64 for the banks; one channel for taps and fused),
    the transition route at GPS L5 32.768 MHz (span 20 samples at L=11, under
    its 128). Each call must launch one kernel per launch group (a taps call
    also one replica launch per tap group); each cell's device time (CUDA graph replay of
    the prepared call's launches and the gather) is kept. Then one closed-loop
    `track_bank` block at A=8 (K=1024, the 8-satellite signal) through
    ``pallas_bank_auto``, which resolves it to the composite route (two
    launches), against the plain ``xla_bank``."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp, channel_kernels, epl_kernels
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    l1, l5 = GPSL1(), GPSL5()
    kinds = {"bank_rows": "pallas_bank_rows", "bank_transition": "pallas_bank",
             "bank_onehot": "pallas_bank_onehot"}
    worst, times = {}, {}
    for r_i, route in enumerate(AL_ROUTES):
        kernel = "bank_comp" if route.startswith("bank_comp") else route
        for s_i, (shape, (a, taps)) in enumerate(AL_SHAPES.items()):
            shifts = taps if isinstance(taps, tuple) else None
            num_taps = len(shifts) if shifts else taps
            groups = len(epl_kernels.launch_groups(a, num_taps))
            # taps: one replica launch per tap group, shared by its antenna groups.
            tap_groups = len(epl_kernels.launch_groups(1, num_taps))
            want_counts = {kernel: groups, "replica": tap_groups if route == "taps" else 0}
            tag = f"{route} {shape}"
            if route in ("taps", "fused"):
                args = channel_args("GPSL1", N_1MS, a, shifts or taps, 7, -1200.0, 1.1, 311.7)
                fn = getattr(channel_kernels, f"correlate_pallas_{route}")
                plain = getattr(channel_kernels, f"correlate_{route}_reference")
                reset_counts()
                got = fn(*args)
                torch.cuda.synchronize()
                counts = read_counts()
                want = plain(*args)
                tol, rtol = 1e-6 * N_1MS + 1e-3, 0.0
                call = channel_kernels.ChannelCall(*args, route)
                launch = getattr(channel_kernels, f"launch_{route}")
                timed = lambda: launch(call)  # noqa: E731
                lead = ()
            else:
                system = l5 if route == "bank_transition" else l1
                case = random_case(system, N_1MS, AL_K, seed + 1300 + 10 * r_i + s_i,
                                   num_ants=a, taps=3 if shifts else taps)
                if shifts:
                    case["sample_shifts"] = shifts
                reset_counts()
                if kernel == "bank_comp":
                    z = "bf16" if route.endswith("bf16") else "f32"
                    got = bank_comp.correlate_pallas_bank_comp(**case, z_dtype=z)
                    torch.cuda.synchronize()
                    counts = read_counts()
                    want = bank_comp.correlate_bank_comp_reference(**case, z_dtype=z)
                    tol, rtol = 3e-5 * float(want[0].abs().max()) + 1e-3, 0.0
                    prepared = bank_comp.BankCompCall(**case, z_dtype=z)
                    timed = lambda: bank_comp.launch_bank_comp(prepared)  # noqa: E731
                else:
                    if route == "bank_onehot":
                        del case["nominal_code_frequency"]
                    got = getattr(epl_kernels, "correlate_" + kinds[route])(**case)
                    torch.cuda.synchronize()
                    counts = read_counts()
                    want = epl_kernels.correlate_bank_rows_reference(**case, route=kinds[route])
                    tol, rtol = 4.5, 2e-3
                    prepared = epl_kernels.BankRowsCall(**case, route=kinds[route])
                    timed = lambda: epl_kernels.launch_bank_rows(prepared)  # noqa: E731
                lead = (AL_K,)
            check(counts == only(**want_counts),
                  f"[AL] {tag}: one launch per group ({groups}), got {counts}")
            shape_want = lead + ((a,) if a > 1 else ()) + (num_taps,)
            err = 0.0
            for g, w in zip(got, want):
                check(tuple(g.shape) == tuple(w.shape) == shape_want, f"[AL] {tag} shape")
                check(bool(torch.isfinite(g).all()), f"[AL] {tag} finite")
                err = max(err, within(f"[AL] {tag}", g, w, tol, rtol))
            worst[kernel] = max(worst.get(kernel, 0.0), err)
            med, mn = graph_ms(timed)
            if route == "taps":
                check_tap_rows(call, f"[AL] {tag}")
            times.setdefault(route, {})[shape] = {"ms": med, "min_ms": mn, "launches": groups,
                                                  "max_abs_err": err}
            log(f"[AL] {tag}: N={N_1MS} A={a} L={num_taps} in {groups} launch(es): "
                f"max|kernel-plain|={err!r} (atol {tol!r}, rtol {rtol}); device time (CUDA "
                f"graph) median {med!r} ms (min {mn!r}) [{card}] ok")

    # One closed-loop block at A=8 through the auto route.
    num_ants = 8
    sre, sim, fs = mixed_blocks(l1, 1, num_ants=num_ants)
    codes = torch.as_tensor(l1.codes, device=DEVICE)
    config = TrackConfig.for_system(l1, fs, N_1MS, algorithm="pallas_bank_auto")
    check(epl_kernels.bank_algorithm_for(N_1MS, fs, l1.code_length, l1.code_frequency,
                                         num_ants=num_ants) == "pallas_bank_comp",
          "A=8 routes to pallas_bank_comp")
    states = bank_states(l1, init_errors=True)
    reset_counts()
    _, out = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(bank_comp=2), f"[AL] track_bank A=8: two comp launches, got {counts}")
    note_loop("AL", 1)
    _, ref = track_bank(dataclasses.replace(config, algorithm="xla_bank"), codes, states,
                        sre, sim)
    torch.cuda.synchronize()
    check(out.accum_re.shape == (1, NUM_K, num_ants, 3), "[AL] track_bank A=8 accum shape")
    for field, x in out._asdict().items():
        check(bool(torch.isfinite(x.float()).all()), f"[AL] track_bank A=8 {field} finite")
    diff = (out.prompt_re - ref.prompt_re).abs()
    check(bool((diff <= 40.0 + 5e-3 * ref.prompt_re.abs()).all()),
          f"[AL] track_bank A=8 prompt_re vs xla_bank within rtol=5e-3 atol=40 "
          f"({float(diff.max())!r})")
    log(f"[AL] track_bank K={NUM_K} A={num_ants} L=3 N={N_1MS}, one block via "
        f"pallas_bank_auto (bank_comp, 2 launches): vs xla_bank max|d prompt_re| "
        f"{float(diff.max())!r} ok")
    return worst, times, counts["bank_comp"]


def replica_cells(seed):
    """Phase 3d: ``csrc/replica.cu`` against the plain replica ops, bit for
    bit: GPS L1 at N = 2^11..2^18 and GPS L5 at 2^15..2^18 (fs = N / 1 ms),
    L in {3, 7} (EPL shifts, a negative min_shift), exact and quantized, the
    haloed row (`code_replica`) and the tap matrix (`code_tap_matrix`), a
    random PRN, code rate (+/-3 Hz) and code phase per cell, as device
    tensors. Returns the largest |kernel - plain| (0.0 when every chip
    matches) and the cells' count."""
    from gpuacceleratedtracking_tpu_torch.models import (
        EPLCorrelator, correlator_sample_shifts, get_system)
    from gpuacceleratedtracking_tpu_torch.ops import replica_kernel

    rng = np.random.default_rng(seed + 1500)
    worst, cells = 0.0, 0
    for gnss, exps in (("GPSL1", range(11, 19)), ("GPSL5", range(15, 19))):
        system = get_system(gnss)
        codes = torch.as_tensor(system.codes, device=DEVICE)
        for n in (1 << e for e in exps):
            fs = n / 1e-3
            for taps in (3, 7):
                shifts = tuple(int(s) for s in correlator_sample_shifts(
                    system, EPLCorrelator(taps), fs))
                prn = torch.tensor(int(rng.integers(0, 32)), dtype=torch.int64, device=DEVICE)
                fcode = torch.tensor(system.code_frequency + rng.uniform(-3.0, 3.0),
                                     dtype=torch.float32, device=DEVICE)
                phase = torch.tensor(rng.uniform(0.0, system.code_length),
                                     dtype=torch.float32, device=DEVICE)
                common = (codes, prn, fcode, fs, phase, n)
                for mode in replica_kernel.MODES:
                    before = replica_kernel.code_replica.launches
                    row = replica_kernel.code_replica(*common, min(shifts), max(shifts),
                                                      system.code_length, mode)
                    mat = replica_kernel.code_tap_matrix(*common, shifts, system.code_length,
                                                         mode)
                    torch.cuda.synchronize()
                    check(replica_kernel.code_replica.launches == before + 2,
                          f"[replica] {gnss} N={n} L={taps} {mode}: one launch per layout")
                    want_row = replica_kernel.replica_plain(*common, min(shifts), max(shifts),
                                                            system.code_length, mode)
                    want_mat = replica_kernel.tap_matrix_plain(*common, shifts,
                                                               system.code_length, mode)
                    for layout, g, w in (("row", row, want_row), ("taps", mat, want_mat)):
                        check(g.shape == w.shape and g.dtype == w.dtype,
                              f"[replica] {gnss} N={n} L={taps} {mode} {layout} shape")
                        bad = int((g != w).sum())
                        worst = max(worst, float((g - w).abs().max()))
                        check(bad == 0, f"[replica] {gnss} N={n} L={taps} {mode} {layout}: "
                                        f"{bad} chips differ from the plain version")
                    cells += 2
            log(f"[replica] {gnss} N={n}, L in (3, 7), exact and quantized, row and tap "
                f"matrix: bit for bit ok")
    log(f"[replica] {cells} cells bit for bit against the plain replica ops")
    return worst, cells


def replica_path(card):
    """Path R: the port's ``run_replica_benchmark`` (GPS L1, N=32768,
    ``reps="auto"``), exact and quantized, on the card: every rep one launch
    of ``csrc/replica.cu``, 32 reps per replayed graph."""
    from gpuacceleratedtracking_tpu_torch.bench import run_replica_benchmark

    results, launches = {}, 0
    for algo in ("exact", "quantized"):
        reset_counts()
        r = run_replica_benchmark({"GNSS": "GPSL1", "num_samples": N_1MS, "algorithm": algo,
                                   "processor": "GPU", "reps": "auto",
                                   "trials": SWEEP_TRIALS})
        counts = read_counts()
        reps = 256                                 # JAX's "auto" at N=32768
        check(counts == only(replica=3 * reps * (SWEEP_TRIALS + 1)),
              f"[R] run_replica_benchmark {algo}: one replica launch per rep, got {counts}")
        check(r["reps_mode"] == "scan" and math.isfinite(r["Median"]),
              f"[R] run_replica_benchmark {algo} record")
        launches += counts["replica"]
        results[algo] = {"Median": r["Median"], "Minimum": r["Minimum"],
                         "record": json_record(r)}
        log(f"[R] run_replica_benchmark GPS L1 N={N_1MS} {algo}: median "
            f"{r['Median'] * 1e3!r} ms per replica (min {r['Minimum'] * 1e3!r}), "
            f"{reps} reps in graphs of 32 [{card}]")
    return launches, results


# Phase 3b, the loop-closure kernel (csrc/loop_update.cu) against its plain
# version, over the grid of tests/test_torch_loop_kernel.py: name ->
# (TrackConfig overrides, antennas (None: no antenna axis), steering weights
# (None, "channel" [K, A] or "shared" [A]), taps, ms_elapsed (None: random)).
LOOP_CASES = {
    "default": ({}, None, None, 3, None),
    "atan2_order2": ({"pll_discriminator": "atan2", "pll_order": 2}, None, None, 3, None),
    "coherent_secondary": (
        {"coherent_blocks": 10,
         "secondary_code": (1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, -1.0, 1.0, 1.0)},
        None, None, 3, 9),
    "coherent4_random_ms": ({"coherent_blocks": 4}, None, None, 3, None),
    "two_antennas_weighted": ({}, 2, "channel", 3, None),
    "dll_order1": ({"dll_order": 1}, None, None, 3, None),
    "dll_order3": ({"dll_order": 3}, None, None, 3, None),
    "pll_order1": ({"pll_order": 1}, None, None, 3, None),
    "order2_fll": ({"pll_order": 2}, None, None, 3, None),
    "fll_off": ({"fll_bandwidth": 0.0}, None, None, 3, None),
    "four_antennas": ({}, 4, None, 3, None),
    "shared_weights": ({}, 3, "shared", 3, None),
    "seven_taps": ({}, None, None, 7, None),
}
# The dual mode's grid (tests/test_torch_loop_kernel.py's, with A=1): name
# -> (K dual channels, antennas (None: no antenna axis)).
DUAL_CASES = {f"k{k}_{'a' + str(a) if a else 'single'}": (k, a)
              for k in (8, DUAL_K) for a in (None, 1, 2, 3, 4)}


def loop_inputs(name, k, seed):
    """A case of `LOOP_CASES` on the card: its config (GPS L1 at 32.768 MHz),
    a random state with ``k`` channels (None: a scalar single-channel
    state), three blocks of accumulators and the weights."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL1
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, init_state

    extra, ants, weights, taps, ms_elapsed = LOOP_CASES[name]
    config = TrackConfig.for_system(GPSL1(), L1_FS, N_1MS, num_correlators=taps, **extra)
    rng = np.random.default_rng(seed)
    batch = () if k is None else (k,)
    n = 1 if k is None else k

    def f(*shape, scale=1.0):
        x = np.asarray(rng.normal(size=batch + shape) * scale, dtype=np.float32)
        return torch.from_numpy(x).to(DEVICE)

    def ints(low, high):
        x = rng.integers(low, high, n).astype(np.int32).reshape(batch)
        return torch.from_numpy(x).to(DEVICE)

    prn = np.arange(n) % 32
    dop = rng.uniform(-4000, 4000, n)
    state = init_state(prn if k else int(prn[0]), carrier_doppler=dop if k else float(dop[0]),
                       num_taps=taps, device=DEVICE)
    state = state._replace(
        carrier_phase=torch.from_numpy(
            rng.uniform(0, 2 * np.pi, n).astype(np.float32).reshape(batch)).to(DEVICE),
        code_doppler=f(scale=2.0),
        code_phase=torch.from_numpy(
            rng.uniform(0, 1023, n).astype(np.float32).reshape(batch)).to(DEVICE),
        pll_filter=state.pll_filter._replace(x2=f(scale=5.0)),
        dll_filter=state.dll_filter._replace(x1=f(scale=0.5)),
        cn0=state.cn0._replace(prompts_re=f(20, scale=1000.0), prompts_im=f(20, scale=100.0),
                               index=ints(0, 40)),
        ms_elapsed=(ints(0, 40) if ms_elapsed is None
                    else torch.full(batch, ms_elapsed, dtype=torch.int32, device=DEVICE)),
        prev_prompt_re=f(scale=1000.0), prev_prompt_im=f(scale=300.0),
        coh_re=f(taps, scale=1000.0), coh_im=f(taps, scale=300.0))
    acc = (taps,) if ants is None else (ants, taps)
    are, aim = f(*acc, scale=2000.0), f(*acc, scale=600.0)
    blocks = [(are * (1 + 0.1 * b), aim * (1 - 0.1 * b)) for b in range(3)]
    w = None
    if weights == "channel":
        w = (f(ants), f(ants))
    elif weights == "shared":
        w = tuple(torch.from_numpy(rng.normal(size=ants).astype(np.float32)).to(DEVICE)
                  for _ in range(2))
    return config, state, blocks, w


def loop_fields(state, out) -> dict:
    """Every leaf of a `loop_update` result by name (the state's prefixed;
    ``out`` None: the state's only)."""
    fields = {}
    for name, x in state._asdict().items():
        if isinstance(x, tuple):
            fields.update({f"{name}.{sub}": y for sub, y in x._asdict().items()})
        else:
            fields[name] = x
    if out is not None:
        fields.update(out._asdict())
    return fields


def clone_tree(tree):
    """A copy of a state, leaf by leaf, in its NamedTuple structure."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(clone_tree(x) for x in tree))


def make_sink(out, chunk=4):
    """A `graphs.Sink` for ``out``'s leaves: ``[chunk, ...]`` buffers of a
    sentinel value and a row index on the card."""
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    outs = tuple(torch.full((chunk,) + tuple(x.shape), -12345.0, dtype=x.dtype, device=DEVICE)
                 for x in flat(out))
    return graphs.Sink(outs, torch.zeros((), dtype=torch.int64, device=DEVICE))


def differ(got: dict, want: dict) -> dict:
    """The leaves of ``got`` that are not bit for bit ``want``'s, with their
    largest absolute difference."""
    diffs = {}
    for field, x in got.items():
        y = want[field]
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"{field}: {tuple(x.shape)} {x.dtype} against {tuple(y.shape)} {y.dtype}")
        if not torch.equal(x, y):
            diffs[field] = float((x.double() - y.double()).abs().max())
    return diffs


def sink_runs(update, plain, state, blocks, out):
    """``update`` and ``plain`` over ``blocks`` (block b into row b + 1),
    each under a sink of its own and writing a copy of ``state`` in place;
    the state each returns must be the one it took. Returns their leaves
    that differ: the final states' and every row of the sinks'."""
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    finals, sinks = [], []
    for fn in (update, plain):
        carry, sink = clone_tree(state), make_sink(out)
        for b, (are, aim) in enumerate(blocks):
            sink.index.fill_(b + 1)
            new, written = fn(carry, are, aim, sink)
            check(new is carry and all(x is graphs.WRITTEN for x in graphs._leaves(written)),
                  "a call under a sink returns the carry and WRITTEN outputs")
        finals.append(loop_fields(carry, None))
        sinks.append({f"row leaf {i}": buf for i, buf in enumerate(sink.outs)})
    return {**differ(finals[0], finals[1]), **differ(sinks[0], sinks[1])}


def loop_cells(seed):
    """Phase 3b: `loop_update` on CUDA tensors (one kernel launch per call)
    against `loop_update_plain` on the same inputs, every case of
    `LOOP_CASES` at K=1024, K=8 and a scalar state, three consecutive blocks,
    each side fed its own state back, fresh and under a sink (the plain
    version writing its sink by ``index_copy_``); then the dual mode
    (`tracking.dual.dual_update`, one launch per call) against
    `dual_update_plain` over `DUAL_CASES`, fresh and under a sink. Every
    leaf must be equal bit for bit. Returns the largest absolute difference
    over every leaf (0.0)."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5, gpsl5
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, init_state, loop_update)
    from gpuacceleratedtracking_tpu_torch.tracking.dual import dual_update, dual_update_plain
    from gpuacceleratedtracking_tpu_torch.tracking.track import loop_update_plain

    failures = []
    for i, name in enumerate(LOOP_CASES):
        for k in (NUM_K, 8, None):
            config, state, blocks, w = loop_inputs(name, k, seed + 70 + i)
            ks = ps = state
            diffs = {}
            for b, (are, aim) in enumerate(blocks):
                before = loop_count()
                ks, kout = loop_update(config, ks, are, aim, w)
                check(loop_count() == before + 1, f"[loop] {name}: one launch per call")
                ps, pout = loop_update_plain(config, ps, are, aim, w)
                diffs.update({f"block {b} {f}": e for f, e in
                              differ(loop_fields(ks, kout), loop_fields(ps, pout)).items()})
            before = loop_count()
            diffs.update({f"sink {f}": e for f, e in sink_runs(
                lambda st, are, aim, sk: loop_update(config, st, are, aim, w, sk),
                lambda st, are, aim, sk: loop_update_plain(config, st, are, aim, w, sk),
                state, blocks, kout).items()})
            check(loop_count() == before + len(blocks), f"[loop] {name}: one launch per sink call")
            if diffs:
                failures.append(f"{name} k={k}: {diffs}")
            log(f"[loop] {name} K={k if k else 'scalar'}: 3 blocks fresh and 3 under a sink "
                f"(state in place), kernel against plain "
                f"{'bit for bit on every leaf' if not diffs else f'differing leaves {diffs}'}")

    config = dual_config(TrackConfig.for_system(GPSL5(), L1_FS, N_1MS, use_secondary=False))
    tables = tuple(torch.tensor(gpsl5.neuman_hofman(pilot), dtype=torch.float32, device=DEVICE)
                   for pilot in (False, True))
    for i, (name, (k, ants)) in enumerate(DUAL_CASES.items()):
        rng = np.random.default_rng(seed + 170 + i)

        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(DEVICE)

        state = init_state(np.arange(k) % 32, carrier_doppler=rng.uniform(-4000, 4000, k),
                           ms_elapsed=rng.integers(0, 40, k), device=DEVICE)
        state = state._replace(
            code_doppler=f(k, scale=2.0), prev_prompt_re=f(k, scale=1000.0),
            prev_prompt_im=f(k, scale=300.0),
            cn0=state.cn0._replace(prompts_re=f(k, 20, scale=1000.0),
                                   prompts_im=f(k, 20, scale=100.0)))
        shape = (2 * k, 3) if ants is None else (2 * k, ants, 3)
        blocks = [(f(*shape, scale=2000.0), f(*shape, scale=600.0)) for _ in range(3)]
        ks = ps = state
        diffs = {}
        for b, (are, aim) in enumerate(blocks):
            before = dual_counter().launches
            ks, kout = dual_update(config, ks, are, aim, *tables)
            check(dual_counter().launches == before + 1, f"[dual] {name}: one launch per call")
            ps, pout = dual_update_plain(config, ps, are, aim, *tables)
            diffs.update({f"block {b} {fld}": e for fld, e in differ(
                dict(loop_fields(ks, kout.pilot), data_re=kout.data_prompt_re,
                     data_im=kout.data_prompt_im),
                dict(loop_fields(ps, pout.pilot), data_re=pout.data_prompt_re,
                     data_im=pout.data_prompt_im)).items()})
        diffs.update({f"sink {fld}": e for fld, e in sink_runs(
            lambda st, are, aim, sk: dual_update(config, st, are, aim, *tables, sk),
            lambda st, are, aim, sk: dual_update_plain(config, st, are, aim, *tables, sk),
            state, blocks, kout).items()})
        if diffs:
            failures.append(f"dual {name}: {diffs}")
        log(f"[loop dual] {name}: GPS L5 K={k} antennas {ants}, ms_elapsed "
            f"{int(state.ms_elapsed.min())}..{int(state.ms_elapsed.max())}: 3 blocks fresh and "
            f"3 under a sink, kernel against plain "
            f"{'bit for bit on every leaf' if not diffs else f'differing leaves {diffs}'}")
    check(not failures, f"[loop] kernel against plain: {failures}")
    return 0.0


def loop_trajectory(system, seed, num_blocks: int = 200):
    """Phase 3b: `track_bank` K=1024 GPS L1 over ``num_blocks`` blocks at
    50 dB-Hz with the loop kernel (the replayed graph, its outputs and carry
    written through the sink) against the same correlator with the plain
    closure (`loop_update_plain`, block by block): every output of every
    channel over every block, and the final state, bit for bit. Returns the
    channels that agree bit for bit over every block."""
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, TrackOutput, track_bank
    from gpuacceleratedtracking_tpu_torch.tracking.track import (
        _bank_code_tile_kwargs, bank_correlator, loop_update_plain)

    config = TrackConfig.for_system(system, L1_FS, N_1MS, algorithm="pallas_bank_auto")
    codes = torch.as_tensor(system.codes, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 50)
    sre, sim, _ = mixed_blocks(system, num_blocks, NOISE_STD, gen)
    states = bank_states(system, init_errors=True)
    final, out = track_bank(config, codes, states, sre, sim)
    corr, kwargs = bank_correlator(config)
    tiles = _bank_code_tile_kwargs(config, codes, states.prn)
    st, outs = states, []
    for b in range(num_blocks):
        are, aim = corr(sre[b], sim[b], codes, st.prn,
                        config.intermediate_frequency + st.carrier_doppler,
                        config.sampling_frequency, st.carrier_phase,
                        config.code_frequency + st.code_doppler, st.code_phase,
                        config.sample_shifts, config.code_length, **kwargs, **tiles)
        st, o = loop_update_plain(config, st, are, aim)
        outs.append(o)
    ref = TrackOutput(*(torch.stack(x) for x in zip(*outs)))
    torch.cuda.synchronize()
    nsat = len(SAT_DOPPLERS)
    same = torch.ones(NUM_K, dtype=torch.bool, device=DEVICE)
    for field, x in out._asdict().items():
        eq = (x == getattr(ref, field)).reshape(num_blocks, NUM_K, -1).all(-1).all(0)
        same &= eq
    exact = int(same.sum())
    state_diffs = differ(loop_fields(final, None), loop_fields(st, None))
    dop = out.carrier_doppler[-50:, :nsat].double().mean(0).cpu().numpy()
    log(f"[loop trajectory] track_bank K={NUM_K} {num_blocks} blocks at 50 dB-Hz, loop kernel "
        f"(graph, sink) against the plain closure: locked channels' Doppler errors "
        f"{np.abs(dop - SAT_DOPPLERS).tolist()} Hz; {exact} of {NUM_K} channels equal bit "
        f"for bit on every output over every block; final state "
        f"{'bit for bit' if not state_diffs else f'differs: {state_diffs}'}")
    check(exact == NUM_K, f"[loop trajectory] every channel bit for bit ({exact} of {NUM_K})")
    check(not state_diffs, f"[loop trajectory] final state bit for bit: {state_diffs}")
    return exact


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
    note_loop("rows", 20)
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
    note_loop("A", 20)
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


def l5_dual_blocks(num_blocks, offsets, navs, generator, noise_std=L5_NOISE_STD):
    """``[B, N]`` planes: 8 GPS L5 satellites, I5 = code x NH10 x nav and Q5 =
    code x NH20 in quadrature, satellite s starting at overlay phase
    ``offsets[s]`` (its millisecond count mod 20), plus noise of
    ``noise_std`` per component (none at 0)."""
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
    if noise_std:
        noise = torch.randn(total.shape + (2,), generator=generator, device=DEVICE)
        total += noise_std * torch.complex(noise[..., 0], noise[..., 1])
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
    note_loop("B", sync_blocks + num_blocks, dual=True)
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
    `run_sweep` + `run_kernel_benchmark`, on the grids of the port's
    `scripts.run_benchmarks_gpsl1` and `run_benchmarks_gpsl5` (their
    ``params``, at `SWEEP_TRIALS` trials), in two parts: the blocks of
    N <= N_1MS, where most of the sweep's launches are, then the larger ones,
    each read from the launch counters of its own run. Returns the two
    kernels' launch counts in all and in the first part, and the results."""
    from gpuacceleratedtracking_tpu_torch.bench import run_kernel_benchmark, run_sweep
    from gpuacceleratedtracking_tpu_torch.scripts import run_benchmarks_gpsl1, run_benchmarks_gpsl5

    grids = [run_benchmarks_gpsl1.params, run_benchmarks_gpsl5.params]
    results = []
    parts = {}
    for part, keep in (("small", lambda n: n <= N_1MS), ("large", lambda n: n > N_1MS)):
        expected = {"taps": 0, "fused": 0, "replica": 0}
        reset_counts()
        for grid in grids:
            params = dict(grid, num_samples=[n for n in grid["num_samples"] if keep(n)],
                          trials=SWEEP_TRIALS)
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
                check(r["reps_mode"] == "unroll", f"sweep {tag}: the default reps mode")
                if r["algorithm"].startswith("pallas_"):
                    # Warm-up and every trial replay reps + 2 reps calls; a
                    # taps call is one replica and one taps launch.
                    calls = 3 * r["reps_resolved"] * (SWEEP_TRIALS + 1)
                    expected[r["algorithm"][len("pallas_"):]] += calls
                    if r["algorithm"] == "pallas_taps":
                        expected["replica"] += calls
                results.append(r)
                log(f"[sweep] {tag}: median {r['Median'] * 1e3!r} ms, min "
                    f"{r['Minimum'] * 1e3!r} ms, realtime_ratio {r['realtime_ratio']!r} "
                    f"(reps {r['reps_resolved']})")
        counts = read_counts()
        check(counts == only(**expected) and min(expected.values()) > 0,
              f"the sweep's kernel calls ({part} blocks) all launched taps.cu (after "
              f"replica.cu) / fused.cu and no other kernel: got {counts}, want "
              f"{only(**expected)}")
        parts[part] = counts
    check(len(results) == 192, f"192 sweep configs, got {len(results)}")
    total = {name: parts["small"][name] + parts["large"][name] for name in counters()}
    small = {name: parts["small"][name] for name in ("taps", "fused", "replica")}
    log(f"[sweep] 192 configs, launches={total}, of which at N <= {N_1MS}: {small} "
        f"(counted in a run of their own); results in {out_dir}")
    return total, small, results


# The sweep's two corners in every reps mode (phase C2).
SWEEP_CORNERS = ((N_1MS, 1, 3), (N_WIDE, NUM_ANTS, 7))
SWEEP_ALGORITHMS = ("fused_xla", "unfused_xla", "pallas_fused", "pallas_taps")


def sweep_modes(card):
    """Phase C2: the paper's figure at the sweep's two corners (GPS L1,
    N=32768 A=1 L=3 and N=2^18 A=4 L=7) for its four algorithms, in each reps
    mode of `run_kernel_benchmark`, back to back: ``"unroll"`` (one CUDA
    graph of the r calls, the default), ``"scan"`` (graphs of 4 calls) and
    ``"calls"`` (r eager Python calls, the dispatch view). Every kernel call
    must have launched its kernels (3 r (trials + 1) calls per record). For
    each run, the peak device memory it reserved beyond what was reserved
    before it, the allocator's cache emptied first: its graphs' pools (the
    r- and 2r-call graphs), or the eager calls' blocks."""
    from gpuacceleratedtracking_tpu_torch.bench import run_kernel_benchmark

    results, launches = {}, dict.fromkeys(counters(), 0)
    for n, a, taps in SWEEP_CORNERS:
        corner = f"n{n}_a{a}_l{taps}"
        for algo in SWEEP_ALGORITHMS:
            for mode in ("unroll", "scan", "calls"):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()       # so that the run's pools reserve anew
                reserved = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                r = run_kernel_benchmark({
                    "GNSS": "GPSL1", "num_samples": n, "num_ants": a, "num_correlators": taps,
                    "algorithm": algo, "processor": "GPU", "reps": "auto",
                    "trials": SWEEP_TRIALS, "reps_mode": mode})
                torch.cuda.synchronize()
                pool = torch.cuda.max_memory_reserved() - reserved
                counts = read_counts()
                calls = 3 * r["reps_resolved"] * (SWEEP_TRIALS + 1)
                want = {}
                if algo.startswith("pallas_"):
                    want[algo[len("pallas_"):]] = calls
                    if algo == "pallas_taps":
                        want["replica"] = calls
                check(counts == only(**want),
                      f"[sweep modes] {corner} {algo} {mode}: launches {counts}, want {want}")
                check(r["reps_mode"] == mode and math.isfinite(r["Median"]),
                      f"[sweep modes] {corner} {algo} {mode} record")
                for name, count in counts.items():
                    launches[name] += count
                results.setdefault(corner, {}).setdefault(algo, {})[mode] = {
                    "Median": r["Median"], "Minimum": r["Minimum"],
                    "reps": r["reps_resolved"], "reserved_bytes": pool}
                log(f"[sweep modes] GPSL1 {corner} {algo} {mode}: median "
                    f"{r['Median'] * 1e3!r} ms per call (min {r['Minimum'] * 1e3!r}), "
                    f"reps {r['reps_resolved']}; device memory reserved beyond the start "
                    f"{pool} bytes [{card}]")
    # The device ops of one captured call at the launch-weighted corner:
    # torch.profiler over replays of an 8-call "unroll" program.
    from gpuacceleratedtracking_tpu_torch.bench import harness

    reps = 8
    n, a, taps = SWEEP_CORNERS[0]
    corner = f"n{n}_a{a}_l{taps}"
    for algo in SWEEP_ALGORITHMS:
        run = harness.kernel_program({
            "GNSS": "GPSL1", "num_samples": n, "num_ants": a, "num_correlators": taps,
            "algorithm": algo, "processor": "GPU", "reps_mode": "unroll"}, reps)
        ops, device_ms, names = device_profile(run, calls=5, by_name=True)
        per_call = {name: count / reps for name, (count, _) in names.items()}
        results[corner][algo]["unroll"].update(
            device_ops_per_call=ops / reps, device_ms_per_call=device_ms / reps,
            ops_per_call_by_name=per_call)
        log(f"[sweep modes] {corner} {algo}: one captured call is {ops / reps!r} device "
            f"ops, {device_ms / reps!r} ms of device time: "
            + "; ".join(f"{count!r} x {name}" for name, count in per_call.items())
            + f" [{card}]")
        del run
    for corner, algos in results.items():
        for algo in ("pallas_fused", "pallas_taps"):
            m = algos[algo]
            log(f"[sweep modes] {corner} {algo}: unroll {m['unroll']['Median'] * 1e3!r} ms, "
                f"scan {m['scan']['Median'] * 1e3!r} ms, calls {m['calls']['Median'] * 1e3!r} "
                f"ms per call [{card}]")
            if corner == "n{}_a{}_l{}".format(*SWEEP_CORNERS[0]):
                # The replayed reps leave the host's dispatch out of the figure.
                check(m["unroll"]["Median"] < m["calls"]["Median"],
                      f"[sweep modes] {corner} {algo}: unroll below calls")
    return launches, results


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
    note_loop("D", num_blocks_lock)
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
    note_loop("D", sre.shape[0])
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
        benches[name]["record"] = json_record(r)
        log(f"[loops] run_{name}_benchmark {cfg}: median {r['Median'] * 1e3!r} ms/block "
            f"(min {r['Minimum'] * 1e3!r}), realtime_channels {r['realtime_channels']!r}, "
            f"launches {counts}")
    return launches, benches


# --- The cold-start slice: the GLONASS L1OF, Galileo E1-C and BeiDou B1I
# families, PCPS acquisition, the cold-start legs, streaming, and the dual
# bank on the per-channel kernels.

FAMILY_K = 256
FAMILY_NAMES = ("GLONASSL1", "GALILEOE1C", "BEIDOUB1I")
# Planted code phases per family, in its own chips: spread over the code for
# GLONASS (no overlay); near 0 for the overlay families, so that a block
# integrates one overlay sign (E1-C: CS25 per 4 ms period; B1I: NH20 per ms).
FAMILY_CODE_PHASES = {
    "GLONASSL1": SAT_CODE_PHASES * 511.0 / 1023.0,
    "GALILEOE1C": np.array([0.0, 1.5, 3.25, 5.0, 6.5, 8.75, 10.0, 12.5]),
    "BEIDOUB1I": np.array([0.0, 2.5, 4.25, 6.0, 7.5, 9.75, 11.0, 13.5]),
}
# Low-rate cells (the transition route): E1 and B1I at 8.192 MHz, GLONASS at
# 2.048 MHz, where a 2048-sample block covers 512 of its 511 chips, with code
# phases near 510 chips so that the replica wraps the code twice.
LOW_RATE_N = {"GLONASSL1": 2048, "GALILEOE1C": 8192, "BEIDOUB1I": 8192}
ACQ_SIZES = (32768, 1 << 17, 1 << 18)
ACQ_PRNS = np.array([2, 7, 13, 21])
ACQ_DOPPLERS = np.array([-2400.0, -700.0, 850.0, 3100.0])
ACQ_CODE_PHASES = np.array([120.0, 512.3, 41.7, 987.2])
STREAM_BLOCKS = 240


def family_config(system, n, algorithm="pallas_bank_auto"):
    """The family cells' tracking configuration (the pilot E1-C on atan2)."""
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig

    extra = {"pll_discriminator": "atan2"} if system.name == "GALILEOE1C" else {}
    return TrackConfig.for_system(system, n / 1e-3, n, algorithm=algorithm, **extra)


def family_cells(seed):
    """The families through `pallas_bank_auto` against the plain version, at
    N=32768 K=256 (the rows route) and the low-rate cell (the transition
    route); the JAX suite's envelopes (9.0 at Galileo's doubled transition
    density, tests/test_galileo.py:172-175; 4.5 elsewhere)."""
    from gpuacceleratedtracking_tpu_torch.models import get_system
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    worst = {"bank_rows": 0.0, "bank_transition": 0.0}
    for i, name in enumerate(FAMILY_NAMES):
        system = get_system(name)
        for n, k, route, kernel in ((N_1MS, FAMILY_K, "pallas_bank_rows", "bank_rows"),
                                    (LOW_RATE_N[name], 64, "pallas_bank", "bank_transition")):
            case = random_case(system, n, k, seed + 500 + 2 * i + (n == N_1MS))
            if name == "GLONASSL1" and n == LOW_RATE_N[name]:
                case["code_phase"] = torch.linspace(505.0, 510.9, k, device=DEVICE)
            check(epl_kernels.bank_algorithm_for(n, case["sampling_frequency"],
                                                 system.code_length, system.code_frequency)
                  == route, f"{name} N={n} routes to {route}")
            before = read_counts()
            got = epl_kernels.correlate_pallas_bank_auto(**case)
            torch.cuda.synchronize()
            after = read_counts()
            check({key: after[key] - before[key] for key in after} == only(**{kernel: 1}),
                  f"{name} N={n}: one {kernel} launch and no other")
            want = epl_kernels.correlate_bank_rows_reference(**case, route=route)
            atol = 9.0 if name.startswith("GALILEO") else 4.5
            err = 0.0
            for g, w in zip(got, want):
                check(g.shape == w.shape == (k, 3), f"{name} N={n} shape")
                check(bool(torch.isfinite(g).all()), f"{name} N={n} finite")
                err = max(err, float((g - w).abs().max()))
                check(bool(((g - w).abs() <= atol + 2e-3 * w.abs()).all()),
                      f"{name} N={n}: kernel vs plain within rtol=2e-3 atol={atol}")
            worst[kernel] = max(worst[kernel], err)
            phases = (f", code phases {float(case['code_phase'].min())!r}.."
                      f"{float(case['code_phase'].max())!r} chips of {system.code_length}"
                      if name == "GLONASSL1" and n < N_1MS else "")
            log(f"[family] {kernel} {name} N={n} K={k} via pallas_bank_auto -> {route}: "
                f"max|kernel-plain|={err!r} (atol {atol}, rtol 2e-3){phases} ok")
    return worst


def family_blocks(system, num_blocks, n=N_1MS, noise_std=0.0, generator=None,
                  init_errors=False):
    """``[B, N]`` planes of 8 satellites of ``system`` (overlay included where
    the system has one) and a K=256 bank state whose first 8 channels hold
    them, Doppler and code phase off by 20 Hz and 0.2 chips if asked."""
    from gpuacceleratedtracking_tpu_torch.models import gen_signal, soa
    from gpuacceleratedtracking_tpu_torch.tracking import init_state

    phases = FAMILY_CODE_PHASES[system.name]
    total = None
    for prn, (dop, phi) in enumerate(zip(SAT_DOPPLERS, phases)):
        sig, _ = gen_signal(system, prn, float(dop), n * num_blocks,
                            duration=num_blocks * 1e-3, start_code_phase=float(phi),
                            code_frequency=system.code_frequency
                            * (1 + dop / system.center_frequency),
                            secondary_code=system.secondary_code, device=DEVICE)
        total = sig if total is None else total + sig
    if noise_std:
        noise = torch.randn(total.shape + (2,), generator=generator, device=DEVICE)
        total += noise_std * torch.complex(noise[..., 0], noise[..., 1])
        del noise
    sre, sim = (x.reshape(num_blocks, n) for x in soa(total))
    nsat = len(SAT_DOPPLERS)
    dops = np.linspace(-4000.0, 4000.0, FAMILY_K)
    code_phases = np.zeros(FAMILY_K)
    dops[:nsat] = SAT_DOPPLERS + (20.0 if init_errors else 0.0)
    code_phases[:nsat] = (phases - (0.2 if init_errors else 0.0)) % system.code_length
    states = init_state(np.arange(FAMILY_K) % system.num_prns, carrier_doppler=dops,
                        code_phase=code_phases, device=DEVICE)
    return sre, sim, states


def family_loops(seed, card, num_blocks_lock: int = 300):
    """Closed loops at K=256, N=32768 for each family, as `main_path` does: 20
    noiseless blocks through the kernel against `xla_bank` (locked channels
    over every block, all channels in block 0), a noisy lock run, the block
    time, and `run_track_benchmark` at K in {64, 256}. Returns the rows
    kernel's launches, counted per run, and the timings."""
    from gpuacceleratedtracking_tpu_torch.bench import run_track_benchmark
    from gpuacceleratedtracking_tpu_torch.models import get_system
    from gpuacceleratedtracking_tpu_torch.tracking import track_bank

    nsat = len(SAT_DOPPLERS)
    launches, results = 0, {}
    for i, name in enumerate(FAMILY_NAMES):
        system = get_system(name)
        codes = torch.as_tensor(system.codes, device=DEVICE)
        config = family_config(system, N_1MS)
        sre, sim, states = family_blocks(system, 20, init_errors=True)
        reset_counts()
        _, out = track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == only(bank_rows=20),
              f"{name}: 20 bank_rows launches in 20 blocks and no other kernel, got {counts}")
        launches += counts["bank_rows"]
        for field, x in out._asdict().items():
            check(bool(torch.isfinite(x.float()).all()), f"{name} loop {field} finite")
        _, ref = track_bank(family_config(system, N_1MS, "xla_bank"), codes, states, sre, sim)
        torch.cuda.synchronize()
        diff = (out.prompt_re - ref.prompt_re).abs()
        bound = 40.0 + 5e-3 * ref.prompt_re.abs()
        d_first, d_locked = float(diff[0].max()), float(diff[:, :nsat].max())
        check(bool((diff[0] <= bound[0]).all()),
              f"{name} block 0 prompt_re vs xla_bank within rtol=5e-3 atol=40 ({d_first!r})")
        check(bool((diff[:, :nsat] <= bound[:, :nsat]).all()),
              f"{name} locked prompt_re vs xla_bank within rtol=5e-3 atol=40 ({d_locked!r})")
        log(f"[family loop] {name} track_bank K={FAMILY_K} N={N_1MS} 20 blocks via "
            f"pallas_bank_auto (overlay {len(config.secondary_code)} signs, "
            f"{config.pll_discriminator}): launches={counts}; vs xla_bank: block 0 "
            f"max|d prompt_re|={d_first!r}, 8 locked channels {d_locked!r}")

        # Lock from a 20 Hz / 0.2 chip start at 50 dB-Hz.
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 600 + i)
        nre, nim, _ = family_blocks(system, num_blocks_lock, noise_std=NOISE_STD, generator=gen)
        reset_counts()
        _, out = track_bank(config, codes, states, nre, nim)
        torch.cuda.synchronize()
        launches += read_counts()["bank_rows"]
        note_loop("families", num_blocks_lock)
        del nre, nim
        dop = out.carrier_doppler[-50:, :nsat].double().mean(0).cpu().numpy()
        mag = torch.hypot(out.prompt_re[-50:, :nsat], out.prompt_im[-50:, :nsat])
        mag = mag.double().mean(0).cpu().numpy()
        dop_err = np.abs(dop - SAT_DOPPLERS)
        log(f"[family lock] {name} {num_blocks_lock} blocks at 50 dB-Hz: Doppler errors "
            f"(last 50) {dop_err.tolist()} Hz, mean |prompt| {mag.tolist()}")
        check(bool(np.all(dop_err < 5.0)), f"{name} Doppler within 5 Hz: {dop_err.tolist()}")
        check(bool(np.all(mag > N_1MS / 2)), f"{name} |prompt| > N/2: {mag.tolist()}")

        # Block time on the noiseless blocks, 10 blocks per timed call.
        states = family_blocks(system, 1)[2]
        med, mn = time_cuda(lambda: track_bank(config, codes, states, sre[:10], sim[:10]),
                            warmup=2)
        entry = {"block_ms": med / 10, "block_min_ms": mn / 10,
                 "realtime_channels": FAMILY_K / (med / 10)}
        log(f"[time] closed-loop block {name} K={FAMILY_K} N={N_1MS}: median "
            f"{entry['block_ms']!r} ms (min {entry['block_min_ms']!r}); real-time channels "
            f"{entry['realtime_channels']!r} [{card}]")
        for k in (64, FAMILY_K):
            reset_counts()
            r = run_track_benchmark({"GNSS": name, "num_samples": N_1MS, "num_channels": k,
                                     "algorithm": "pallas_bank_auto", "processor": "GPU",
                                     "blocks": 8, "trials": 7})
            counts = read_counts()
            check(counts["bank_rows"] > 0 and sum(counts.values()) == counts["bank_rows"],
                  f"run_track_benchmark {name} K={k} launched bank_rows only: {counts}")
            entry[f"bench_k{k}"] = {key: r[key] for key in ("Median", "Minimum",
                                                           "realtime_channels")}
            entry[f"bench_k{k}"]["record"] = json_record(r)
            log(f"[time] run_track_benchmark {name} K={k} N={N_1MS}: median "
                f"{r['Median'] * 1e3!r} ms/block (min {r['Minimum'] * 1e3!r}), "
                f"realtime_channels {r['realtime_channels']!r} [{card}]")
        results[name] = entry
        del sre, sim, out, ref
    return launches, results


def acquisition_path(seed, card):
    """`run_acquire_benchmark` for GPS L1 at N in ACQ_SIZES, 32 PRNs on the
    card (ms per call), and `acquire` on a 4-satellite mix at 50 dB-Hz at the
    same N: the planted PRNs, Doppler bins and code phases are found."""
    from gpuacceleratedtracking_tpu_torch.acquire import acquire
    from gpuacceleratedtracking_tpu_torch.bench import run_acquire_benchmark
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, gen_signal_mixed, soa

    system = GPSL1()
    results = {}
    for n in ACQ_SIZES:
        r = run_acquire_benchmark({"GNSS": "GPSL1", "num_samples": n, "num_prns": 32,
                                   "processor": "GPU", "trials": 5})
        check(r["backend"] == "cuda" and r["num_prns"] == 32, f"acquire N={n} on the card")
        fs = n / 1e-3
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 700)
        sig, _ = gen_signal_mixed(system, ACQ_PRNS, ACQ_DOPPLERS, n,
                                  start_code_phases=ACQ_CODE_PHASES,
                                  noise_std=math.sqrt(fs / 1e5 / 2), generator=gen,
                                  device=DEVICE)
        res = acquire(system, *soa(sig), np.arange(32), fs)
        ops, device_ms = device_profile(lambda: acquire(system, *soa(sig), np.arange(32), fs),
                                        calls=3)
        metric = res.peak_metric.cpu().numpy()
        hits = np.flatnonzero(metric > 20.0)
        step = 2.0 / 3.0 / 1e-3
        dop = res.carrier_doppler.cpu().numpy()[ACQ_PRNS]
        phase_err = np.abs(res.code_phase.cpu().numpy()[ACQ_PRNS] - ACQ_CODE_PHASES)
        phase_err = np.minimum(phase_err, system.code_length - phase_err)
        log(f"[acquire] GPS L1 N={n}: 32 PRNs x {r['num_bins']} bins: median "
            f"{r['Median'] * 1e3!r} ms per call (min {r['Minimum'] * 1e3!r}); {ops!r} device ops "
            f"per call, {device_ms!r} ms of summed device time (torch.profiler) [{card}]; planted "
            f"{ACQ_PRNS.tolist()} found {hits.tolist()}, Doppler {dop.tolist()} Hz, "
            f"code phase errors {phase_err.tolist()} chips, metrics {metric[ACQ_PRNS].tolist()}")
        check(hits.tolist() == ACQ_PRNS.tolist(), f"N={n}: accepted PRNs {hits.tolist()}")
        check(bool(np.all(np.abs(dop - ACQ_DOPPLERS) <= step / 2 + 1e-3)),
              f"N={n}: nearest Doppler bins")
        check(bool(np.all(phase_err < 0.25)), f"N={n}: code phases within 0.25 chips")
        results[f"n{n}"] = {"ms": r["Median"] * 1e3, "min_ms": r["Minimum"] * 1e3,
                            "num_bins": r["num_bins"], "device_ops": ops,
                            "device_ms": device_ms}
        del sig, res
    return results


def coldstart_path(card):
    """Phase G, the cold-start receiver: the port's `scripts.run_coldstart`,
    its int8 captures and the L1 checkpoint in a temporary directory, each
    leg's launches counted from 0 just before it. The module raises where the
    JAX script asserts (planted PRNs accepted, NH20 confidence > 0.75, the B1I
    offsets, Doppler within 10 Hz); the checks here hold the legs to the
    launches of their routes, the L5 offsets, the L5 nav symbols and the B1I
    nav bits by differential decisions (the reference leaves PRN 8 ~1.7 Hz
    off, frequency locked but rotating)."""
    import tempfile

    from gpuacceleratedtracking_tpu_torch import runtime
    from gpuacceleratedtracking_tpu_torch.scripts import run_coldstart as cs

    check(runtime.native_available(), "the native IQ decoder builds and loads")
    launches, results, report = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        paths = {leg: work / name for leg, name in cs.CAPTURE_NAMES.items()}
        for leg, path in paths.items():
            cs.synthesize(leg, path, DEVICE)
        # Each leg, then its loop-kernel launches (L5's dual track: one
        # dual-mode launch per block; B1I's two stages: one per block).
        legs = (("l1", lambda: cs.run_l1(paths["l1"], report, DEVICE, work),
                 lambda: note_loop("coldstart_l1")),
                ("l5", lambda: cs.run_l5(paths["l5"], report, DEVICE),
                 lambda: note_loop("coldstart_l5", report["l5_dual_track"]["blocks"], dual=True)),
                ("b1i", lambda: cs.run_b1i(paths["b1i"], report, DEVICE),
                 lambda: note_loop("coldstart_b1i", cs.B1I["ms"])))
        for leg, run, loops in legs:
            reset_counts()
            run()
            torch.cuda.synchronize()
            launches[leg] = read_counts()
            loops()

    l1 = report["l1_track"]
    log(f"[coldstart L1] acquisition over 32 PRNs: {report['l1_acquisition']['accepted']} "
        f"(planted {cs.L1['prns']}); StreamTracker {l1['blocks']} blocks, checkpoint and cold "
        f"resume at {l1['resume_at_block']}; launches={launches['l1']}; Doppler errors "
        f"{l1['doppler_error_hz']} Hz; steady_block_s {l1['steady_block_s']!r} (real-time "
        f"factor {l1['steady_realtime_factor']!r}) [{card}]")
    check(l1["blocks"] == cs.L1["ms"] and l1["resume_at_block"] == cs.L1["ms"] // 2,
          f"L1 streamed {l1['blocks']} blocks, resumed at {l1['resume_at_block']}")
    check(launches["l1"] == only(bank_rows=l1["blocks"]),
          f"L1 stream: one bank_rows launch per block and no other kernel, got {launches['l1']}")

    sync5, l5 = report["l5_secondary_sync"], report["l5_dual_track"]
    log(f"[coldstart L5] pilot acquisition: {report['l5_acquisition']['accepted']}; NH20 "
        f"offsets {sync5['nh20_offset_blocks']} (planted {sync5['planted_offset']}, "
        f"block-dominant {sync5['expected_offset_block_dominant']}), confidence "
        f"{sync5['confidence']}; dual track {l5['blocks']} blocks: launches={launches['l5']}; "
        f"Doppler errors {l5['doppler_error_hz']} Hz; nav symbols recovered "
        f"{l5['nav_symbols_recovered']}; steady_block_s {l5['steady_block_s']!r} [{card}]")
    check(sync5["nh20_offset_blocks"] == sync5["expected_offset_block_dominant"],
          "L5 NH20 phases recovered")
    check(launches["l5"] == only(bank_transition=cs.L5["ms"]),
          f"L5: one transition launch per block and no other kernel, got {launches['l5']}")
    check(all(l5["nav_symbols_recovered"]), "L5 nav symbols recovered")

    syncb, b1i = report["b1i_secondary_sync"], report["b1i_track"]
    log(f"[coldstart B1I] acquisition: {report['b1i_acquisition']['accepted']}; NH20 offsets "
        f"{syncb['nh20_offset_blocks']} (expected {syncb['expected_offset_block_dominant']}), "
        f"confidence {syncb['confidence']}; NH-wiped track {b1i['blocks']} blocks: "
        f"launches={launches['b1i']}; Doppler errors {b1i['doppler_error_hz']} Hz; nav bits "
        f"recovered (differential) {b1i['nav_bits_recovered_differential']}, by the prompt's "
        f"sign {b1i['nav_bits_recovered_coherent']}; steady_block_s "
        f"{b1i['steady_block_s']!r} [{card}]")
    check(launches["b1i"] == only(bank_transition=cs.B1I["ms"]),
          f"B1I: one transition launch per block and no other kernel, got {launches['b1i']}")
    check(all(b1i["nav_bits_recovered_differential"]), "B1I nav bits recovered")
    for leg, track in (("l1", l1), ("l5", l5), ("b1i", b1i)):
        check(bool(np.all(np.abs(track["doppler_error_hz"]) < 10.0)),
              f"{leg} Doppler errors {track['doppler_error_hz']}")
        results[leg] = {"steady_block_s": track["steady_block_s"],
                        "realtime_factor": track["steady_realtime_factor"],
                        "doppler_error_hz": track["doppler_error_hz"]}
    results["l5"]["nh20_offsets"] = sync5["nh20_offset_blocks"]
    results["b1i"]["nh20_offsets"] = syncb["nh20_offset_blocks"]
    return launches, results


def streaming_path(seed, card):
    """An L1 int8 capture at N=32768 through `StreamTracker` into a K=256
    bank (rows route); its steady per-block time beside the bare `track_bank`
    block time of the same bank on device-resident blocks."""
    import tempfile

    from gpuacceleratedtracking_tpu_torch.models import GPSL1, gen_signal_mixed
    from gpuacceleratedtracking_tpu_torch.runtime import IQFile, StreamTracker, blocks
    from gpuacceleratedtracking_tpu_torch.scripts import run_coldstart as cs
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, eager, init_state, track_bank

    system = GPSL1()
    nsat = len(SAT_DOPPLERS)
    scale = 3.0     # int8 LSBs per unit amplitude: clips at ~3.3 noise sigma
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 800)
    sig, fs = gen_signal_mixed(system, np.arange(nsat), SAT_DOPPLERS, N_1MS * STREAM_BLOCKS,
                               duration=STREAM_BLOCKS * 1e-3, start_code_phases=SAT_CODE_PHASES,
                               noise_std=NOISE_STD, generator=gen, device=DEVICE)
    dops = np.linspace(-4000.0, 4000.0, FAMILY_K)
    phases = np.zeros(FAMILY_K)
    dops[:nsat], phases[:nsat] = SAT_DOPPLERS, SAT_CODE_PHASES
    states = init_state(np.arange(FAMILY_K) % 32, carrier_doppler=dops, code_phase=phases,
                        device=DEVICE)
    config = TrackConfig.for_system(system, fs, N_1MS, algorithm="pallas_bank_auto")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "gpsl1_32768kHz.int8"
        inter = torch.view_as_real(sig).reshape(-1) * scale
        inter.round().clamp(-127, 127).to(torch.int8).cpu().numpy().tofile(path)
        del inter, sig
        tracker = StreamTracker(config, system.codes, states, blocks_per_dispatch=20,
                                measure_dispatch=True)
        reset_counts()
        with IQFile(path, "int8", 1.0 / scale) as f:
            result = tracker.run(blocks(f, N_1MS))
        torch.cuda.synchronize()
        counts = read_counts()
        note_loop("streaming", STREAM_BLOCKS)
        # The same stream through the eager block loop (phase L): the same
        # outputs, bit for bit, and its steady block time beside the graph's.
        with eager(), IQFile(path, "int8", 1.0 / scale) as f:
            result_eager = StreamTracker(config, system.codes, states, blocks_per_dispatch=20,
                                         measure_dispatch=True).run(blocks(f, N_1MS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with IQFile(path, "int8", 1.0 / scale) as f:
            num_read = sum(1 for _ in blocks(f, N_1MS))
        decode_ms = (time.perf_counter() - t0) * 1e3 / num_read   # host read + decode
        sre, sim = cs.read_blocks(path, N_1MS, 20, 0, 1.0 / scale, DEVICE)
    check(result.blocks_processed == STREAM_BLOCKS, "streamed every block")
    check(counts == only(bank_rows=STREAM_BLOCKS),
          f"stream: one bank_rows launch per block and no other kernel, got {counts}")
    out = result.stacked()
    same = all(np.array_equal(x, y) for x, y in zip(out, result_eager.stacked()))
    check(same, "stream: the graph replays give the eager loop's outputs bit for bit")
    dop_err = np.abs(out.carrier_doppler[-50:, :nsat].astype(np.float64).mean(0) - SAT_DOPPLERS)
    codes = torch.as_tensor(system.codes, device=DEVICE)
    med, mn = time_cuda(lambda: track_bank(config, codes, states, sre, sim), warmup=2)
    bare = med / 20
    steady, steady_eager = result.steady_block_s, result_eager.steady_block_s
    log(f"[stream] StreamTracker K={FAMILY_K} N={N_1MS} {STREAM_BLOCKS} blocks of an int8 "
        f"capture, 20 per dispatch: launches={counts}; Doppler errors (8 satellites, last 50) "
        f"{dop_err.tolist()} Hz; steady_block_s {steady!r} (real-time factor "
        f"{1e-3 / steady!r}; eager loop {steady_eager!r}, outputs equal bit for bit); bare "
        f"track_bank block {bare!r} ms (min {mn / 20!r}); file read and decode alone "
        f"{decode_ms!r} ms per block [{card}]")
    check(bool(np.all(dop_err < 5.0)), f"stream Doppler within 5 Hz: {dop_err.tolist()}")
    check(bool(np.isfinite(out.prompt_re).all()), "stream outputs finite")
    return counts, {"steady_block_s": steady, "realtime_factor": 1e-3 / steady,
                    "eager_steady_block_s": steady_eager,
                    "bare_block_ms": bare, "bare_block_min_ms": mn / 20,
                    "decode_ms": decode_ms}


def dual_per_channel_path(seed, num_k: int = 4, num_blocks: int = 20):
    """`track_bank_dual` at K=4 on `pallas_fused` and `pallas_taps`: 2K
    launches per block, agreement with `xla_bank` on noiseless blocks of the
    8 L5 satellites (the first 4 tracked). The fused kernel derives its chips
    in its own f32 arithmetic, as the JAX one does: a chip-boundary flip moves
    a prompt by twice a sample (|s| <= 8 sqrt 2 here), so the bound is
    rtol=5e-3 atol=40, which noise of 45 dB-Hz per sample would swamp."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, init_state, track_bank_dual)

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    codes_i = torch.as_tensor(sys_i.codes, device=DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=DEVICE)
    rng = np.random.default_rng(seed + 900)
    offsets = rng.integers(0, 20, len(L5_PRNS))
    navs = rng.choice([-1.0, 1.0], (len(L5_PRNS), (20 + num_blocks) // 10 + 1))
    sre, sim = l5_dual_blocks(num_blocks, offsets, navs, None, noise_std=0.0)
    states = init_state(L5_PRNS[:num_k], carrier_doppler=L5_DOPPLERS[:num_k],
                        code_phase=L5_CODE_PHASES[:num_k], ms_elapsed=offsets[:num_k],
                        device=DEVICE)
    outs, launches = {}, {}
    for algo in ("pallas_fused", "pallas_taps", "xla_bank"):
        config = dual_config(TrackConfig.for_system(sys_i, L1_FS, N_1MS, algorithm=algo,
                                                    use_secondary=False))
        reset_counts()
        _, outs[algo] = track_bank_dual(config, codes_i, codes_q, states, sre, sim)
        torch.cuda.synchronize()
        counts = read_counts()
        kernel = algo[len("pallas_"):] if algo != "xla_bank" else None
        want = {kernel: 2 * num_k * num_blocks} if kernel else {}
        if kernel == "taps":
            want["replica"] = 2 * num_k * num_blocks
        check(counts == only(**want), f"dual {algo}: 2K launches per block, got {counts}")
        note_loop("I", num_blocks, dual=True)
        for name in want:
            launches[name] = counts[name]
    for algo in ("pallas_fused", "pallas_taps"):
        d_p = (outs[algo].pilot.prompt_re - outs["xla_bank"].pilot.prompt_re).abs()
        d_d = (outs[algo].data_prompt_re - outs["xla_bank"].data_prompt_re).abs()
        ref = outs["xla_bank"].pilot.prompt_re.abs()
        check(bool((d_p <= 40.0 + 5e-3 * ref).all()),
              f"dual {algo} pilot prompt vs xla_bank within rtol=5e-3 atol=40 "
              f"({float(d_p.max())!r})")
        check(bool((d_d <= 40.0 + 5e-3 * outs["xla_bank"].data_prompt_re.abs()).all()),
              f"dual {algo} data prompt vs xla_bank ({float(d_d.max())!r})")
        log(f"[dual per-channel] track_bank_dual K={num_k} N={N_1MS} {num_blocks} noiseless "
            f"blocks via "
            f"{algo}: {2 * num_k} launches per block; vs xla_bank max|d pilot prompt_re| "
            f"{float(d_p.max())!r}, max|d data prompt_re| {float(d_d.max())!r}")
    return launches


# --- The distributed layer (phase J) and the figure layer (phase K).

def mesh_devices(count):
    """``count`` mesh devices: every visible card in turn where there are two
    or more, else cuda:0 repeated (one card then runs every shard)."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(count)]


def within(name, got, want, atol, rtol):
    """Check ``|got - want| <= atol + rtol |want|`` everywhere; the largest
    difference."""
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= atol + rtol * want.abs()).all()),
          f"{name} within rtol={rtol} atol={atol} ({err!r})")
    return err


def close_prompts(name, got, want, nsat, atol=40.0, rtol=5e-3):
    """Prompts of block 0 on every channel and of every block on the ``nsat``
    locked ones (a channel with no signal runs a chaotic loop, where one f32
    rounding apart in block 0 grows into another trajectory)."""
    return (within(f"{name} block 0 prompt_re", got[0], want[0], atol, rtol),
            within(f"{name} locked prompt_re", got[:, :nsat], want[:, :nsat], atol, rtol))


def shard_cells(seed):
    """J0: the six kernels at the shard-local shapes phase J gives them, each
    against its plain version, with phase 3's tolerances."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp, channel_kernels, epl_kernels

    l1, l5 = GPSL1(), GPSL5()
    bank_cells = [
        # kernel, cell, system, N, fs, K, A, L: J2's 2 x 2 shard, J1's, J3's,
        # J4's, J1's L5 leg, J6's
        ("bank_rows", "j2_k512_n16384", l1, 16384, L1_FS, NUM_K // 2, 1, 3),
        ("bank_rows", "j1_k1_n4096", l1, 4096, 8.192e6, 1, 1, 3),
        ("bank_comp", "j3_k512_a4_l7_n16384", l1, 16384, L1_FS, NUM_K // 2, NUM_ANTS, 7),
        ("bank_transition", "j4_l5_k64_n32768", l5, N_1MS, L1_FS, DUAL_K, 1, 3),
        ("bank_transition", "j1_l5_k2_n16384", l5, 16384, 16.384e6, 2, 1, 3),
        ("bank_onehot", "j6_k32_n4096", l1, 4096, 8.192e6, 32, 1, 3),
    ]
    runs = {
        "bank_rows": (epl_kernels.correlate_pallas_bank_rows, "pallas_bank_rows"),
        "bank_transition": (epl_kernels.correlate_pallas_bank, "pallas_bank"),
        "bank_onehot": (epl_kernels.correlate_pallas_bank_onehot, "pallas_bank_onehot"),
    }
    worst = {}
    for i, (kernel, cell, system, n, fs, k, a, taps) in enumerate(bank_cells):
        case = random_case(system, n, k, seed + 1100 + i, num_ants=a, taps=taps, fs=fs)
        if kernel == "bank_comp":
            fn = bank_comp.correlate_pallas_bank_comp
            got, want = fn(**case), bank_comp.correlate_bank_comp_reference(**case)
            atol, rtol = 3e-5 * float(want[0].abs().max()) + 1e-3, 0.0
        else:
            fn, route = runs[kernel]
            if kernel == "bank_onehot":
                del case["nominal_code_frequency"]
            got = fn(**case)
            want = epl_kernels.correlate_bank_rows_reference(**case, route=route)
            atol, rtol = 4.5, 2e-3
        torch.cuda.synchronize()
        err = max(within(f"[J0] {kernel} {cell}", g, w, atol, rtol) for g, w in zip(got, want))
        check(got[0].shape == ((k, taps) if a == 1 else (k, a, taps)), f"[J0] {cell} shape")
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        log(f"[J0] {kernel} {cell}: {system.name} N={n} K={k} A={a} L={taps}: "
            f"max|kernel-plain|={err!r} ok")
    # J5's shards: N=2^18 A=4 over ant 4 x time 2, N=2^17 over time 8.
    for cell, n, taps in (("j5_n131072_l7", 1 << 17, 7), ("j5_n16384_l3", 1 << 14, 3)):
        args = channel_args("GPSL1", n, 1, taps, 0, 1500.0, 0.3, 17.5)
        for kind in ("taps", "fused"):
            got = getattr(channel_kernels, f"correlate_pallas_{kind}")(*args)
            want = getattr(channel_kernels, f"correlate_{kind}_reference")(*args)
            torch.cuda.synchronize()
            err = max(within(f"[J0] {kind} {cell}", g, w, 1e-6 * n + 1e-3, 0.0)
                      for g, w in zip(got, want))
            worst[kind] = max(worst.get(kind, 0.0), err)
            log(f"[J0] {kind} {cell}: N={n} A=1 L={taps}: max|kernel-plain|={err!r} ok")
    return worst


def dryrun_leg():
    """J1, the counterpart of the JAX dry run (`__graft_entry__.py:91-185`) on a
    (chan 2, time 2) mesh: the L1 rows bank at N=8192 (whose shards must route
    to the rows kernel) against `track_bank`, and the GPS L5 dual bank at
    N=16384 on the channel axis against `track_bank_dual`, at its tolerances."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5, gen_signal, soa
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
    from gpuacceleratedtracking_tpu_torch.parallel import (
        channel_time_mesh, track_bank_dual_sharded, track_bank_sharded)
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, init_state, track_bank, track_bank_dual)

    num_chan, num_time, blocks = 2, 2, 2
    mesh = channel_time_mesh(num_chan, num_time, devices=mesh_devices(num_chan * num_time))
    system = GPSL1()
    num_k, n = max(num_chan, 2), 8192
    fs = n / 1e-3
    dops = np.linspace(-1000.0, 1000.0, num_k)
    signal, _ = gen_signal(system, 0, float(dops[0]), n * blocks, duration=blocks * 1e-3,
                           device=DEVICE)
    sre, sim = (x.reshape(blocks, n) for x in soa(signal))
    config = TrackConfig.for_system(system, fs, n, algorithm="pallas_bank_auto")
    routed = epl_kernels.bank_algorithm_for(n // num_time, fs, system.code_length,
                                            system.code_frequency)
    check(routed == "pallas_bank_rows", f"J1 shards route to the rows kernel, got {routed}")
    states = init_state(np.arange(num_k) % 32, carrier_doppler=dops, device=DEVICE)
    codes = torch.as_tensor(system.codes, device=DEVICE)
    reset_counts()
    _, out = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(bank_rows=num_chan * num_time * blocks),
          f"J1: one rows launch per shard and block, got {counts}")
    check(out.prompt_re.shape == (blocks, num_k), "J1 prompt shape")
    _, ref = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    d_p = within("J1 prompt_re", out.prompt_re, ref.prompt_re, 1e-2 * n, 2e-3)
    d_d = within("J1 carrier_doppler", out.carrier_doppler, ref.carrier_doppler, 1e-2, 2e-3)

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    n5 = 16384
    sig5, _ = gen_signal(sys_i, 0, 700.0, n5 * blocks, duration=blocks * 1e-3,
                         secondary_code=sys_i.secondary_code, device=DEVICE)
    s5re, s5im = (x.reshape(blocks, n5) for x in soa(sig5))
    cfg5 = dual_config(TrackConfig.for_system(sys_i, n5 / 1e-3, n5, algorithm="pallas_bank_auto",
                                              use_secondary=False))
    states5 = init_state(np.arange(num_chan) % sys_i.codes.shape[1],
                         carrier_doppler=np.linspace(-900.0, 900.0, num_chan), device=DEVICE)
    codes_i = torch.as_tensor(sys_i.codes, device=DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=DEVICE)
    reset_counts()
    final_s, out_s = track_bank_dual_sharded(cfg5, codes_i, codes_q, states5, s5re, s5im,
                                             mesh=mesh)
    torch.cuda.synchronize()
    counts5 = read_counts()
    check(counts5 == only(bank_transition=num_chan * blocks),
          f"J1 L5: one transition launch per channel shard and block, got {counts5}")
    final_u, out_u = track_bank_dual(cfg5, codes_i, codes_q, states5, s5re, s5im)
    torch.cuda.synchronize()
    d5 = max(within("J1 L5 pilot prompt_re", out_s.pilot.prompt_re, out_u.pilot.prompt_re,
                    1e-2, 1e-5),
             within("J1 L5 data prompt_re", out_s.data_prompt_re, out_u.data_prompt_re,
                    1e-2, 1e-5))
    d5c = within("J1 L5 code phase", final_s.code_phase, final_u.code_phase, 1e-4, 0.0)
    log(f"[J1] dry run on {[str(d) for d in mesh.devices.flat]}: L1 K={num_k} N={n} {blocks} "
        f"blocks on (chan {num_chan}, time {num_time}), route {routed}, launches "
        f"{counts['bank_rows']}; vs track_bank max|d prompt_re| {d_p!r}, max|d Doppler| "
        f"{d_d!r}; L5 dual K={num_chan} N={n5} launches {counts5['bank_transition']}, vs "
        f"track_bank_dual max|d prompt| {d5!r}, max|d code phase| {d5c!r} ok")
    return {"bank_rows": counts["bank_rows"], "bank_transition": counts5["bank_transition"]}


def block_time(name, run, channels, card, blocks=10):
    """Closed-loop block time of ``run`` (``blocks`` blocks per call) and the
    real-time channels at 1 ms blocks."""
    med, mn = time_cuda(run, warmup=2)
    entry = {"block_ms": med / blocks, "block_min_ms": mn / blocks,
             "realtime_channels": channels / (med / blocks)}
    log(f"[J time] {name}: block median {entry['block_ms']!r} ms (min "
        f"{entry['block_min_ms']!r}); real-time channels {entry['realtime_channels']!r} [{card}]")
    return entry


def sharded_bank_path(system, seed, sre, sim, card, num_blocks_lock: int = 100):
    """J2: the K=1024 GPS L1 bank at N=32768 on `main_path`'s 20 noiseless
    8-satellite blocks, on meshes 2 x 1, 1 x 2 and 2 x 2 against unsharded
    `track_bank` (one rows launch per shard and block); 100 blocks at
    50 dB-Hz on 2 x 2 from the true state, in which the 8 satellites hold
    lock; block times of each mesh beside the unsharded block."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    codes = torch.as_tensor(system.codes, device=DEVICE)
    config = TrackConfig.for_system(system, L1_FS, N_1MS, algorithm="pallas_bank_auto")
    states = bank_states(system, init_errors=True)
    nsat = len(SAT_DOPPLERS)
    blocks = sre.shape[0]
    _, ref = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    launches, meshes = 0, {}
    for chan, time_ in ((2, 1), (1, 2), (2, 2)):
        mesh = channel_time_mesh(chan, time_, devices=mesh_devices(chan * time_))
        meshes[f"{chan}x{time_}"] = mesh
        check(epl_kernels.bank_algorithm_for(N_1MS // time_, L1_FS, system.code_length,
                                             system.code_frequency) == "pallas_bank_rows",
              "J2 shards route to the rows kernel")
        reset_counts()
        _, out = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == only(bank_rows=chan * time_ * blocks),
              f"J2 {chan}x{time_}: one rows launch per shard and block, got {counts}")
        launches += counts["bank_rows"]
        for field, x in out._asdict().items():
            check(bool(torch.isfinite(x.float()).all()), f"J2 {chan}x{time_} {field} finite")
        # Channel shards alone change only the kernel's summation grouping
        # (its tiles per CTA follow the grid, so K); time shards also start
        # each shard from advanced phases. Both within the main path's bound.
        d0, dl = close_prompts(f"J2 {chan}x{time_}", out.prompt_re, ref.prompt_re, nsat)
        note = f"block 0 max|d prompt_re| {d0!r}, 8 locked channels {dl!r}"
        log(f"[J2] track_bank_sharded K={NUM_K} N={N_1MS} {blocks} blocks on chan {chan} x "
            f"time {time_}: {counts['bank_rows']} rows launches ({chan * time_} per block); "
            f"vs track_bank {note}")
    del out, ref

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1000)
    noisy_re, noisy_im, _ = mixed_blocks(system, num_blocks_lock, NOISE_STD, gen)
    reset_counts()
    _, out = track_bank_sharded(config, codes, bank_states(system, init_errors=False),
                                noisy_re, noisy_im, mesh=meshes["2x2"])
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(bank_rows=4 * num_blocks_lock), f"J2 lock run launches {counts}")
    note_loop("parallel", 2 * num_blocks_lock)      # one closure per channel shard and block
    launches += counts["bank_rows"]
    del noisy_re, noisy_im
    dop = out.carrier_doppler[-50:, :nsat].double().mean(0).cpu().numpy()
    mag = torch.hypot(out.prompt_re[-50:, :nsat], out.prompt_im[-50:, :nsat])
    mag = mag.double().mean(0).cpu().numpy()
    dop_err = np.abs(dop - SAT_DOPPLERS)
    log(f"[J2 lock] 2x2, {num_blocks_lock} blocks at 50 dB-Hz: Doppler errors (last 50) "
        f"{dop_err.tolist()} Hz, mean |prompt| {mag.tolist()}")
    check(bool(np.all(dop_err < 5.0)), f"J2 Doppler within 5 Hz: {dop_err.tolist()}")
    check(bool(np.all(mag > N_1MS / 2)), f"J2 |prompt| > N/2: {mag.tolist()}")
    del out

    states = bank_states(system, init_errors=False)
    times = {"unsharded": block_time(
        f"rows K={NUM_K} unsharded", lambda: track_bank(config, codes, states, sre[:10],
                                                        sim[:10]), NUM_K, card)}
    for key, mesh in meshes.items():
        times[key] = block_time(
            f"rows K={NUM_K} mesh {key}",
            lambda: track_bank_sharded(config, codes, states, sre[:10], sim[:10], mesh=mesh),
            NUM_K, card)
        times[key]["launches_per_block"] = mesh.size
    return launches, times


def sharded_array_path(system, card, blocks: int = 20):
    """J3: the K=1024 A=4 L=7 bank through `bank_comp` on 2 x 2 against
    unsharded `track_bank` with no steering weights (the JAX sharded bank
    takes none: both sum the antennas uniformly)."""
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    sre, sim, fs = mixed_blocks(system, blocks, num_ants=NUM_ANTS)
    codes = torch.as_tensor(system.codes, device=DEVICE)
    config = TrackConfig.for_system(system, fs, N_1MS, num_correlators=7,
                                    algorithm="pallas_bank_auto")
    states = bank_states(system, init_errors=True, num_taps=7)
    mesh = channel_time_mesh(2, 2, devices=mesh_devices(4))
    _, ref = track_bank(config, codes, states, sre, sim)
    reset_counts()
    _, out = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(bank_comp=4 * blocks), f"J3: one comp launch per shard and block, "
          f"got {counts}")
    check(out.accum_re.shape == (blocks, NUM_K, NUM_ANTS, 7), "J3 accum shape")
    d0, dl = close_prompts("J3 2x2", out.prompt_re, ref.prompt_re, len(SAT_DOPPLERS))
    log(f"[J3] track_bank_sharded K={NUM_K} A={NUM_ANTS} L=7 N={N_1MS} {blocks} blocks on "
        f"2x2: {counts['bank_comp']} comp launches (4 per block); vs track_bank block 0 "
        f"max|d prompt_re| {d0!r}, 8 locked channels {dl!r}")
    del out, ref
    states = bank_states(system, init_errors=False, num_taps=7)
    times = {"unsharded": block_time(
        f"array K={NUM_K} A={NUM_ANTS} L=7 unsharded",
        lambda: track_bank(config, codes, states, sre[:10], sim[:10]), NUM_K, card),
        "2x2": block_time(
        f"array K={NUM_K} A={NUM_ANTS} L=7 mesh 2x2",
        lambda: track_bank_sharded(config, codes, states, sre[:10], sim[:10], mesh=mesh),
        NUM_K, card)}
    times["2x2"]["launches_per_block"] = 4
    return counts["bank_comp"], times


def sharded_dual_path(sre_l5, sim_l5, l5_offsets, card, blocks: int = 20):
    """J4: the K=64 GPS L5 dual bank at 32.768 MHz on chan 2 against
    `track_bank_dual` (path B's aligned tracking blocks and states)."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5
    from gpuacceleratedtracking_tpu_torch.parallel import (
        channel_time_mesh, track_bank_dual_sharded)
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, track_bank_dual)

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    codes_i = torch.as_tensor(sys_i.codes, device=DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=DEVICE)
    config = dual_config(TrackConfig.for_system(sys_i, L1_FS, N_1MS, algorithm="pallas_bank_auto",
                                                use_secondary=False))
    states = dual_states(l5_offsets, L5_DOPPLERS)
    sre, sim = sre_l5[:blocks], sim_l5[:blocks]
    mesh = channel_time_mesh(2, 1, devices=mesh_devices(2))
    final_u, ref = track_bank_dual(config, codes_i, codes_q, states, sre, sim)
    reset_counts()
    final_s, out = track_bank_dual_sharded(config, codes_i, codes_q, states, sre, sim, mesh=mesh)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(bank_transition=2 * blocks),
          f"J4: one transition launch per channel shard and block, got {counts}")
    note_loop("parallel", 2 * blocks, dual=True)     # one dual closure per channel shard and block
    d_p = within("J4 pilot prompt_re", out.pilot.prompt_re, ref.pilot.prompt_re, 1e-2, 1e-5)
    d_d = within("J4 data prompt_re", out.data_prompt_re, ref.data_prompt_re, 1e-2, 1e-5)
    d_c = within("J4 code phase", final_s.code_phase, final_u.code_phase, 1e-4, 0.0)
    log(f"[J4] track_bank_dual_sharded K={DUAL_K} N={N_1MS} {blocks} blocks on chan 2: "
        f"{counts['bank_transition']} transition launches (2 per block, {DUAL_K} bank "
        f"channels each); vs track_bank_dual max|d pilot prompt| {d_p!r}, data {d_d!r}, "
        f"code phase {d_c!r}")
    times = {"unsharded": block_time(
        f"L5 dual K={DUAL_K} unsharded",
        lambda: track_bank_dual(config, codes_i, codes_q, states, sre[:10], sim[:10]),
        DUAL_K, card),
        "chan2": block_time(
        f"L5 dual K={DUAL_K} mesh chan 2",
        lambda: track_bank_dual_sharded(config, codes_i, codes_q, states, sre[:10], sim[:10],
                                        mesh=mesh), DUAL_K, card)}
    times["chan2"]["launches_per_block"] = 2
    return counts["bank_transition"], times


def sharded_correlate_path():
    """J5: `correlate_sharded` through `pallas_taps` and `pallas_fused` at
    N=2^18 A=4 L=7 over ant 4 x time 2 and N=2^17 A=1 L=3 over time 8,
    against the unsharded kernel call, at the JAX package's large-block
    tolerance (tests/test_parallel.py:104-121)."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL1
    from gpuacceleratedtracking_tpu_torch.ops import channel_kernels
    from gpuacceleratedtracking_tpu_torch.parallel import correlate_sharded, make_mesh

    system = GPSL1()
    launches = {"taps": 0, "fused": 0, "replica": 0}
    for n, a, taps, axes in ((N_WIDE, NUM_ANTS, 7, {"ant": 4, "time": 2}),
                             (1 << 17, 1, 3, {"time": 8})):
        args = channel_args("GPSL1", n, a, taps, 4, -2200.0, 0.7, 311.25)
        mesh = make_mesh(axes, devices=mesh_devices(8))
        for kind in ("taps", "fused"):
            want = getattr(channel_kernels, f"correlate_pallas_{kind}")(*args)
            torch.cuda.synchronize()
            reset_counts()
            got = correlate_sharded(*args, mesh=mesh, algorithm=f"pallas_{kind}",
                                    nominal_code_frequency=system.code_frequency,
                                    ant_axis="ant" if "ant" in axes else None)
            torch.cuda.synchronize()
            counts = read_counts()
            expected = {kind: 8, "replica": 8} if kind == "taps" else {kind: 8}
            check(counts == only(**expected), f"J5 {kind} {axes}: 8 launches, got {counts}")
            for name in expected:
                launches[name] += counts[name]
            err = 0.0
            for g, w in zip(got, want):
                check(g.shape == w.shape and bool(torch.isfinite(g).all()), f"J5 {kind} shape")
                err = max(err, within(f"J5 {kind} N={n} {axes}", g, w, 5.0, 2e-3))
            log(f"[J5] correlate_sharded {kind} N={n} A={a} L={taps} over {axes}: 8 launches; "
                f"vs the unsharded call max|d| {err!r}")
    return launches


def sharded_onehot_path(system, blocks: int = 10, k: int = 64, n: int = 8192):
    """J6: `track_bank_sharded` on `pallas_bank_onehot` at K=64, N=8192 on
    2 x 2, 3 satellites tracked, against unsharded `track_bank`."""
    from gpuacceleratedtracking_tpu_torch.models import gen_signal_mixed, soa
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, init_state, track_bank

    dops = np.linspace(-4000.0, 4000.0, k)
    dops[:3] = [-900.0, 100.0, 1500.0]
    sig, fs = gen_signal_mixed(system, [0, 1, 2], dops[:3], n * blocks,
                               duration=blocks * 1e-3, device=DEVICE)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    codes = torch.as_tensor(system.codes, device=DEVICE)
    states = init_state(np.arange(k) % 32, carrier_doppler=dops, device=DEVICE)
    config = TrackConfig.for_system(system, fs, n, algorithm="pallas_bank_onehot")
    _, ref = track_bank(config, codes, states, sre, sim)
    reset_counts()
    _, out = track_bank_sharded(config, codes, states, sre, sim,
                                mesh=channel_time_mesh(2, 2, devices=mesh_devices(4)))
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(bank_onehot=4 * blocks), f"J6: one onehot launch per shard and "
          f"block, got {counts}")
    d0, dl = close_prompts("J6 2x2", out.prompt_re, ref.prompt_re, 3, atol=10.0)
    log(f"[J6] track_bank_sharded K={k} N={n} {blocks} blocks via pallas_bank_onehot on 2x2: "
        f"{counts['bank_onehot']} launches; vs track_bank block 0 max|d prompt_re| {d0!r}, 3 "
        f"locked channels {dl!r}")
    return counts["bank_onehot"]


def parallel_path(system, seed, sre, sim, sre_l5, sim_l5, l5_offsets, card):
    """Phase J, the distributed layer: each leg with the counts set to 0 just
    before it and read just after. Returns each kernel's launches in all legs,
    the largest kernel-vs-plain errors at the shard-local shapes, and the
    block times."""
    devices = mesh_devices(8)
    log(f"[J] mesh devices {sorted({str(d) for d in devices})}: "
        + ("distinct cards" if torch.cuda.device_count() >= 2
           else "one card, repeated (no cross-device copy runs)"))
    errs = shard_cells(seed)
    launches = dict.fromkeys(counters(), 0)
    for kernel, count in dryrun_leg().items():
        launches[kernel] += count
    count, times = sharded_bank_path(system, seed, sre, sim, card)
    launches["bank_rows"] += count
    count, times_a = sharded_array_path(system, card)
    launches["bank_comp"] += count
    count, times_l5 = sharded_dual_path(sre_l5, sim_l5, l5_offsets, card)
    launches["bank_transition"] += count
    for kernel, count in sharded_correlate_path().items():
        launches[kernel] += count
    launches["bank_onehot"] += sharded_onehot_path(system)
    check(all(launches.values()), f"phase J launched every kernel: {launches}")
    return launches, errs, {"rows_K1024": times, "array_K1024_A4_L7": times_a,
                            "l5_dual_K64": times_l5,
                            "cards": torch.cuda.device_count()}


def figures_path(fig_dir, sweep_dir, track_records, card):
    """Phase K, the figure layer: the kernel sweep's records (phase C's
    `kernel_sweep/`) and the `run_track_benchmark` records of phases D and E
    as the frames of `plot_kernel_benchmarks` and `plot_track_benchmark`.
    The track records are written beside the figures, one JSON file each as
    `run_sweep` writes them. Where matplotlib is installed, both figures are
    drawn and must exceed 10 KB; where it is not, that is said and the
    frames stay on disk for `python -m gpuacceleratedtracking_tpu_torch.bench.plots`."""
    import importlib.util

    from gpuacceleratedtracking_tpu_torch.bench import collect_results, plots, savename

    track_dir = fig_dir / "track_records"
    track_dir.mkdir(parents=True, exist_ok=True)
    for record in track_records:
        config = {k: record[k] for k in ("GNSS", "num_samples", "num_channels", "algorithm")}
        (track_dir / savename("TrackBenchmark", config)).write_text(json.dumps(record, indent=1))
    kernel_df, track_df = collect_results(sweep_dir), collect_results(track_dir)
    panels = kernel_df.groupby(["GNSS", "num_ants", "num_correlators"]).ngroups
    check(len(kernel_df) == 192 and panels == 8, f"kernel frame: {len(kernel_df)} rows, "
          f"{panels} panels (192, 8)")
    check(len(track_df) == len(track_records) and bool(np.isfinite(track_df.Median).all()),
          f"track frame: {len(track_df)} finite rows")
    result = {"kernel_rows": len(kernel_df), "track_rows": len(track_df),
              "dir": str(fig_dir)}
    if importlib.util.find_spec("matplotlib") is None:
        log(f"[K] matplotlib is not installed here: no figure drawn; the frames are in "
            f"{sweep_dir} and {track_dir} ({len(kernel_df)} kernel and {len(track_df)} track "
            "records) for `python -m gpuacceleratedtracking_tpu_torch.bench.plots`")
        return dict(result, drawn=False)
    paths = [plots.plot_kernel_benchmarks(kernel_df, str(fig_dir / "kernel_benchmarks.png"),
                                          title=f"port on {card}"),
             plots.plot_track_benchmark(track_df, str(fig_dir / "track_benchmarks.png"))]
    sizes = {pathlib.Path(p).name: pathlib.Path(p).stat().st_size for p in paths}
    check(all(size > 10_000 for size in sizes.values()), f"figures over 10 KB: {sizes}")
    log(f"[K] drew {sizes} into {fig_dir}")
    return dict(result, drawn=True, sizes=sizes)


# --- The scripts layer (phases S and P): the port's entry points.

# The keys the JAX harness adds to a record's configuration, by runner (less
# jax_version; the JAX launch shapes of a TPU bank record have no
# counterpart): tests/test_torch_scripts.py holds them to the JAX runners.
_STATS_KEYS = ("Maximum", "Mean", "Median", "Minimum", "Std", "times", "backend",
               "cpu_model", "device_kind", "git_sha", "os")
JAX_RECORD_KEYS = {
    "kernel": _STATS_KEYS + ("realtime_ratio", "reps_mode", "reps_resolved", "samples_per_s"),
    "track": _STATS_KEYS + ("realtime_channels", "realtime_ratio", "samples_per_s"),
    "dual": _STATS_KEYS + ("bank_channels", "realtime_channels", "realtime_ratio",
                           "samples_per_s"),
    "acquire": _STATS_KEYS + ("algorithm", "fft_mode", "num_bins"),
    "reduction": _STATS_KEYS,
    "replica": _STATS_KEYS,
}


def first_cell(grid: dict) -> dict:
    """A sweep dict cut to one configuration: the first value of each list."""
    return {k: (v[0] if isinstance(v, (list, tuple)) else v) for k, v in grid.items()}


def analog_sweeps() -> list:
    """Every `run_sweep` call of the port's sweep analogs, as the analogs make
    it: (name, dict, runner, prefix, record kind), the card's acquisition
    sweep included (``processor="GPU"``, the analog's default)."""
    from gpuacceleratedtracking_tpu_torch.bench import (
        run_acquire_benchmark, run_dual_track_benchmark, run_kernel_benchmark,
        run_reduction_benchmark, run_replica_benchmark)
    from gpuacceleratedtracking_tpu_torch.scripts import (
        benchmark_reduction, benchmark_replica, run_benchmarks_acquire, run_benchmarks_gpsl1,
        run_benchmarks_gpsl5, run_benchmarks_track)

    sweeps = []
    for module in (run_benchmarks_gpsl1, run_benchmarks_gpsl5):
        for name in ("params", "cpu_params"):
            sweeps.append((f"{module.__name__.rsplit('.', 1)[1]}.{name}", getattr(module, name),
                           run_kernel_benchmark, "KernelBenchmark", "kernel"))
    for i, (grid, runner, prefix) in enumerate(run_benchmarks_track.SWEEPS):
        kind = "dual" if runner is run_dual_track_benchmark else "track"
        sweeps.append((f"run_benchmarks_track.SWEEPS[{i}]", grid, runner, prefix, kind))
    for i, grid in enumerate(run_benchmarks_acquire.SWEEPS):
        sweeps.append((f"run_benchmarks_acquire.SWEEPS[{i}]", dict(grid, processor="GPU"),
                       run_acquire_benchmark, "AcquireBenchmark", "acquire"))
    sweeps.append(("benchmark_reduction.params", benchmark_reduction.params,
                   run_reduction_benchmark, "ReductionBenchmark", "reduction"))
    sweeps.append(("benchmark_replica.params", benchmark_replica.params,
                   run_replica_benchmark, "ReplicaBenchmark", "replica"))
    return sweeps


def scripts_path(card):
    """Phase S: each sweep analog's `run_sweep` call on one cell of each of its
    dicts (the first value of each list), into a temporary directory: each
    record exists under its savename, has no ``error``, ran where its dict
    says (``backend`` "cuda", "cpu" for ``cpu_params``) and has the JAX
    record's keys. Returns the kernels' launches over the phase."""
    import tempfile

    from gpuacceleratedtracking_tpu_torch.bench import run_sweep, savename

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for name, grid, runner, prefix, kind in analog_sweeps():
            cell = first_cell(grid)
            t0 = time.perf_counter()
            paths = run_sweep(cell, runner, tmp, prefix=prefix, resume=False, progress=False,
                              skip_errors=False)
            seconds = time.perf_counter() - t0
            check(len(paths) == 1 and paths[0].name == savename(prefix, cell)
                  and paths[0].exists(), f"[S] {name}: one record under its savename")
            r = json.loads(paths[0].read_text())
            want = "cpu" if cell["processor"] == "CPU" else "cuda"
            missing = (set(cell) | set(JAX_RECORD_KEYS[kind])) - set(r)
            log(f"[S] {name}: {paths[0].name}: median {r.get('Median', float('nan')) * 1e3!r} ms, "
                f"backend {r.get('backend')}, {r.get('gpu_name')}, {r.get('power_limit')}; "
                f"{seconds!r} s [{card}]")
            check("error" not in r, f"[S] {name}: {r.get('error')}")
            check(r["backend"] == want, f"[S] {name}: backend {r['backend']}, want {want}")
            check(not missing, f"[S] {name}: record lacks the JAX keys {sorted(missing)}")
            check(want == "cpu" or bool(r["gpu_name"] and r["power_limit"]),
                  f"[S] {name}: the record names the card and its power limit")
    torch.cuda.synchronize()
    counts = read_counts()
    note_loop("S")
    note_loop("S", dual=True)
    return counts


def profile_path(system, sre, sim, rows_graph_ms, card, blocks: int = 10):
    """Phase P: (a) the port's `scripts.profile_trace` at its defaults
    (``pallas_bank_auto``, K=1024, N=32768): the trace's ``bank_rows``
    kernels per call must lie within 20 % of their CUDA-graph replay time
    from the timings phase (``rows_graph_ms``), two clocks on one kernel;
    (b) `bench.profile.profile_calls` on 10-block `track_bank` calls through
    the graph path at phase L's K=1024 shape: per-call wall time, device
    busy time and share, the device ops by name and the longest idle gaps
    with the host events in them."""
    import tempfile

    from gpuacceleratedtracking_tpu_torch.bench.profile import profile_calls
    from gpuacceleratedtracking_tpu_torch.scripts import profile_trace
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        summary = profile_trace.run(out_dir=pathlib.Path(tmp))
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(bank_rows=profile_trace.REPS + 1),
          f"[P] profile_trace: one bank_rows launch per call, got {counts}")
    timeline = summary["device_timeline"]
    rows = {name: row for name, row in timeline["rows"].items() if "bank_rows" in name}
    trace_ms = sum(row["total_ms"] for row in rows.values()) / profile_trace.REPS
    log(f"[P] profile_trace pallas_bank_auto K={NUM_K} N={N_1MS}: wall {summary['per_call_ms']!r} "
        f"ms per call, device {timeline['device_per_call_ms']!r} ms per call, busy share "
        f"{timeline['busy_share']!r}; bank_rows kernels {trace_ms!r} ms per call in the trace "
        f"against {rows_graph_ms!r} ms replayed; rows "
        + "; ".join(f"{row['calls']} x {name[:60]} {row['per_call_ms']!r} ms"
                    for name, row in timeline["rows"].items()) + f" [{card}]")
    check(bool(rows) and abs(trace_ms / rows_graph_ms - 1.0) <= 0.2,
          f"[P] bank_rows in the trace ({trace_ms!r} ms) within 20 % of its graph replay "
          f"({rows_graph_ms!r} ms)")

    config = TrackConfig.for_system(system, L1_FS, N_1MS, algorithm="pallas_bank_auto")
    states = bank_states(system, True)
    codes = torch.as_tensor(system.codes, device=DEVICE)
    calls = 5
    reset_counts()
    split = profile_calls(lambda: track_bank(config, codes, states, sre[:blocks], sim[:blocks]),
                          (), calls, f"track_bank_K{NUM_K}_{blocks}_blocks")
    torch.cuda.synchronize()
    counts_b = read_counts()
    note_loop("P")
    line = split["device_timeline"]
    log(f"[P split] track_bank K={NUM_K} N={N_1MS}, {blocks}-block calls through the graph "
        f"path: wall {split['per_call_ms']!r} ms per call ({split['per_call_ms'] / blocks!r} ms "
        f"per block), device busy {line['device_per_call_ms']!r} ms per call, device window "
        f"{line['window_per_call_ms']!r} ms per call, busy share {line['busy_share']!r}; "
        f"launches={counts_b} [{card}]")
    for name, row in line["rows"].items():
        log(f"[P split] device op {name[:100]}: {row['calls']} events, "
            f"{row['total_ms'] / calls!r} ms per call")
    for gap in line["gaps"]:
        hosts = ", ".join(f"{h['name'][:60]} ({h['overlap_ms']!r} ms)" for h in gap["hosts"])
        log(f"[P split] idle gap at {gap['start_ms']!r} ms: {gap['ms']!r} ms; host: {hosts}")
    check(line["busy_share"] is not None and 0.0 < line["busy_share"] <= 1.0,
          f"[P split] busy share {line['busy_share']}")
    check(counts_b["bank_rows"] > 0, "[P split] the bank kernel ran")
    counts["bank_rows"] += counts_b["bank_rows"]
    return counts, {"profile_trace": summary, "trace_bank_rows_ms": trace_ms,
                    "graph_bank_rows_ms": rows_graph_ms, "track_bank_split": split}


# --- The captured block loop (phase L): graph against eager.

# Device ops per block of phase L's paths with the loop closure as ~120 torch
# ops (10-block calls, torch.profiler; PERF.md section 5).
OPS_BEFORE_LOOP_KERNEL = {"rows_K1024_pallas_bank_auto": {"eager": 129.0, "graph": 150.9},
                          "array_K1024_A4_L7_f32": {"graph": 159.1}}
# The same with the loop kernel writing fresh tensors, the graph copying them
# into its stacked outputs and carry (PERF.md section 5).
OPS_FRESH_LOOP_KERNEL = {"rows_K1024_pallas_bank_auto": {"eager": 28.0, "graph": 33.7},
                         "rows_K1024_xla_bank": {"eager": 114.0, "graph": 119.7},
                         "array_K1024_A4_L7_f32": {"eager": 28.0, "graph": 35.3},
                         "array_K1024_A4_L7_bf16": {"eager": 28.0, "graph": 35.3},
                         f"l5_dual_K{DUAL_K}": {"eager": 51.3, "graph": 57.0},
                         "family_GALILEOE1C_K256": {"eager": 28.0, "graph": 33.7},
                         "track_fused": {"eager": 15.0, "graph": 21.7},
                         "mesh_2x2_rows_K1024": {"eager": 150.8, "graph": 156.5},
                         f"mesh_chan2_l5_dual_K{DUAL_K}": {"eager": 105.6, "graph": 117.0}}
# Phase L's paths whose graph writes its outputs and carry through the loop
# kernel's sink (no index_copy_), by the loop kernel's mode; the sharded 2 x 2
# bank gathers its shards inside the block and takes no sink.
SINK_PATHS = {"rows_K1024_pallas_bank_auto": "loop_update", "track_fused": "loop_update",
              f"l5_dual_K{DUAL_K}": "loop_update_dual"}
NO_SINK_PATH = "mesh_2x2_rows_K1024"


def flat(tree) -> list:
    """The tensors of a tracking result (tuples and NamedTuples of tensors)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for child in tree for x in flat(child)]


def bitwise(name, got, want) -> None:
    """Check two tracking results equal bit for bit, leaf by leaf."""
    got, want = flat(got), flat(want)
    check(len(got) == len(want), f"{name}: {len(got)} leaves against {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype and bool(torch.equal(g, w)),
              f"{name}: leaf {i} differs between the graph and the eager loop")


def busy_share(run, calls=3):
    """The device's busy share over calls of ``run``: torch.profiler's summed
    device time per call over the CUDA-event wall time per call; and the
    device ops per call by name."""
    ops, device_ms, names = device_profile(run, calls=calls, by_name=True)
    wall_ms = time_cuda(run, reps=5, warmup=1)[0]
    return {"device_ops_per_call": ops, "device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms, "ops_by_name": names}


def all_counts() -> dict:
    """Every kernel's launch count, the loop kernel's (both modes) included."""
    return dict(read_counts(), loop_update=loop_count(),
                loop_update_dual=dual_counter().launches)


def counted(run):
    """``run()``'s result, and how far it moved each kernel's launch count
    (read after the card has finished), the loop kernel's included."""
    before = all_counts()
    result = run()
    torch.cuda.synchronize()
    after = all_counts()
    return result, {k: after[k] - before[k] for k in after}


def strict(run):
    """``run`` under ``set_sync_debug_mode("error")``: any wait on the card raises."""
    def call():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    return call


def dual_one_graph(config, codes_i, codes_q, states, sre, sim, chan):
    """The sharded L5 dual bank on one card as one CUDA graph for every
    channel shard, the alternative to `track_bank_dual_sharded`'s graph per
    shard: ``chan`` shards' `dual_parts` bodies in one `graphs.scan`, the
    results joined along the channel axis."""
    from gpuacceleratedtracking_tpu_torch.parallel.bank import _channel_shards, _map_state
    from gpuacceleratedtracking_tpu_torch.tracking import TrackOutput, graphs
    from gpuacceleratedtracking_tpu_torch.tracking.dual import DualTrackOutput, dual_parts

    dev = sre.device
    shards = _channel_shards(states, chan, [dev] * chan)
    parts = [dual_parts(config, codes_i, codes_q, st.prn, dev) for st in shards]

    def step(carry, consts, block):
        res = [part[0](carry[c], consts[c], block) for c, part in enumerate(parts)]
        return tuple(r[0] for r in res), tuple(r[1] for r in res)

    finals, outs = graphs.scan(step, tuple(shards), (sre, sim), tuple(p[1] for p in parts),
                               key=("dual_one_graph", config, chan))
    return (_map_state(lambda *xs: torch.cat(xs), *finals),
            DualTrackOutput(TrackOutput(*(torch.cat(xs, 1) for xs in zip(*(o.pilot for o in outs)))),
                            torch.cat([o.data_prompt_re for o in outs], 1),
                            torch.cat([o.data_prompt_im for o in outs], 1)))


def graph_path(system, sre, sim, sre_l5, sim_l5, l5_offsets, card, blocks: int = 10):
    """Phase L, the block loop as one captured program: each path once under
    `tracking.eager()` and once through its CUDA graph (the first call
    captures), every output and the final state equal bit for bit, the
    launch counts moved alike; a second call, a replay of the cached graph,
    under ``set_sync_debug_mode("error")``, equal again and with the same
    counts; the device memory each capture took; then eager and graph block
    times and real-time channels, the one-card sharded L5 dual bank as one
    graph against a graph per shard, and the device's busy share. Returns
    the launches of the comparison runs, read after each run, and the
    results."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5, get_system
    from gpuacceleratedtracking_tpu_torch.parallel import (
        channel_time_mesh, track_bank_dual_sharded, track_bank_sharded)
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, eager, graphs, init_state, track, track_bank,
        track_bank_dual)

    codes = torch.as_tensor(system.codes, device=DEVICE)
    sre, sim = sre[:blocks], sim[:blocks]
    are, aim, _ = mixed_blocks(system, blocks, num_ants=NUM_ANTS)
    phase = ANT_PHASE * torch.arange(NUM_ANTS, dtype=torch.float32, device=DEVICE)
    weights = (torch.cos(phase), torch.sin(phase))    # on the card: a call copies no host value
    nsat = len(SAT_DOPPLERS)

    def bank(algo, **extra):
        return TrackConfig.for_system(system, L1_FS, N_1MS, algorithm=algo, **extra)

    states = bank_states(system, init_errors=False)
    states7 = bank_states(system, init_errors=False, num_taps=7)
    sats = init_state(np.arange(nsat), carrier_doppler=SAT_DOPPLERS + 20.0,
                      code_phase=SAT_CODE_PHASES - 0.2, device=DEVICE)
    one = init_state(5, carrier_doppler=float(SAT_DOPPLERS[5]) + 20.0,
                     code_phase=float(SAT_CODE_PHASES[5]) - 0.2, device=DEVICE)
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    codes_i = torch.as_tensor(sys_i.codes, device=DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=DEVICE)
    cfg5 = dual_config(TrackConfig.for_system(sys_i, L1_FS, N_1MS, algorithm="pallas_bank_auto",
                                              use_secondary=False))
    states5 = dual_states(l5_offsets, L5_DOPPLERS)
    s5re, s5im = sre_l5[:blocks], sim_l5[:blocks]
    e1 = get_system("GALILEOE1C")
    e1_codes = torch.as_tensor(e1.codes, device=DEVICE)
    e1re, e1im, e1_states = family_blocks(e1, blocks)
    mesh22 = channel_time_mesh(2, 2, devices=mesh_devices(4))
    mesh2 = channel_time_mesh(2, 1, devices=mesh_devices(2))
    auto = bank("pallas_bank_auto")
    # name -> (run, real-time channels of a timed path, or None)
    paths = {
        "rows_K1024_pallas_bank_auto": (
            lambda: track_bank(auto, codes, states, sre, sim), NUM_K),
        "rows_K1024_xla_bank": (
            lambda: track_bank(bank("xla_bank"), codes, states, sre, sim), NUM_K),
        "array_K1024_A4_L7_f32": (
            lambda: track_bank(bank("pallas_bank_auto", num_correlators=7), codes, states7,
                               are, aim, ant_weights=weights), NUM_K),
        "array_K1024_A4_L7_bf16": (
            lambda: track_bank(bank("pallas_bank_auto", num_correlators=7, z_dtype="bf16"),
                               codes, states7, are, aim, ant_weights=weights), NUM_K),
        f"l5_dual_K{DUAL_K}": (
            lambda: track_bank_dual(cfg5, codes_i, codes_q, states5, s5re, s5im), DUAL_K),
        f"family_GALILEOE1C_K{FAMILY_K}": (
            lambda: track_bank(family_config(e1, N_1MS), e1_codes, e1_states, e1re, e1im),
            None),
        "fused_K8": (lambda: track_bank(bank("pallas_fused"), codes, sats, sre, sim), None),
        "taps_K8": (lambda: track_bank(bank("pallas_taps"), codes, sats, sre, sim), None),
        "track_fused": (lambda: track(bank("pallas_fused"), codes, one, sre, sim), None),
        "onehot_K1024": (
            lambda: track_bank(bank("pallas_bank_onehot"), codes, states, sre, sim), None),
        "mesh_2x2_rows_K1024": (
            lambda: track_bank_sharded(auto, codes, states, sre, sim, mesh=mesh22), NUM_K),
        f"mesh_chan2_l5_dual_K{DUAL_K}": (
            lambda: track_bank_dual_sharded(cfg5, codes_i, codes_q, states5, s5re, s5im,
                                            mesh=mesh2), DUAL_K),
    }
    torch.cuda.synchronize()
    results, launches = {}, dict.fromkeys(all_counts(), 0)
    dev = torch.device(DEVICE, torch.cuda.current_device())
    for name, (run, _) in paths.items():
        with eager():
            want, eager_counts = counted(run)
        # From an empty cache, so that the first call captures and no entry
        # is evicted (and its memory returned) while it runs.
        graphs.clear()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        got, graph_counts = counted(run)              # the capture, then the replays
        reserved = torch.cuda.memory_reserved() - reserved
        new = list(graphs._ENTRIES.get(dev, {}).values())
        buffers = sum(x.numel() * x.element_size() for e in new
                      for x in graphs._leaves((e.carry, e.consts, tuple(e.xs), tuple(e.outs))))
        check(graph_counts == eager_counts,
              f"[L] {name}: graph launches {graph_counts} against eager {eager_counts}")
        bitwise(f"[L] {name}", got, want)
        again, again_counts = counted(strict(run))    # a replay of the cached graph
        check(again_counts == eager_counts,
              f"[L] {name}: second call's launches {again_counts} against eager {eager_counts}")
        bitwise(f"[L] {name} second call", again, want)
        if name in SINK_PATHS:
            check(graph_counts[SINK_PATHS[name]] == blocks,
                  f"[L] {name}: the loop kernel once per block ({graph_counts})")
        for k in launches:
            launches[k] += eager_counts[k] + graph_counts[k] + again_counts[k]
        results[name] = {"launches_per_call": {k: v for k, v in graph_counts.items() if v},
                         "entries": len(new), "chunk": [e.chunk for e in new],
                         "entry_buffer_bytes": buffers, "capture_reserved_bytes": reserved}
        log(f"[L] {name}: {blocks} blocks, graph equals eager bit for bit "
            f"({len(flat(got))} tensors), launches per call {results[name]['launches_per_call']} "
            f"in all three calls; the second call (a replay of the cached graph) ran under "
            f"set_sync_debug_mode('error'); {len(new)} entries, chunk "
            f"{results[name]['chunk']}, their buffers {buffers} B, device memory reserved by "
            f"the first call (buffers, graph pools, results) {reserved} B")
        del want, got, again

    for name, (run, channels) in paths.items():
        if channels is None:
            continue
        with eager():
            e_med, e_min = time_cuda(run, warmup=1)
        g_med, g_min = time_cuda(run, warmup=1)
        entry = results[name]
        entry.update(eager_block_ms=e_med / blocks, eager_block_min_ms=e_min / blocks,
                     graph_block_ms=g_med / blocks, graph_block_min_ms=g_min / blocks,
                     eager_realtime_channels=channels * blocks / e_med,
                     graph_realtime_channels=channels * blocks / g_med)
        log(f"[L time] {name}: block eager {entry['eager_block_ms']!r} ms (min "
            f"{entry['eager_block_min_ms']!r}), graph {entry['graph_block_ms']!r} ms (min "
            f"{entry['graph_block_min_ms']!r}); real-time channels eager "
            f"{entry['eager_realtime_channels']!r}, graph {entry['graph_realtime_channels']!r} "
            f"[{card}]")
    # Device ops per block of every path, eager and graph: torch.profiler over
    # two calls after a warm-up call, per call over the blocks of a call (the
    # graph's per-call copies in and out included).
    for name, (run, _) in paths.items():
        g_ops, g_ms = device_profile(run, calls=2)
        with eager():
            e_ops, e_ms = device_profile(run, calls=2)
        entry = results[name]
        entry.update(eager_device_ops_per_block=e_ops / blocks,
                     graph_device_ops_per_block=g_ops / blocks,
                     eager_device_ms_per_block=e_ms / blocks,
                     graph_device_ms_per_block=g_ms / blocks)
        before = OPS_BEFORE_LOOP_KERNEL.get(name, {})
        fresh = OPS_FRESH_LOOP_KERNEL.get(name, {})
        log(f"[L ops] {name}: device ops per block eager {e_ops / blocks!r}, graph "
            f"{g_ops / blocks!r} (with the loop kernel writing fresh tensors: eager "
            f"{fresh.get('eager', 'not recorded')}, graph {fresh.get('graph', 'not recorded')}; "
            f"with the loop closure as torch ops: eager "
            f"{before.get('eager', 'not recorded')}, graph {before.get('graph', 'not recorded')}); "
            f"device ms per block eager {e_ms / blocks!r}, graph {g_ms / blocks!r} [{card}]")
    # The replayed block's device ops by name where the loop kernel writes
    # through the sink, against the sharded bank's graph, which copies its
    # outputs with index_copy_.
    for name in (*SINK_PATHS, NO_SINK_PATH):
        _, g_ms, names = device_profile(paths[name][0], calls=2, by_name=True)
        copies = sum("index_copy" in op for op in device_op_names(paths[name][0]))
        results[name].update(graph_ops_by_name=names, graph_index_copies_per_block=copies / blocks)
        log(f"[L sink] {name} graph, device ops per call by name (count, ms): "
            + "; ".join(f"{op} {count!r} {ms!r}" for op, (count, ms) in names.items())
            + f"; index_copy ops per block {copies / blocks!r} [{card}]")
        if name == NO_SINK_PATH:
            check(copies > 0, f"[L sink] {name}: the no-sink graph's index_copy_ shows by name")
        else:
            check(copies == 0, f"[L sink] {name}: no index_copy_ in the replayed block")
    # The one-card sharded dual bank: a graph per shard (the library's path)
    # against one graph for every shard, in turns.
    for chan in (2, 4):
        mesh = channel_time_mesh(chan, 1, devices=mesh_devices(chan))
        per_shard = lambda: track_bank_dual_sharded(cfg5, codes_i, codes_q, states5, s5re,
                                                    s5im, mesh=mesh)
        fork = lambda: dual_one_graph(cfg5, codes_i, codes_q, states5, s5re, s5im, chan)
        bitwise(f"[L] dual chan {chan}: one graph against a graph per shard", fork(),
                per_shard())
        f1, p1, p2, f2 = (time_cuda(fn, warmup=1) for fn in (fork, per_shard, per_shard, fork))
        one = statistics.median([f1[0], f2[0]]) / blocks
        each = statistics.median([p1[0], p2[0]]) / blocks
        results.setdefault(f"mesh_chan{chan}_l5_dual_K{DUAL_K}", {}).update(
            one_graph_block_ms=one, one_graph_block_min_ms=min(f1[1], f2[1]) / blocks,
            graph_per_shard_block_ms=each, graph_per_shard_block_min_ms=min(p1[1], p2[1]) / blocks)
        log(f"[L time] L5 dual K={DUAL_K} chan {chan} on one card: one graph {one!r} ms per block "
            f"(min {min(f1[1], f2[1]) / blocks!r}), a graph per shard {each!r} ms (min "
            f"{min(p1[1], p2[1]) / blocks!r}), in turns one, per shard, per shard, one [{card}]")
    for name in ("rows_K1024_pallas_bank_auto", "array_K1024_A4_L7_f32"):
        run = paths[name][0]
        graph = busy_share(run)
        with eager():
            eager_share = busy_share(run)
        results[name].update(busy_graph=graph, busy_eager=eager_share)
        log(f"[L busy] {name}, {blocks} blocks per call: graph {graph['busy_share']!r} "
            f"({graph['device_ms']!r} ms of device time in {graph['wall_ms']!r} ms, "
            f"{graph['device_ops_per_call']!r} device ops per call); eager "
            f"{eager_share['busy_share']!r} ({eager_share['device_ms']!r} ms in "
            f"{eager_share['wall_ms']!r} ms, {eager_share['device_ops_per_call']!r} ops) [{card}]")
        for mode, share in (("graph", graph), ("eager", eager_share)):
            log(f"[L busy] {name} {mode}, device ops per call by name (count, ms): "
                + "; ".join(f"{op} {count!r} {ms!r}"
                            for op, (count, ms) in share["ops_by_name"].items()))
    return launches, results


def ptxas_summary(log_path):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    its name and template arguments, registers, and spills."""
    if not log_path.exists():
        return []
    lines, kernel = [], None
    for line in log_path.read_text().splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d+"
                          r"((?:bank_[a-z_]+?|taps_|fused_|replica_|loop_update_)(?:kernel|finish))"
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


def device_profile(fn, calls=10, by_name=False):
    """Device ops (kernels, copies, memsets) per call of ``fn`` and their
    summed device milliseconds per call, from torch.profiler over ``calls``
    calls after a warm-up call; with ``by_name``, also per op name its count
    and device milliseconds per call, the costliest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    result = (len(ops) / calls, sum(e.time_range.elapsed_us() for e in ops) / 1e3 / calls)
    if not by_name:
        return result
    names: dict = {}
    for e in ops:
        count, us = names.get(e.name, (0, 0.0))
        names[e.name] = (count + 1, us + e.time_range.elapsed_us())
    short: dict = {}
    for name, (count, us) in names.items():       # names cut to 80 characters, merged
        c0, u0 = short.get(name[:80], (0, 0.0))
        short[name[:80]] = (c0 + count, u0 + us)
    ranked = sorted(short.items(), key=lambda item: -item[1][1])
    return result + ({name: (count / calls, us / 1e3 / calls) for name, (count, us) in ranked},)


def device_op_names(fn) -> list:
    """The full names of the device ops of one call of ``fn`` (after a
    warm-up call), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


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


def loop_bound(state, accum, sink: bool, dual: bool = False):
    """`bound` of a loop kernel call without overlay (``dual``: of its dual
    mode, ``accum`` the 2K-channel bank's): every state leaf and the
    accumulators read once; written once: fresh, every new state leaf (12
    per channel, the [K, L] window sums, the [K, W] ring buffers) and the
    outputs of their own (prompt, errors, C/N0: 5 per channel; dual: also
    the pilot's [K, L] accumulators and 2 data prompts); under a sink, the
    state's 12 leaves per channel, the window sums and the one ring slot it
    changes, and every output leaf (9 per channel and the [K, L]
    accumulators; dual: 11). Its f32 operations, an upper count per channel
    (wipe and antenna sums, discriminators, filters, NCO, C/N0), are ~50x
    below."""
    k, taps = state.prn.numel(), accum.shape[-1]
    window = state.cn0.prompts_re.shape[-1]
    a = accum.numel() // ((2 if dual else 1) * k * taps)
    leaves = [x for x in flat(state) if x is not state.prn]
    flops = k * (8 * window + 10 * a * taps + 80)
    data = 2 if dual else 0
    if sink:
        out = 12 + 2 * taps + 2 + 9 + data + 2 * a * taps
    else:
        out = 12 + 2 * taps + 2 * window + 5 + data + (2 * a * taps if dual else 0)
    return bound(flops, "f32", accum, accum, *leaves, out_elems=k * out)


def library_matmul(name, rows, samples, cols, card, seed):
    """The library yardstick of a correlator that contracts ``samples``
    samples of ``rows`` replica rows against ``cols`` signal columns: one
    ``torch.matmul`` of a built ``[rows, samples]`` complex64 plane (the
    conj(carrier) x code rows of a bank, or the wiped ``[L, N]`` replica of
    one channel) against ``[samples, cols]`` complex64 signal planes (a
    bank's L shifted copies of each antenna, or one channel's A antennas),
    TF32 off. The planes are built outside the timed region; device time
    from a CUDA graph replay."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    z = torch.randn((rows, samples), dtype=torch.complex64, generator=gen, device=DEVICE)
    x = torch.randn((samples, cols), dtype=torch.complex64, generator=gen, device=DEVICE)
    med, mn = graph_ms(lambda: torch.matmul(z, x))
    log(f"[time] {name} library yardstick: torch.matmul [{rows}, {samples}] x [{samples}, "
        f"{cols}] complex64 (TF32 off), device time (CUDA graph) median {med!r} ms (min "
        f"{mn!r}) [{card}]")
    return {"library_ms": med, "library_min_ms": mn}


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
    from gpuacceleratedtracking_tpu_torch.models import (
        GPSL5, EPLCorrelator, correlator_sample_shifts, gpsl5)
    from gpuacceleratedtracking_tpu_torch.ops import (
        bank_comp, channel_kernels, epl_kernels, replica_kernel)
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, loop_update, track_bank, track_bank_dual)
    from gpuacceleratedtracking_tpu_torch.tracking.dual import dual_update, dual_update_plain
    from gpuacceleratedtracking_tpu_torch.tracking.track import loop_update_plain

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
        res.update(library_matmul(f"bank_rows K={NUM_K} N={n}", NUM_K, n,
                                  len(case["sample_shifts"]), card, seed))
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
    results["bank_transition"].update(library_matmul(
        f"bank_transition K={2 * DUAL_K} N={N_1MS}", 2 * DUAL_K, N_1MS,
        len(case["sample_shifts"]), card, seed))
    del case, prepared

    # The per-channel kernels alone at the sweep's corners, and the one-hot
    # route at K=1024. The plain versions of taps and fused take no host copy,
    # so their device time is read from a CUDA graph too.
    for n in (N_1MS, N_WIDE):
        for a, taps in ((1, 3), (NUM_ANTS, 7)):
            args = channel_args("GPSL1", n, a, taps, 0, 1500.0, 0.3, 17.5)
            library = library_matmul(f"per-channel N={n} A={a} L={taps}", taps, n, a, card,
                                     seed)
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
                ops = device_profile(lambda: wrapper(*args))[0]
                res.update(wrapper_ms=w[0], wrapper_min_ms=w[1], device_ops_per_call=ops,
                           **library)
                log(f"[time] {kind} N={n} A={a} L={taps}: wrapper call incl. per-call "
                    f"set-up median {w[0]!r} ms (min {w[1]!r}); {ops!r} device ops per "
                    f"wrapper call (torch.profiler) [{card}]")
                results[f"{kind}_n{n}_a{a}_l{taps}"] = res
    del args, call

    # The replica kernel at the taps kernel's two corners: its [L, N] tap
    # matrix for one channel, against the plain replica ops (device time
    # from a CUDA graph, both). No single PyTorch call computes it.
    for n, taps in ((N_1MS, 3), (N_WIDE, 7)):
        fs = n / 1e-3
        shifts = tuple(int(s) for s in correlator_sample_shifts(system, EPLCorrelator(taps), fs))
        codes = torch.as_tensor(system.codes, device=DEVICE)
        rargs = (codes, torch.tensor(3, dtype=torch.int32, device=DEVICE),
                 torch.tensor(system.code_frequency, dtype=torch.float32, device=DEVICE), fs,
                 torch.tensor(17.5, dtype=torch.float32, device=DEVICE), n, shifts,
                 system.code_length)
        res = kernel_vs_plain(f"replica N={n} L={taps}",
                              lambda: replica_kernel.code_tap_matrix(*rargs),
                              lambda: replica_kernel.tap_matrix_plain(*rargs), card,
                              samples=n, graphs=True)
        # Bytes: the [L, N] f32 write and the PRN's code column read once.
        res.update(bound(0, "f32", codes[:, 0], out_elems=taps * n), library_ms=None)
        results[f"replica_n{n}_l{taps}"] = res
    del codes, rargs

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
    results["bank_onehot"].update(library_matmul(
        f"bank_onehot K={NUM_K} N={N_1MS}", NUM_K, N_1MS, len(case["sample_shifts"]), card,
        seed))
    del case, prepared

    codes = torch.as_tensor(system.codes, device=DEVICE)
    fs = N_1MS / 1e-3
    # The loop-closure kernel at the rows path's shape (K=1024, A=1, L=3, a
    # 20-slot C/N0 window), eager and as device time from a CUDA graph, both
    # for it and for its plain version (~120 torch ops, capturable too):
    # under a sink, as the replayed graph runs it (the outputs into a
    # 64-row stack, the state in place), and fresh, as the eager loop does.
    # Then the dual mode at the L5 dual bank's K=64 the same two ways.
    config = TrackConfig.for_system(system, fs, N_1MS, algorithm="pallas_bank_auto")
    states = bank_states(system, init_errors=False)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    acc = torch.randn((NUM_K, 3), generator=gen, device=DEVICE) * 1000.0
    carry, sink = clone_tree(states), make_sink(loop_update(config, states, acc, acc)[1], 64)
    res = kernel_vs_plain(f"loop_update K={NUM_K} A=1 L=3, sink",
                          lambda: loop_update(config, carry, acc, acc, None, sink),
                          lambda: loop_update_plain(config, carry, acc, acc, None, sink), card,
                          graphs=True)
    res.update(loop_bound(states, acc, sink=True))
    fresh = kernel_vs_plain(f"loop_update K={NUM_K} A=1 L=3, fresh",
                            lambda: loop_update(config, states, acc, acc),
                            lambda: loop_update_plain(config, states, acc, acc), card,
                            graphs=True)
    fresh.update(loop_bound(states, acc, sink=False))
    res["fresh"] = fresh
    results["loop_update"] = res

    sys_i = GPSL5()
    dconfig = dual_config(TrackConfig.for_system(sys_i, fs, N_1MS, algorithm="pallas_bank_auto",
                                                 use_secondary=False))
    dstates = dual_states(l5_offsets, L5_DOPPLERS)
    dacc = torch.randn((2 * DUAL_K, 3), generator=gen, device=DEVICE) * 1000.0
    tables = tuple(torch.tensor(gpsl5.neuman_hofman(pilot), dtype=torch.float32, device=DEVICE)
                   for pilot in (False, True))
    dcarry = clone_tree(dstates)
    dsink = make_sink(dual_update(dconfig, dstates, dacc, dacc, *tables)[1], 64)
    res = kernel_vs_plain(f"loop_update dual mode K={DUAL_K} A=1 L=3, sink",
                          lambda: dual_update(dconfig, dcarry, dacc, dacc, *tables, dsink),
                          lambda: dual_update_plain(dconfig, dcarry, dacc, dacc, *tables, dsink),
                          card, graphs=True)
    res.update(loop_bound(dstates, dacc, sink=True, dual=True))
    fresh = kernel_vs_plain(f"loop_update dual mode K={DUAL_K} A=1 L=3, fresh",
                            lambda: dual_update(dconfig, dstates, dacc, dacc, *tables),
                            lambda: dual_update_plain(dconfig, dstates, dacc, dacc, *tables),
                            card, graphs=True)
    fresh.update(loop_bound(dstates, dacc, sink=False, dual=True))
    res["fresh"] = fresh
    results["loop_update_dual"] = res

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
    al_errs, al_times, al_comp = al_cells(args.seed, card)
    for kernel, err in al_errs.items():
        errs[kernel] = max(errs[kernel], err)
    log(f"[phase] 3c, every A and L, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    errs["replica"], replica_grid = replica_cells(args.seed)
    log(f"[phase] 3d, the replica kernel bit for bit, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    errs["loop_update"] = errs["loop_update_dual"] = loop_cells(args.seed)
    loop_exact = loop_trajectory(system, args.seed)
    log(f"[phase] 3b, the loop kernel against its plain version, in "
        f"{time.perf_counter() - t0!r} s")
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
    launches.update(taps=sweep_counts["taps"], fused=sweep_counts["fused"],
                    replica=sweep_counts["replica"])
    log(f"[phase] main path C, the kernel sweep, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    mode_counts, sweep_by_mode = sweep_modes(card)
    log(f"[phase] C2, the sweep's corners in every reps mode, in "
        f"{time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    replica_launches, replica_bench = replica_path(card)
    log(f"[phase] R, the replica benchmark, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    launches["bank_onehot"], benches = channel_loops(system, args.seed, sre, sim)
    log(f"[phase] main path D, per-channel and one-hot loops, in "
        f"{time.perf_counter() - t0!r} s")

    # The cold-start slice. Each path's launches are counted from 0 just
    # before it and read just after; `by_path` keeps them per kernel.
    by_path = {"bank_rows": {"rows": launches["bank_rows"]},
               "bank_comp": {"A": launches["bank_comp"]},
               "bank_transition": {"B": launches["bank_transition"]},
               "bank_onehot": {"D": launches["bank_onehot"]},
               "taps": {"C": launches["taps"], "C2": mode_counts["taps"]},
               "fused": {"C": launches["fused"], "C2": mode_counts["fused"]},
               "replica": {"C": launches["replica"], "C2": mode_counts["replica"],
                           "R": replica_launches}}
    by_path["bank_comp"]["AL"] = al_comp
    t0 = time.perf_counter()
    for kernel, err in family_cells(args.seed).items():
        errs[kernel] = max(errs[kernel], err)
    by_path["bank_rows"]["families"], family_times = family_loops(args.seed, card)
    log(f"[phase] E, the families, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    acquisition = acquisition_path(args.seed, card)
    log(f"[phase] F, acquisition, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    cold_counts, coldstart = coldstart_path(card)
    by_path["bank_rows"]["coldstart_l1"] = cold_counts["l1"]["bank_rows"]
    by_path["bank_transition"]["coldstart_l5"] = cold_counts["l5"]["bank_transition"]
    by_path["bank_transition"]["coldstart_b1i"] = cold_counts["b1i"]["bank_transition"]
    log(f"[phase] G, the cold start, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    stream_counts, streaming = streaming_path(args.seed, card)
    by_path["bank_rows"]["streaming"] = stream_counts["bank_rows"]
    dual_counts = dual_per_channel_path(args.seed)
    for kernel in ("taps", "fused", "replica"):
        by_path[kernel]["dual"] = dual_counts[kernel]
    log(f"[phase] H and I, streaming and the per-channel dual bank, in "
        f"{time.perf_counter() - t0!r} s")

    # The distributed layer and the figure layer.
    t0 = time.perf_counter()
    par_counts, par_errs, parallel = parallel_path(system, args.seed, sre, sim, sre_l5, sim_l5,
                                                   l5_offsets, card)
    for kernel, count in par_counts.items():
        by_path[kernel]["parallel"] = count
        if kernel in par_errs:                 # J0 holds the correlators to their plain versions
            errs[kernel] = max(errs[kernel], par_errs[kernel])
    log(f"[phase] J, the distributed layer, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    track_records = [benches[name]["record"] for name in ("track", "dual_track")]
    track_records += [entry[f"bench_k{k}"]["record"] for entry in family_times.values()
                      for k in (64, FAMILY_K)]
    figures = figures_path(sweep_dir.parent / "figures", sweep_dir, track_records, card)
    log(f"[phase] K, the figures, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    for kernel, count in scripts_path(card).items():
        if count:
            by_path[kernel]["S"] = count
    log(f"[phase] S, the sweep analogs, in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    graph_counts, captured = graph_path(system, sre, sim, sre_l5, sim_l5, l5_offsets, card)
    by_path["loop_update"] = dict(LOOP_BY_PATH)
    by_path["loop_update_dual"] = dict(DUAL_BY_PATH)
    for kernel, count in graph_counts.items():
        by_path[kernel]["L"] = count
    captured["streaming_K256"] = {"graph_steady_block_s": streaming["steady_block_s"],
                               "eager_steady_block_s": streaming["eager_steady_block_s"]}
    log(f"[phase] L, the captured block loop, in {time.perf_counter() - t0!r} s")

    t0 = time.perf_counter()
    times = timings(system, args.seed, sre, sim, sre_l5, sim_l5, l5_offsets, card)
    times.update(benches)
    log(f"[phase] timings in {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    profile_counts, profiled = profile_path(system, sre, sim,
                                            times[f"bank_rows_n{N_1MS}"]["kernel_graph_ms"], card)
    by_path["bank_rows"]["P"] = profile_counts["bank_rows"]
    by_path["loop_update"]["P"] = LOOP_BY_PATH["P"]
    log(f"[phase] P, the profile, in {time.perf_counter() - t0!r} s")

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
        # No Pallas kernel: the XLA fusion of the JAX loop_update, and of the
        # JAX dual body around it (the kernel's dual mode).
        ("loop_update", "gpuacceleratedtracking_tpu_torch/csrc/loop_update.cu",
         "gpuacceleratedtracking_tpu/tracking/track.py:77", times["loop_update"], graph),
        ("loop_update_dual", "gpuacceleratedtracking_tpu_torch/csrc/loop_update.cu",
         "gpuacceleratedtracking_tpu/tracking/dual.py:123", times["loop_update_dual"], graph),
        # No Pallas kernel: the XLA fusion of the JAX gen_code_replica and the
        # tap matrix that the JAX correlate_pallas_taps builds from it.
        ("replica", "gpuacceleratedtracking_tpu_torch/csrc/replica.cu",
         "gpuacceleratedtracking_tpu/ops/replica.py:63", times[f"replica_n{N_WIDE}_l7"], graph),
    ]
    # Closed-loop blocks of each bank kernel's main path (rows: 20, A: 20,
    # B: 60 sync + 200 tracking, D's one-hot bank: 20); the per-channel
    # kernels' main path is the sweep, one launch per correlator call.
    per_block = {"bank_rows": (20, "block"), "bank_comp": (20, "block"),
                 "bank_transition": (260, "block"), "bank_onehot": (sre.shape[0], "block"),
                 "taps": (None, "call"), "fused": (None, "call"),
                 "loop_update": (20, "block"), "loop_update_dual": (260, "block"),
                 "replica": (None, "call")}
    launches["loop_update"] = by_path["loop_update"]["rows"]
    launches["loop_update_dual"] = by_path["loop_update_dual"]["B"]
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
        "max_abs_err": errs[name],
        "ms": t["kernel_graph_ms"], "eager_ms": t["kernel_ms"], "plain_ms": t[plain_key],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_unit": t["bound_unit"],
        "launches_per_block": (launches[name] / per_block[name][0] if per_block[name][0]
                               else 1.0),
        "per": per_block[name][1], "library_ms": t.get("library_ms"), "clock": clock,
    } for name, source, replaces, t, (plain_key, clock) in entries]}
    # taps and fused at both sweep corners: the launch-weighted one and the top.
    corner_keys = {"ms": "kernel_graph_ms", "eager_ms": "kernel_ms", "plain_ms": "plain_graph_ms",
                   "bound_ms": "bound_ms", "bound_by": "bound_by", "wrapper_ms": "wrapper_ms",
                   "device_ops_per_call": "device_ops_per_call", "library_ms": "library_ms"}
    for entry in kernels["kernels"][4:6]:
        name = entry["name"]
        entry["launches_n_le_32768"] = sweep_small[name]
        entry["corners"] = {
            corner: {key: times[f"{name}_{corner}"][src] for key, src in corner_keys.items()}
            for corner in (f"n{N_1MS}_a1_l3", top)}
    comp_bf16 = times["bank_comp_bf16"]
    kernels["kernels"][6]["exact_trajectory_channels"] = loop_exact
    # The loop kernel's `ms` is its mode under the replayed graph's sink; the
    # fresh mode (the eager loop's) beside it.
    for entry in kernels["kernels"][6:8]:
        fresh = times[entry["name"]]["fresh"]
        entry.update(mode="sink", ms_fresh=fresh["kernel_graph_ms"],
                     eager_ms_fresh=fresh["kernel_ms"], plain_ms_fresh=fresh["plain_graph_ms"],
                     bound_ms_fresh=fresh["bound_ms"], bound_by_fresh=fresh["bound_by"])
    kernels["kernels"][1].update(ms_bf16=comp_bf16["kernel_graph_ms"],
                                 eager_ms_bf16=comp_bf16["kernel_ms"],
                                 plain_ms_bf16=comp_bf16["plain_ms"],
                                 bound_ms_bf16=comp_bf16["bound_ms"],
                                 library_ms_bf16=comp_bf16["library_ms"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": card, "build_s": build_s,
                       "kernels": kernels["kernels"], "times": times,
                       "families": family_times, "acquisition": acquisition,
                       "coldstart": coldstart, "streaming": streaming,
                       "parallel": parallel, "figures": figures, "graphs": captured,
                       "sweep": sweep, "sweep_modes": sweep_by_mode, "al": al_times,
                       "profile": profiled,
                       "replica": {"grid_cells": replica_grid, "benchmark": replica_bench,
                                   "corner_n32768_l3": times[f"replica_n{N_1MS}_l3"]}},
                      f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
