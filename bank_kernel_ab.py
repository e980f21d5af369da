#!/usr/bin/env python3
"""Old-vs-new timing of the port's kernels on one card, in one process.

Usage::

    mkdir -p build/old_csrc
    git archive <commit> gpuacceleratedtracking_tpu_torch/csrc \\
      | tar -x --strip-components=2 -C build/old_csrc
    python3 bank_kernel_ab.py --old build/old_csrc [--kernels taps fused] \\
      [--params-interface] [--out chiprun_out/ab.json]

``--old`` holds an earlier ``csrc/`` (its ``.cu`` sources and the headers
they include). The script times each kernel whose old source it finds there
(``bank_rows``, ``bank_comp``, ``taps``, ``fused``, ``replica``,
``code_tiles``; ``--kernels`` picks some) against the current one. The old sources are
built here with nvcc beside the current kernels and launched through the
current launch functions with the old library in place of the new
(`with_library`), so they must take the current C interface. The one
exception is ``--params-interface``: old ``taps.cu`` / ``fused.cu`` from
before the kernels took the raw channel parameters, launched by
`params_launcher` with a ``[4]`` f32 parameter tensor from
`_channel_params`, the PRN's f32 code column, a device array of tap
offsets, separate real and imaginary outputs and a scratch whose last word,
the finish counter, must be zero at each launch (that launcher clears it
with one 4-byte memset, which its timings include).

Both versions run on the same inputs, in turns (old, new, new, old), each
turn 20 CUDA-event-timed repetitions of 10 back-to-back launches: once as
eager launches, once as the replay of a CUDA graph of the 10 launches
(device time, without the host's per-launch work, which is most of an eager
launch below ~0.04 ms). The script prints per-launch medians and minima and
the largest difference between the two versions' outputs.

- Bank kernels, at the main paths' shapes (K=1024, N=32768 GPS L1: rows,
  one-hot, composite A=4 L=7 f32 and bf16; rows at N=2^18; GPS L5 K=128
  transition), then the current rows and composite kernels' device time
  side by side over A in {1, 2, 4} and L in {3, 7}, the evidence a routing
  rule needs. Then the rows kernel's two replica-row builds (`rows_builds`):
  GPS L1 K=1024 N=32768 at sampling rates where a chip lasts 2 to 32
  samples, and N=2^18 (256), the old kernel against the current one with
  its boundary build and with its per-position build, in turns, and
  whether the two builds' accumulators are equal to the bit: the evidence
  ``epl_kernels.MIN_CHIP_RUN`` rests on. An old ``bank_rows.cu`` from
  before the boundary build (no ``min_run`` argument) is launched through
  `OldRowsLibrary`, which drops that argument.
- Per-channel kernels, at the paper sweep's corners N=32768 A=1 L=3 (where
  most of its launches are) and N=2^18 A=4 L=7, and its smallest block
  N=2^11; with the host time of a wrapper call (2000 calls enqueued without
  a sync), the device time of a one-element PyTorch add (the floor any
  launch pays), and the current kernels under other work splits (one
  cluster per 4, 8 or 16 tiles) beside `work_split`'s, the evidence its
  shape rule rests on.
- The replica kernel (``csrc/replica.cu``) at the same two corners, N=32768
  L=3 and N=2^18 L=7, and at N=65536 L=7, N=2^17 L=3 and N=2^18 L=3 (around
  the size from which it writes through shared tiles): the ``[L, N]`` tap
  matrix of one channel, which must not differ by a bit, beside the device
  time of a PyTorch fill of the same fresh ``[L, N]`` tensor (the bytes
  alone). Where an old ``taps.cu`` is given too, a whole
  ``pallas_taps`` call (the replica kernel, then the taps kernel, now a
  programmatic dependent launch) with the old taps kernel against the
  current one, both after the current replica kernel.
- The packing kernel (``csrc/code_tiles.cu``), each version into an output
  of its own, over every family's table (GPS L1 at K = 1, 32 and 1024, on
  one PRN, with int64 PRNs; GPS L5 alone at K=1024 and as the dual bank's
  two tables at K=64; Galileo E1, BeiDou B1I and GLONASS at K=256), with
  each one's own run under torch.profiler and the words that differ from
  the plain version's; what a launch costs (a one-element add, a copy of
  the K=1024 GPS L1 words); and the current kernel under other work splits
  beside `tiles_split`'s (`TILES_SPLITS`). An old ``code_tiles.cu`` of the
  first C interface (no index, no work split) is launched as it was
  (`first_tiles_launcher`).

The old sources are not part of the repository; put them in a directory
that ``.gitignore`` lists, such as ``build/``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 20
PER_REP = 10
KERNELS = ("bank_rows", "bank_comp", "taps", "fused", "replica", "code_tiles")


def build_old(old_dir: pathlib.Path, stems, params_interface: bool) -> dict:
    """nvcc each old source into ``old_dir``; the loaded libraries, their
    entry points declared with the current C signatures (or, for
    ``taps``/``fused`` with ``params_interface``, the parameter-tensor ones)."""
    from gpuacceleratedtracking_tpu_torch.ops import _build

    P, I = ctypes.c_void_p, ctypes.c_int
    params_sigs = {"taps": {"taps_launch": ([P] * 7 + [I] * 4 + [P], I)},
                   "fused": {"fused_launch": ([P] * 8 + [I] * 5 + [P], I)}}
    # The first code_tiles.cu's: no output index, no work split.
    first_tiles_sig = {"code_tiles_launch": ([P] * 4 + [I] * 6 + [P], I)}
    procs = {}
    for stem in stems:
        out = old_dir / f"libold_{stem}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(old_dir / f"{stem}.cu")]
        procs[stem] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old {stem}:\n{log}")
        lib = ctypes.CDLL(str(out))
        sigs = params_sigs[stem] if params_interface and stem in params_sigs \
            else _build.SIGNATURES[stem]
        if stem == "code_tiles" and first_tiles_interface(old_dir / "code_tiles.cu"):
            sigs = first_tiles_sig
        old_rows = stem == "bank_rows" and "min_run" not in (old_dir / "bank_rows.cu").read_text()
        if old_rows:
            launch_sig = sigs["bank_rows_launch"]
            sigs = dict(sigs, bank_rows_launch=(launch_sig[0][:-2] + launch_sig[0][-1:],
                                                launch_sig[1]))
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        libs[stem] = OldRowsLibrary(lib) if old_rows else lib
    return libs


class OldRowsLibrary:
    """An old ``bank_rows.cu`` library, from before the boundary build,
    whose ``bank_rows_launch`` takes the current arguments but ``min_run``
    (the one before the stream), which it drops."""

    def __init__(self, lib):
        self.lib = lib

    def bank_rows_launch(self, *args):
        return self.lib.bank_rows_launch(*args[:-2], args[-1])

    def __getattr__(self, name):
        return getattr(self.lib, name)


def first_tiles_interface(source: pathlib.Path) -> bool:
    """Whether ``source`` is a ``code_tiles.cu`` of the first C interface,
    whose launch takes no index and no work split."""
    return "long long* index" not in source.read_text()


def with_library(libs: dict, launch):
    """``launch`` (a current launch function's call) run with the libraries
    in ``libs`` in place of the current ones of the same sources."""
    from gpuacceleratedtracking_tpu_torch.ops import _build

    def run():
        current = _build.load_library
        _build.load_library = lambda stem: libs[stem] if stem in libs else current(stem)
        try:
            return launch()
        finally:
            _build.load_library = current
    return run


def params_launcher(lib, call):
    """A callable launching an old per-channel kernel of the parameter-tensor
    interface on a prepared `ChannelCall`; it returns the outputs."""
    from gpuacceleratedtracking_tpu_torch.ops import channel_kernels, epl_kernels

    a, taps, n = call.num_ants, len(call.deltas), call.num_samples
    tile = channel_kernels.TILE
    out_re = torch.empty((a, taps), dtype=torch.float32, device="cuda")
    out_im = torch.empty_like(out_re)
    num_tiles = -(-n // tile)
    scratch = torch.zeros(num_tiles * 2 * a * taps + 1, dtype=torch.float32, device="cuda")
    counter = scratch[-1:]
    params = call.params.contiguous()
    if call.kernel == "taps":
        args = [call.sre.data_ptr(), call.sim.data_ptr(), call.replica.data_ptr(),
                params.data_ptr(), scratch.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
                a, taps, n, tile]
        fn = lib.taps_launch
    else:
        column = call.column.contiguous()
        deltas = epl_kernels._deltas(call.deltas, call.device)
        args = [call.sre.data_ptr(), call.sim.data_ptr(), column.data_ptr(),
                params.data_ptr(), deltas.data_ptr(), scratch.data_ptr(), out_re.data_ptr(),
                out_im.data_ptr(), a, taps, n, call.code_length, tile]
        fn = lib.fused_launch

    def launch():
        counter.zero_()
        if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("old kernel launch failed")
        return out_re, out_im

    launch.keep = (params, scratch, args)
    return launch


@contextlib.contextmanager
def forced_split(split):
    """The per-channel launches inside take ``split`` in place of
    `work_split`'s."""
    from gpuacceleratedtracking_tpu_torch.ops import channel_kernels

    current = channel_kernels.work_split
    channel_kernels.work_split = lambda num_samples: split
    try:
        yield
    finally:
        channel_kernels.work_split = current


def time_ms(fn, graph=False) -> tuple[float, float]:
    """Per-launch ms of ``fn`` over REPS repetitions of PER_REP launches:
    (median, min). CUDA events around the eager launches, or with ``graph``
    around the replay of one CUDA graph holding the PER_REP launches, which
    leaves the host's per-launch work out (device time)."""
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(PER_REP):
                fn()
        run = captured.replay
    else:
        def run():
            for _ in range(PER_REP):
                fn()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / PER_REP)
    return statistics.median(times), min(times)


def in_turns(a, b) -> dict:
    """``a`` (old) and ``b`` (new) timed as a, b, b, a: eager, then device time."""
    res = {}
    for clock, graph in (("", False), ("device_", True)):
        a1, b1, b2, a2 = (time_ms(f, graph) for f in (a, b, b, a))
        res.update({f"old_{clock}ms": statistics.median([a1[0], a2[0]]),
                    f"old_{clock}min_ms": min(a1[1], a2[1]),
                    f"new_{clock}ms": statistics.median([b1[0], b2[0]]),
                    f"new_{clock}min_ms": min(b1[1], b2[1])})
    return res


def compare(name, old, new, card, extra=None) -> dict:
    """Time ``old`` against ``new`` in turns; print and return the result."""
    diff = max(float((x - y).abs().max()) for x, y in zip(old(), new()))
    scale = float(new()[0].abs().max())
    res = in_turns(old, new)
    res.update(max_abs_diff=diff, scale=scale, **(extra or {}))
    print(f"[ab] {name}: eager old {res['old_ms']!r} ms (min {res['old_min_ms']!r}), new "
          f"{res['new_ms']!r} ms (min {res['new_min_ms']!r}); device time old "
          f"{res['old_device_ms']!r} ms (min {res['old_device_min_ms']!r}), new "
          f"{res['new_device_ms']!r} ms (min {res['new_device_min_ms']!r}); "
          f"max|old-new| {diff!r} (largest |acc| {scale!r})"
          + "".join(f"; {k} {v!r}" for k, v in (extra or {}).items()) + f" [{card}]",
          flush=True)
    return res


def bank_case(system, n, k, num_ants, taps, seed, fs=None):
    """Bank inputs on the card: PRN 0 at 1500 Hz, random channels; a block
    of 1 ms unless ``fs`` is given."""
    from gpuacceleratedtracking_tpu_torch.models import (
        EPLCorrelator, correlator_sample_shifts, gen_signal, soa)

    rng = np.random.default_rng(seed)
    duration = 1e-3 if fs is None else n / fs
    fs = n / duration if fs is None else fs
    signal, _ = gen_signal(system, 0, 1500.0, n, duration=duration,
                           num_ants=None if num_ants == 1 else num_ants)
    sre, sim = soa(signal)
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device="cuda")  # noqa: E731
    return dict(
        signal_re=sre, signal_im=sim, codes=t(system.codes),
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


def bank_prepared(c, route, z=None):
    """A prepared bank call and its current launch."""
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp, epl_kernels

    c = dict(c, code_tiles=epl_kernels.prepare_bank_code_tiles_rows(c["codes"], c["prn"]))
    if route == "pallas_bank_onehot":
        del c["nominal_code_frequency"]
    if route == "pallas_bank_comp":
        bank = bank_comp.BankCompCall(**c, z_dtype=z)
        return bank, lambda: bank_comp.launch_bank_comp(bank)
    bank = epl_kernels.BankRowsCall(**c, route=route)
    return bank, lambda: epl_kernels.launch_bank_rows(bank)


def bank_ab(libs, card) -> dict:
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5

    cells = [
        # name, system, N, K, A, L, route, z
        ("rows_k1024_l3_n32768", GPSL1(), 32768, 1024, 1, 3, "pallas_bank_rows", None),
        ("rows_k1024_l3_n262144", GPSL1(), 1 << 18, 1024, 1, 3, "pallas_bank_rows", None),
        ("transition_l5_k128_n32768", GPSL5(), 32768, 128, 1, 3, "pallas_bank", None),
        ("onehot_k1024_l3_n32768", GPSL1(), 32768, 1024, 1, 3, "pallas_bank_onehot", None),
        ("comp_k1024_a4_l7_f32", GPSL1(), 32768, 1024, 4, 7, "pallas_bank_comp", "f32"),
        ("comp_k1024_a4_l7_bf16", GPSL1(), 32768, 1024, 4, 7, "pallas_bank_comp", "bf16"),
    ]
    results = {"ab": {}, "rows_vs_comp": {}}
    for i, (name, system, n, k, a, taps, route, z) in enumerate(cells):
        stem = "bank_comp" if route == "pallas_bank_comp" else "bank_rows"
        if stem not in libs:
            continue
        _, new = bank_prepared(bank_case(system, n, k, a, taps, seed=i), route, z)
        results["ab"][name] = compare(name, with_library(libs, new), new, card)

    # Device times, in turns rows, comp f32, comp bf16, then the reverse.
    for a in (1, 2, 4):
        for taps in (3, 7):
            c = bank_case(GPSL1(), 32768, 1024, a, taps, seed=10 + a + taps)
            _, rows = bank_prepared(c, "pallas_bank_rows")
            _, comp = bank_prepared(c, "pallas_bank_comp", "f32")
            _, comp16 = bank_prepared(c, "pallas_bank_comp", "bf16")
            r1, c1, h1 = (time_ms(f, graph=True) for f in (rows, comp, comp16))
            h2, c2, r2 = (time_ms(f, graph=True) for f in (comp16, comp, rows))
            res = {"rows_device_ms": statistics.median([r1[0], r2[0]]),
                   "comp_f32_device_ms": statistics.median([c1[0], c2[0]]),
                   "comp_bf16_device_ms": statistics.median([h1[0], h2[0]])}
            results["rows_vs_comp"][f"a{a}_l{taps}"] = res
            print(f"[ab] K=1024 N=32768 A={a} L={taps}, device time: rows "
                  f"{res['rows_device_ms']!r} ms, comp f32 {res['comp_f32_device_ms']!r} ms, "
                  f"comp bf16 {res['comp_bf16_device_ms']!r} ms [{card}]", flush=True)
    if "bank_rows" in libs:
        results["rows_builds"] = rows_builds(libs, card)
    return results


@contextlib.contextmanager
def forced_min_run(min_run: int):
    """The bank_rows launches inside pass ``min_run`` whatever their rate."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    current = epl_kernels.rows_min_run
    epl_kernels.rows_min_run = lambda rho_nom: min_run
    try:
        yield
    finally:
        epl_kernels.rows_min_run = current


def rows_builds(libs, card) -> dict:
    """The old rows kernel against the current one's boundary build (every
    channel's rows from its chip boundaries, ``min_run`` 1) and its
    per-position build (``min_run`` 0), GPS L1 K=1024 L=3 at ``run``
    samples a chip, device time in turns; and whether the two builds'
    accumulators are equal bit for bit."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL1
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    system = GPSL1()
    results = {}
    for run, n in ((2, 32768), (3, 32768), (4, 32768), (6, 32768), (8, 32768), (12, 32768),
                   (16, 32768), (24, 32768), (32, 32768), (256, 1 << 18)):
        fs = run * system.code_frequency
        c = bank_case(system, n, 1024, 1, 3, seed=40 + run, fs=fs)
        # The transition route below the rows route's ~0.17 chips a sample.
        _, launch = bank_prepared(c, "pallas_bank_rows" if run >= 6 else "pallas_bank")

        def build(min_run):
            def run_it():
                with forced_min_run(min_run):
                    return launch()
            return run_it
        old, runs, each = with_library(libs, launch), build(1), build(0)
        same = all(torch.equal(x, y) for x, y in zip(runs(), each()))
        o1, r1, e1 = (time_ms(f, graph=True) for f in (old, runs, each))
        e2, r2, o2 = (time_ms(f, graph=True) for f in (each, runs, old))
        res = {"samples_a_chip": run, "n": n, "fs": fs,
               "old_device_ms": statistics.median([o1[0], o2[0]]),
               "boundary_device_ms": statistics.median([r1[0], r2[0]]),
               "position_device_ms": statistics.median([e1[0], e2[0]]),
               "bit_for_bit": same,
               "rule_min_run": epl_kernels.rows_min_run(system.code_frequency / fs)}
        results[f"run{run}_n{n}"] = res
        print(f"[ab rows builds] {run} samples a chip, N={n}: device time old "
              f"{res['old_device_ms']!r} ms, boundary build {res['boundary_device_ms']!r} ms, "
              f"per-position build {res['position_device_ms']!r} ms; builds bit for bit {same}; "
              f"the rule's min_run {res['rule_min_run']} [{card}]", flush=True)
    return results


def host_us(fn, calls=2000) -> float:
    """Host time per call of ``fn`` in us: ``calls`` calls enqueued back to
    back with no sync in between, so the host's work per call, not the
    card's, sets the span (the kernels take a few us, a call tens)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def channel_args(n, a, taps, seed):
    """One GPS L1 channel's registry arguments on the card, parameters as
    device tensors."""
    from gpuacceleratedtracking_tpu_torch.models import (
        GPSL1, EPLCorrelator, correlator_sample_shifts, gen_signal, soa)

    rng = np.random.default_rng(seed)
    system = GPSL1()
    signal, fs = gen_signal(system, 0, 1500.0, n, num_ants=None if a == 1 else a)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device="cuda")  # noqa: E731
    shifts = correlator_sample_shifts(system, EPLCorrelator(taps), fs)
    return (*soa(signal), torch.as_tensor(system.codes, device="cuda"), t(0, torch.int32),
            t(1500.0 + rng.uniform(-100, 100)), fs, t(rng.uniform(0, 6.28)),
            t(system.code_frequency), t(rng.uniform(0, 1023)),
            tuple(int(s) for s in shifts), system.code_length)


def channel_ab(libs, params_interface: bool, card) -> dict:
    from gpuacceleratedtracking_tpu_torch.ops import channel_kernels

    kinds = [kind for kind in ("taps", "fused") if kind in libs]
    cells = [("n32768_a1_l3", 32768, 1, 3), ("n262144_a4_l7", 1 << 18, 4, 7),
             ("n2048_a1_l3", 2048, 1, 3)]
    results = {"ab": {}, "splits": {}}
    for i, (name, n, a, taps) in enumerate(cells):
        cargs = channel_args(n, a, taps, seed=i)
        for kind in kinds:
            call = channel_kernels.ChannelCall(*cargs, kind)
            launch = getattr(channel_kernels, f"launch_{kind}")
            new = lambda: launch(call)  # noqa: E731
            old = params_launcher(libs[kind], call) if params_interface \
                else with_library(libs, new)
            wrapper = getattr(channel_kernels, f"correlate_pallas_{kind}")
            results["ab"][f"{kind}_{name}"] = compare(
                f"{kind} {name}", old, new, card,
                {"wrapper_host_us": host_us(lambda: wrapper(*cargs))})

    # The floor under these times: a one-element PyTorch add, timed the same
    # way (a graph of 10 launches), is what any kernel launch costs.
    one = torch.zeros(1, device="cuda")
    med, mn = time_ms(lambda: one.add_(1.0), graph=True)
    results["launch_floor"] = {"device_ms": med, "device_min_ms": mn}
    print(f"[ab] launch floor, a one-element add: device time {med!r} ms (min {mn!r}) "
          f"[{card}]", flush=True)

    # The current kernels under other splits, device time: clusters of 4, 8
    # or 16 CTAs, beside the split `work_split` takes.
    for n, a, taps in ((8192, 1, 3), (16384, 1, 3), (32768, 1, 3), (1 << 18, 4, 7)):
        cargs = channel_args(n, a, taps, seed=n)
        tiles = -(-n // channel_kernels.TILE)
        splits = {f"cluster{c}": channel_kernels.Split(tiles, -(-tiles // c) * c, c)
                  for c in (4, 8, 16)}
        splits["work_split"] = channel_kernels.work_split(n)
        for kind in ("taps", "fused"):
            call = channel_kernels.ChannelCall(*cargs, kind)
            launch = getattr(channel_kernels, f"launch_{kind}")
            row = {}
            for key, split in splits.items():
                with forced_split(split):
                    med, mn = time_ms(lambda: launch(call), graph=True)
                row[key] = {"split": [split.grid, split.cluster],
                            "device_ms": med, "device_min_ms": mn}
            results["splits"][f"{kind}_n{n}_a{a}_l{taps}"] = row
            print(f"[ab] split {kind} N={n} A={a} L={taps}, device time (grid, cluster): "
                  + ", ".join(f"{key} {tuple(v['split'])}: {v['device_ms']!r} ms"
                              for key, v in row.items()) + f" [{card}]", flush=True)
    return results


def replica_ab(libs, card) -> dict:
    """The replica kernel old against new at the per-channel corners and
    around its tile threshold, and, with an old ``taps.cu``, the
    ``pallas_taps`` call's pair of kernels with the old taps kernel against
    the current one (the current replica kernel in both)."""
    from gpuacceleratedtracking_tpu_torch.ops import channel_kernels, replica_kernel

    results = {"ab": {}, "pair": {}}
    # The two corners, and around the size (3 x 2^17 elements) from which
    # the kernel writes through shared tiles instead of one element per thread.
    cells = (("n32768_a1_l3", 32768, 1, 3), ("n65536_a1_l7", 65536, 1, 7),
             ("n131072_a1_l3", 1 << 17, 1, 3), ("n262144_a1_l3", 1 << 18, 1, 3),
             ("n262144_a4_l7", 1 << 18, 4, 7))
    for name, n, a, taps in cells:
        cargs = channel_args(n, a, taps, seed=n)
        call = channel_kernels.ChannelCall(*cargs, "taps")
        rargs = (call.codes, call.prn, call.code_frequency, call.fs, call.code_phase, n,
                 call.shifts, call.code_length)
        new = lambda: (replica_kernel.code_tap_matrix(*rargs),)  # noqa: E731
        if "replica" in libs:
            # The floor under both: a PyTorch fill of a fresh [L, N] f32
            # tensor writes the same bytes with no arithmetic.
            fill = time_ms(lambda: torch.empty((taps, n), device="cuda").fill_(1.0), graph=True)
            results["ab"][name] = compare(f"replica {name} L={taps}",
                                          with_library({"replica": libs["replica"]}, new),
                                          new, card, {"fill_device_ms": fill[0]})
        if "taps" in libs:
            pair = lambda: channel_kernels.correlate_pallas_taps(*cargs)  # noqa: E731
            results["pair"][name] = compare(
                f"pallas_taps call {name} (replica + taps), taps old vs new",
                with_library({"taps": libs["taps"]}, pair), pair, card)
    return results


def first_tiles_launcher(lib, codes, prn, pilot, out):
    """A callable launching a ``code_tiles.cu`` of the first C interface into
    ``out``; it returns ``(out,)``."""
    tables = (codes,) if pilot is None else (codes, pilot)
    args = [codes.data_ptr(), tables[-1].data_ptr(), prn.data_ptr(), out.data_ptr(),
            int(prn.dtype == torch.int64), prn.numel(), prn.numel() * len(tables),
            codes.shape[0], codes.shape[1], tables[-1].shape[1]]

    def launch():
        if lib.code_tiles_launch(*args, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("old code_tiles launch failed")
        return (out,)

    return launch


def kernel_us(fn, name: str, launches: int = 20) -> float:
    """The mean duration in us of the device events whose name holds
    ``name``, over ``launches`` launches of ``fn`` under torch.profiler
    (after spin kernels: a session's first events sometimes go missing): the
    kernel's own run, without the gap between launches that a graph
    replay's time per launch holds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.cuda._sleep(100_000)
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name
             and "spin_kernel" not in e.name]
    return statistics.mean(spans) if spans else float("nan")


# (vec, chunk, channels) splits of the packing kernel tried beside
# `tiles_split`'s: more CTAs per channel chunk, wider word chunks, one word
# per store.
TILES_SPLITS = ((4, 4, 256), (4, 4, 128), (4, 4, 64), (4, 8, 128), (1, 1, 256), (1, 2, 128),
                (1, 4, 64))


def tiles_splits(cells: dict, card) -> dict:
    """The current packing kernel's device time (graph) and own run under
    the splits of `TILES_SPLITS`, beside `tiles_split`'s, for GPS L1 at
    K=1024 and K=1 and GPS L5 at K=1024: the evidence its rule rests on."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    current = epl_kernels.tiles_split
    results = {}
    for name in ("l1_k1024", "l1_k1", "l5_k1024"):
        codes, prns, _ = cells[name]
        words = -(-codes.shape[0] // 32)
        out = torch.empty((prns.numel(), words), dtype=torch.int32, device="cuda")
        want = epl_kernels.pack_code_tiles_plain(codes, prns)
        row = {}
        for vec, chunk, channels in ((None, None, None),) + TILES_SPLITS:
            split = (current(codes.shape[1], words, prns.numel()) if vec is None else
                     epl_kernels.TilesSplit(vec, chunk, channels,
                                            (-(-words // chunk), -(-prns.numel() // channels),
                                             1)))
            if epl_kernels.tiles_shared(codes.shape[1], split.chunk) \
                    > epl_kernels.TILES_MAX_SHARED:
                continue
            epl_kernels.tiles_split = lambda *args, split=split: split
            try:
                fn = lambda: epl_kernels.pack_code_tiles(codes, prns, out=out)  # noqa: E731
                med, mn = time_ms(fn, graph=True)
                differ = int((fn() != want).sum())
                run_us = kernel_us(fn, "code_tiles")
            finally:
                epl_kernels.tiles_split = current
            key = "tiles_split" if vec is None else f"v{vec}_c{chunk}_k{channels}"
            row[key] = {"split": list(split[:3]) + [list(split.grid)], "device_ms": med,
                        "device_min_ms": mn, "kernel_us": run_us, "differ": differ}
        results[name] = row
        print(f"[ab] code_tiles split {name}, device time ms / own run us (vec, chunk, "
              f"channels, grid): " + "; ".join(
                  f"{k} {tuple(v['split'][:3])} {tuple(v['split'][3])}: {v['device_ms']!r} / "
                  f"{v['kernel_us']!r}" + (f" ({v['differ']} words differ)" if v["differ"]
                                           else "") for k, v in row.items()) + f" [{card}]",
              flush=True)
    return results


def code_tiles_ab(libs, old_dir: pathlib.Path, card) -> dict:
    """The packing kernel (``csrc/code_tiles.cu``) old against new, each
    into an output of its own, at the main paths' shapes and around them,
    and what its time is made of: the device time of a one-element add (the
    launch), of a copy of the K=1024 GPS L1 words (the stores' bytes alone),
    of the kernel at K=32 (one PRN each: the latency of one pass, little
    work) and at K=1024 on one PRN (the loads of every channel from the same
    column, the stores as at K=1024)."""
    from gpuacceleratedtracking_tpu_torch.models import (
        GPSL1, GPSL5, BeiDouB1I, GalileoE1, GLONASSL1)
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    rng = np.random.default_rng(7)
    t = lambda x: torch.as_tensor(x, device="cuda")  # noqa: E731
    l1, l5i, l5q = t(GPSL1().codes), t(GPSL5().codes), t(GPSL5(quadrature=True).codes)
    prn = lambda k, p=32: t(rng.integers(0, p, k).astype(np.int32))  # noqa: E731
    cells = {
        "l1_k1024": (l1, prn(1024), None),
        "l1_k1024_int64": (l1, prn(1024).long(), None),
        "l1_k1024_one_prn": (l1, t(np.zeros(1024, np.int32)), None),
        "l1_k32": (l1, t(np.arange(32, dtype=np.int32)), None),
        "l1_k1": (l1, prn(1), None),
        "l5_dual_k64": (l5i, prn(64), l5q),
        "l5_k1024": (l5i, prn(1024), None),
        "e1_k256": (t(GalileoE1().codes), prn(256, 50), None),
        "b1i_k256": (t(BeiDouB1I().codes), prn(256, 37), None),
        "glonass_k256": (t(GLONASSL1().codes), prn(256, 14), None),
    }
    old_is_first = first_tiles_interface(old_dir / "code_tiles.cu")
    results = {"ab": {}}
    for name, (codes, prns, pilot) in cells.items():
        words = -(-codes.shape[0] // 32)
        num_k = prns.numel() * (1 if pilot is None else 2)
        outs = [torch.empty((num_k, words), dtype=torch.int32, device="cuda") for _ in range(2)]
        new = lambda c=codes, p=prns, q=pilot, o=outs[1]: (  # noqa: E731
            epl_kernels.pack_code_tiles(c, p, q, out=o),)
        old = first_tiles_launcher(libs["code_tiles"], codes, prns, pilot, outs[0]) \
            if old_is_first else with_library(libs, lambda c=codes, p=prns, q=pilot, o=outs[0]: (
                epl_kernels.pack_code_tiles(c, p, q, out=o),))
        want = epl_kernels.pack_code_tiles_plain(codes, prns, pilot)
        res = compare(f"code_tiles {name}", old, new, card)
        res.update(old_differs=int((old()[0] != want).sum()),
                   new_differs=int((new()[0] != want).sum()),
                   old_kernel_us=kernel_us(old, "code_tiles"),
                   new_kernel_us=kernel_us(new, "code_tiles"))
        print(f"[ab] code_tiles {name}: the kernel's own run (torch.profiler) old "
              f"{res['old_kernel_us']!r} us, new {res['new_kernel_us']!r} us; words differing "
              f"from the plain version's: old {res['old_differs']}, new {res['new_differs']} "
              f"[{card}]", flush=True)
        results["ab"][name] = res
    results["splits"] = tiles_splits(cells, card)
    one = torch.zeros(1, device="cuda")
    words = torch.empty((1024, 32), dtype=torch.int32, device="cuda")
    src = torch.zeros_like(words)
    for key, fn in (("launch_floor", lambda: one.add_(1.0)),
                    ("copy_l1_k1024_words", lambda: words.copy_(src))):
        med, mn = time_ms(fn, graph=True)
        results[key] = {"device_ms": med, "device_min_ms": mn, "kernel_us": kernel_us(fn, "")}
        print(f"[ab] code_tiles {key}: device time {med!r} ms (min {mn!r}), its own run "
              f"{results[key]['kernel_us']!r} us [{card}]", flush=True)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True, help="directory of the old csrc/ sources")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS,
                        help="the kernels to time, of those whose old source is found")
    parser.add_argument("--params-interface", action="store_true",
                        help="the old taps.cu / fused.cu take a [4] parameter tensor")
    parser.add_argument("--out", help="also write the results as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bank_kernel_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from gpuacceleratedtracking_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ab] {card}", flush=True)
    old_dir = pathlib.Path(args.old)
    stems = [s for s in args.kernels if (old_dir / f"{s}.cu").exists()]
    if not stems:
        raise RuntimeError(f"no old source of {args.kernels} in {old_dir}")
    libs = build_old(old_dir, stems, args.params_interface)
    _build.build()

    results = {"card": card}
    if {"bank_rows", "bank_comp"} & set(libs):
        results["bank"] = bank_ab(libs, card)
    if {"taps", "fused"} & set(libs):
        results["channel"] = channel_ab(libs, args.params_interface, card)
    if {"replica", "taps"} & set(libs) and not args.params_interface:
        results["replica"] = replica_ab(libs, card)
    if "code_tiles" in libs:
        results["code_tiles"] = code_tiles_ab(libs, old_dir, card)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
