#!/usr/bin/env python3
"""Old-vs-new timing of the bank kernels on one card, in one process.

Usage::

    mkdir -p build/old_csrc
    git show <commit>:gpuacceleratedtracking_tpu_torch/csrc/bank_rows.cu > build/old_csrc/bank_rows.cu
    git show <commit>:gpuacceleratedtracking_tpu_torch/csrc/bank_comp.cu > build/old_csrc/bank_comp.cu
    python3 bank_kernel_ab.py --old build/old_csrc [--out chiprun_out/ab.json]

``--old`` holds an earlier version of ``csrc/bank_rows.cu`` and
``csrc/bank_comp.cu`` with the C interface they had before the code columns
were packed: f32 ``[K, Lc]`` code columns, and the rows kernel's partials per
4096-sample tile. They are built here with nvcc beside the current kernels.
Both versions run on the same inputs at the main paths' shapes, in turns
(old, new, new, old), each turn 20 CUDA-event-timed repetitions of 10
back-to-back launches: once as eager launches, once as the replay of a CUDA
graph of the 10 launches (device time, without the host's per-launch work,
which is most of an eager launch below ~0.04 ms). The script prints
per-launch medians and minima and the largest difference between the two
versions' outputs. It then times the current rows and composite kernels'
device time side by side over A in {1, 2, 4} and L in {3, 7} (K=1024,
N=32768 at 32.768 MHz), the evidence a routing rule needs.
The old sources are not part of the repository; put them in a directory that
``.gitignore`` lists, such as ``build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

REPS = 20
PER_REP = 10


def build_old(old_dir: pathlib.Path) -> dict:
    """nvcc each old source into ``old_dir``; the old C signatures."""
    from gpuacceleratedtracking_tpu_torch.ops import _build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "bank_rows": ("bank_rows_launch", [P] * 9 + [I] * 6 + [F, F, P]),
        "bank_comp": ("bank_comp_launch", [P] * 9 + [I] * 8 + [F, F, P]),
    }
    procs = {}
    for stem in sigs:
        out = old_dir / f"libold_{stem}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(old_dir / f"{stem}.cu")]
        procs[stem] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for stem, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old {stem}:\n{log}")
        name, argtypes = sigs[stem]
        fn = getattr(ctypes.CDLL(str(out)), name)
        fn.argtypes, fn.restype = argtypes, I
        fns[stem] = fn
    return fns


def case(system, n, k, num_ants, taps, seed):
    """Bank inputs on the card: PRN 0 at 1500 Hz, random channels."""
    from gpuacceleratedtracking_tpu_torch.models import (
        EPLCorrelator, correlator_sample_shifts, gen_signal, soa)

    rng = np.random.default_rng(seed)
    fs = n / 1e-3
    signal, _ = gen_signal(system, 0, 1500.0, n, num_ants=None if num_ants == 1 else num_ants)
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


def old_launcher(fns, bank, cols, comp: bool, bf16: bool = False):
    """A callable launching the old kernel on a prepared call with f32 code
    columns ``cols``; it returns the outputs."""
    from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

    shape = (bank.num_k, bank.num_ants, len(bank.deltas))
    out_re = torch.empty(shape, dtype=torch.float32, device="cuda")
    out_im = torch.empty_like(out_re)
    deltas = epl_kernels._deltas(bank.deltas, bank.device)
    rho, fcar = ctypes.c_float(bank.rho_nom), ctypes.c_float(bank.fcar_nom_cyc)
    common = [bank.sre.data_ptr(), bank.sim.data_ptr(), cols.data_ptr(), bank.params.data_ptr(),
              bank.base.data_ptr(), deltas.data_ptr()]
    if comp:
        tiles = -(-(bank.num_samples + bank.span) // 1024)
        partial = torch.empty(shape[:1] + (tiles,) + shape[1:] + (4,), device="cuda")
        args = common + [partial.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
                         bank.num_ants, len(bank.deltas), bank.num_samples, bank.num_k,
                         bank.code_length, epl_kernels.TILE, bank.span, int(bf16), rho, fcar]
        fn = fns["bank_comp"]
    else:
        partial = torch.empty(shape[:1] + (bank.num_tiles,) + shape[1:] + (2,), device="cuda")
        args = common + [partial.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
                         bank.num_ants, len(bank.deltas), bank.num_samples, bank.num_k,
                         bank.code_length, epl_kernels.TILE, rho, fcar]
        fn = fns["bank_rows"]

    def launch():
        # The current stream at each call, so that a CUDA graph can capture it.
        if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("old kernel launch failed")
        return out_re, out_im

    launch.keep = (cols, partial)
    return launch


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True,
                        help="directory of the old bank_rows.cu, bank_comp.cu")
    parser.add_argument("--out", help="also write the results as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bank_kernel_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import _build, bank_comp, epl_kernels
    from gpuacceleratedtracking_tpu_torch.ops.replica import code_columns

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ab] {card}", flush=True)
    fns = build_old(pathlib.Path(args.old))
    _build.build()

    def prepared(c, route, z=None):
        c = dict(c, code_tiles=epl_kernels.prepare_bank_code_tiles_rows(c["codes"], c["prn"]))
        if route == "pallas_bank_onehot":
            del c["nominal_code_frequency"]
        if route == "pallas_bank_comp":
            bank = bank_comp.BankCompCall(**c, z_dtype=z)
            new = lambda: bank_comp.launch_bank_comp(bank)  # noqa: E731
        else:
            bank = epl_kernels.BankRowsCall(**c, route=route)
            new = lambda: epl_kernels.launch_bank_rows(bank)  # noqa: E731
        return bank, new

    cells = [
        # name, system, N, K, A, L, route, z
        ("rows_k1024_l3_n32768", GPSL1(), 32768, 1024, 1, 3, "pallas_bank_rows", None),
        ("rows_k1024_l3_n262144", GPSL1(), 1 << 18, 1024, 1, 3, "pallas_bank_rows", None),
        ("transition_l5_k128_n32768", GPSL5(), 32768, 128, 1, 3, "pallas_bank", None),
        ("onehot_k1024_l3_n32768", GPSL1(), 32768, 1024, 1, 3, "pallas_bank_onehot", None),
        ("comp_k1024_a4_l7_f32", GPSL1(), 32768, 1024, 4, 7, "pallas_bank_comp", "f32"),
        ("comp_k1024_a4_l7_bf16", GPSL1(), 32768, 1024, 4, 7, "pallas_bank_comp", "bf16"),
    ]
    results = {"card": card, "ab": {}, "rows_vs_comp": {}}
    for i, (name, system, n, k, a, taps, route, z) in enumerate(cells):
        c = case(system, n, k, a, taps, seed=i)
        bank, new = prepared(c, route, z)
        comp = route == "pallas_bank_comp"
        old = old_launcher(fns, bank, code_columns(c["codes"], c["prn"]), comp, bf16=z == "bf16")
        diff = max(float((x - y).abs().max()) for x, y in zip(old(), new()))
        scale = float(new()[0].abs().max())
        res = in_turns(old, new)
        res.update(max_abs_diff=diff, scale=scale)
        results["ab"][name] = res
        print(f"[ab] {name}: eager old {res['old_ms']!r} ms (min {res['old_min_ms']!r}), new "
              f"{res['new_ms']!r} ms (min {res['new_min_ms']!r}); device time old "
              f"{res['old_device_ms']!r} ms (min {res['old_device_min_ms']!r}), new "
              f"{res['new_device_ms']!r} ms (min {res['new_device_min_ms']!r}); "
              f"max|old-new| {diff!r} (largest |acc| {scale!r}) [{card}]", flush=True)
        del bank, new, old, c

    # Device times, in turns rows, comp f32, comp bf16, then the reverse.
    for a in (1, 2, 4):
        for taps in (3, 7):
            c = case(GPSL1(), 32768, 1024, a, taps, seed=10 + a + taps)
            _, rows = prepared(c, "pallas_bank_rows")
            _, comp = prepared(c, "pallas_bank_comp", "f32")
            _, comp16 = prepared(c, "pallas_bank_comp", "bf16")
            r1, c1, h1 = (time_ms(f, graph=True) for f in (rows, comp, comp16))
            h2, c2, r2 = (time_ms(f, graph=True) for f in (comp16, comp, rows))
            res = {"rows_device_ms": statistics.median([r1[0], r2[0]]),
                   "comp_f32_device_ms": statistics.median([c1[0], c2[0]]),
                   "comp_bf16_device_ms": statistics.median([h1[0], h2[0]])}
            results["rows_vs_comp"][f"a{a}_l{taps}"] = res
            print(f"[ab] K=1024 N=32768 A={a} L={taps}, device time: rows "
                  f"{res['rows_device_ms']!r} ms, comp f32 {res['comp_f32_device_ms']!r} ms, "
                  f"comp bf16 {res['comp_bf16_device_ms']!r} ms [{card}]", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
