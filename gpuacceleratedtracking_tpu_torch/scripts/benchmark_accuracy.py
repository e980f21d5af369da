"""Accumulator accuracy against a float64 oracle across the sweep envelope,
on the card: the port's ``scripts/benchmark_accuracy.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.benchmark_accuracy

For each (GNSS, N) cell of the kernel sweep's envelope, K=8 satellites plus
AWGN make one front end; each correlator correlates every satellite, and the
``[K, L]`` accumulators are held against an independently written float64
numpy oracle on the same f32 signal: max/mean relative error and
accumulator SNR (dB). Variants: the per-channel ``fused_xla`` (one batched
torch call) and ``pallas_fused`` (``csrc/fused.cu``, one call per channel);
and, where their envelopes hold, the bank kernels ``pallas_bank`` (the
transition route of ``csrc/bank_rows.cu``), ``pallas_bank_rows`` and
``pallas_bank_comp`` with f32 and bf16 z-planes (``csrc/bank_comp.cu``; the
bf16 mode also against the f32 one). The JAX script's bf16/f32 MXU-input
pair of the transition kernel is a TPU matmul knob with no counterpart here.
Output: ``data/torch/benchmarks/accumulator_accuracy.json``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..bench.harness import add_metadata
from ..models import GPSL1, GPSL5, EPLCorrelator, correlator_sample_shifts, gen_signal
from ..ops import bank_comp, epl_kernels, registry
from . import BENCHMARKS

OUT = BENCHMARKS / "accumulator_accuracy.json"
K = 8           # channels per cell (error stats over K x L accumulators)
SIGMA = 2.0     # AWGN per component (signal amplitude 1 per satellite)
ENVELOPE = {
    "GPSL1": [2 ** e for e in range(11, 19)],
    "GPSL5": [2 ** e for e in range(15, 19)],
}


def numpy_oracle(system, prn, carrier_freq, fs, carrier_phase, code_freq, code_phase,
                 num_samples, shifts, sig):
    """Float64 reference correlator (independent of the torch ops)."""
    n = np.arange(num_samples, dtype=np.float64)
    carrier = np.exp(1j * (2 * np.pi * carrier_freq / fs * n + carrier_phase))
    dw = sig.astype(np.complex128) * np.conj(carrier)
    out = []
    for d in shifts:
        idx = np.mod(np.floor(code_freq / fs * (n + d) + code_phase).astype(np.int64),
                     system.code_length)
        rep = system.codes[idx, prn].astype(np.float64)
        out.append(np.sum(dw * rep))
    return np.array(out)


def cell(system, num_samples: int, device="cuda") -> dict:
    """One (system, N) cell: every variant's error against the oracle."""
    fs = num_samples / 1e-3
    rng = np.random.default_rng(num_samples)
    prns = (np.arange(K) * 3) % system.codes.shape[1]
    dops = rng.uniform(-4000.0, 4000.0, K)
    phis_car = rng.uniform(0, 2 * np.pi, K)
    phis_code = rng.uniform(0, system.code_length, K)
    fcode = system.code_frequency * (1.0 + dops / system.center_frequency)

    # Front end: the K satellites superposed, plus AWGN in f64 on the host.
    mixed = None
    for i in range(K):
        s, _ = gen_signal(system, int(prns[i]), float(dops[i]), num_samples,
                          start_carrier_phase=float(phis_car[i]),
                          start_code_phase=float(phis_code[i]),
                          code_frequency=float(fcode[i]), device=device)
        s = s.cpu().numpy()
        mixed = s if mixed is None else mixed + s
    mixed = mixed.astype(np.complex128) + SIGMA * (
        rng.standard_normal(num_samples) + 1j * rng.standard_normal(num_samples))
    sig32 = mixed.astype(np.complex64)
    sre = torch.as_tensor(sig32.real.copy(), device=device)
    sim = torch.as_tensor(sig32.imag.copy(), device=device)
    codes = torch.as_tensor(system.codes, device=device)
    shifts = tuple(int(x) for x in correlator_sample_shifts(system, EPLCorrelator(3), fs))

    # The oracle on the same f32 signal: kernel arithmetic apart from the
    # front end's quantization.
    oracle = np.stack([
        numpy_oracle(system, int(prns[i]), float(dops[i]), fs, float(phis_car[i]),
                     float(fcode[i]), float(phis_code[i]), num_samples, shifts,
                     sig32.astype(np.complex128))
        for i in range(K)])                                    # [K, L] complex

    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    prn_t, f_car, ph_car = t(prns, torch.int32), t(dops), t(phis_car)
    f_code, ph_code = t(fcode), t(phis_code)

    def host(out):
        return out[0].cpu().numpy() + 1j * out[1].cpu().numpy()

    def batched(fn):
        return host(fn(sre, sim, codes, prn_t, f_car, fs, ph_car, f_code, ph_code, shifts,
                       system.code_length))

    def per_chan(fn):
        outs = [fn(sre, sim, codes, prn_t[i], f_car[i], fs, ph_car[i], f_code[i], ph_code[i],
                   shifts, system.code_length) for i in range(K)]
        return host((torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])))

    def bank(fn, **kw):
        return host(fn(sre, sim, codes, prn_t, f_car, fs, ph_car, f_code, ph_code, shifts,
                       system.code_length, nominal_code_frequency=system.code_frequency,
                       nominal_carrier_frequency=0.0, **kw))

    variants = {
        "fused_xla": lambda: batched(registry.get("fused_xla")),
        "pallas_fused": lambda: per_chan(registry.get("pallas_fused")),
    }
    span = max(shifts) - min(shifts)
    chips_per_sample = system.code_frequency / fs * 1.001
    if span < 128:
        variants["pallas_bank"] = lambda: bank(epl_kernels.correlate_pallas_bank)
    if chips_per_sample < 0.17:
        variants["pallas_bank_rows"] = lambda: bank(epl_kernels.correlate_pallas_bank_rows)
        variants["pallas_bank_comp_f32z"] = lambda: bank(bank_comp.correlate_pallas_bank_comp)
        variants["pallas_bank_comp_bf16z"] = lambda: bank(
            bank_comp.correlate_pallas_bank_comp, z_dtype="bf16")

    scale = np.abs(oracle).max()
    rms_sig = np.sqrt(np.mean(np.abs(oracle) ** 2))
    rows, got_by_name = {}, {}
    for name, fn in variants.items():
        got = fn()
        got_by_name[name] = got
        err = np.abs(got - oracle)
        rms_err = np.sqrt(np.mean(err ** 2))
        rows[name] = {
            "max_rel": float(err.max() / scale),
            "mean_rel": float(err.mean() / scale),
            "snr_db": float(20 * np.log10(rms_sig / rms_err) if rms_err > 0 else np.inf),
        }
    # max_rel against the oracle is set by rare f32 chip-boundary flips,
    # shared by every f32 path; the bf16 mode's own cost is its distance from
    # the same kernel in f32.
    if "pallas_bank_comp_bf16z" in got_by_name:
        d = np.abs(got_by_name["pallas_bank_comp_bf16z"] - got_by_name["pallas_bank_comp_f32z"])
        rows["pallas_bank_comp_bf16z"]["max_rel_vs_f32"] = float(d.max() / scale)
        rows["pallas_bank_comp_bf16z"]["mean_rel_vs_f32"] = float(d.mean() / scale)
    return rows


def run(envelope=ENVELOPE, device="cuda") -> dict:
    processor = "GPU" if torch.device(device).type == "cuda" else "CPU"
    config = add_metadata({"K": K, "sigma": SIGMA, "num_correlators": 3}, processor,
                          "accumulator accuracy")
    out = {"config": config, "cells": []}
    for gnss, sizes in envelope.items():
        system = GPSL1() if gnss == "GPSL1" else GPSL5()
        for n in sizes:
            rows = cell(system, n, device)
            out["cells"].append({"GNSS": gnss, "num_samples": n, "algorithms": rows})
            print(gnss, n, json.dumps({k: v["max_rel"] for k, v in rows.items()}), flush=True)
    return out


def main() -> int:
    out = run()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
