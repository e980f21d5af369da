"""Device timeline of the correlation pipeline: the port's
``scripts/profile_trace.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.profile_trace [algorithm] [num_samples] [num_channels]

Defaults: the 1024-channel GPS L1 bank at N=32768 on ``pallas_bank_auto``.
A bank algorithm is one `ops.registry` call over K channels (with the
nominal code rate; the port's kernels have no launch knobs to look up), any
other algorithm one per-channel call. `bench.profile.profile_calls` runs
`REPS` calls under torch.profiler on the card and writes
``data/torch/profile/summary.json`` and the Chrome trace beside it.
"""

from __future__ import annotations

import functools
import json
import pathlib
import sys

import torch

from ..bench.harness import add_metadata
from ..bench.profile import profile_calls
from ..models import GPSL1, EPLCorrelator, correlator_sample_shifts, gen_signal, soa
from ..ops import registry
from . import DATA, ROOT

OUT = DATA / "profile"
TRACE_NAME = "trace.pt.trace.json"
REPS = 10


def correlator_call(algorithm: str, num_samples: int, num_channels: int, device="cuda"):
    """The JAX script's workload as a callable of no arguments: GPS L1 PRN 1
    at 1500 Hz, the bank's channels spread over +/-4 kHz of Doppler."""
    system = GPSL1()
    fs = num_samples / 1e-3
    signal, _ = gen_signal(system, 0, 1500.0, num_samples, device=device)
    sre, sim = soa(signal)
    shifts = tuple(int(s) for s in correlator_sample_shifts(system, EPLCorrelator(3), fs))
    codes = torch.as_tensor(system.codes, device=device)
    if algorithm in registry.BANK_ALGORITHMS:
        extra = {}
        if algorithm.startswith("pallas_bank") and algorithm != "pallas_bank_onehot":
            extra["nominal_code_frequency"] = system.code_frequency
        corr = functools.partial(registry.get(algorithm), sample_shifts=shifts,
                                 code_length=system.code_length, sampling_frequency=fs, **extra)
        prn = torch.arange(num_channels, dtype=torch.int32, device=device) % codes.shape[1]
        dops = torch.linspace(-4000.0, 4000.0, num_channels, device=device)
        zeros = torch.zeros(num_channels, device=device)
        fcar, fcode = 1500.0 + dops, zeros + system.code_frequency
        return lambda: corr(sre, sim, codes, prn, fcar, carrier_phase=zeros,
                            code_frequency=fcode, code_phase=zeros)
    corr = functools.partial(registry.get(algorithm), sample_shifts=shifts,
                             code_length=system.code_length)
    return lambda: corr(sre, sim, codes, 0, 1500.0, fs, 0.0, system.code_frequency, 0.0)


def _shown(path: pathlib.Path) -> str:
    """``path`` relative to the checkout where it lies inside it."""
    path = path.resolve()
    return str(path.relative_to(ROOT)) if path.is_relative_to(ROOT) else str(path)


def run(algorithm: str = "pallas_bank_auto", num_samples: int = 32768,
        num_channels: int = 1024, out_dir: pathlib.Path = OUT, device="cuda",
        reps: int = REPS) -> dict:
    """Profile ``reps`` calls; write the summary and the trace to ``out_dir``."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = correlator_call(algorithm, num_samples, num_channels, device)
    label = f"correlate_{algorithm}_K{num_channels}_N{num_samples}"
    trace = out_dir / TRACE_NAME
    prof = profile_calls(fn, (), reps, label, trace)
    timeline = dict(prof["device_timeline"], trace_file=_shown(trace))
    processor = "GPU" if torch.device(device).type == "cuda" else "CPU"
    summary = add_metadata({"num_samples": num_samples, "num_channels": num_channels,
                            "reps": reps, "wall_s": prof["wall_s"],
                            "per_call_ms": prof["per_call_ms"],
                            "trace_file": _shown(trace),
                            "note": "per_call_ms is the host clock around the calls "
                                    "(dispatch and the wrappers' set-up included); "
                                    "device_timeline is the card's own record"},
                           processor, algorithm)
    summary["device_timeline"] = timeline
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    return summary


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    algorithm = argv[0] if len(argv) > 0 else "pallas_bank_auto"
    num_samples = int(argv[1]) if len(argv) > 1 else 32768
    num_channels = int(argv[2]) if len(argv) > 2 else 1024
    print(json.dumps(run(algorithm, num_samples, num_channels)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
