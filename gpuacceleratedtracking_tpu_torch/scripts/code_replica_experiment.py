"""Quantized-NCO replica accuracy: the port's
``scripts/code_replica_experiment.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.code_replica_experiment [--cpu]

The share of chips where the fixed-point-NCO replica (`mode="quantized"`)
differs from the exact floor/mod replica, over the N sweep 2048..262144 in
steps of 2048, for several fractional-bit widths: min/mean/median/max per
width. On the card each replica is one launch of ``csrc/replica.cu``
(`ops.replica_kernel.code_replica`), bit for bit the plain replica ops;
``--cpu`` runs the plain version on the host (the JAX script's default
backend). Writes ``data/torch/benchmarks/replica_accuracy.json``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..bench.harness import add_metadata
from ..models import GPSL1
from ..ops.replica_kernel import code_replica
from . import BENCHMARKS

OUT = BENCHMARKS / "replica_accuracy.json"


def run(start=2048, stop=262144, step=2048, phase_bits=(8, 10, 12), device="cuda") -> dict:
    system = GPSL1()
    codes = torch.as_tensor(system.codes, device=device)
    prn = torch.zeros((), dtype=torch.int32, device=device)
    fcode = torch.tensor(system.code_frequency, dtype=torch.float32, device=device)
    phase = torch.tensor(0.25, dtype=torch.float32, device=device)
    table = {}
    for bits in phase_bits:
        mismatch = []
        for n in range(start, stop + 1, step):
            fs = n / 1e-3
            common = (codes, prn, fcode, fs, phase, n, 0, 0, system.code_length)
            exact = code_replica(*common, mode="exact")
            quant = code_replica(*common, mode="quantized", phase_bits=bits)
            mismatch.append((exact != quant).double().mean())
        pct = torch.stack(mismatch).cpu().numpy() * 100.0
        table[bits] = {"min_pct": float(pct.min()), "mean_pct": float(pct.mean()),
                       "median_pct": float(np.median(pct)), "max_pct": float(pct.max())}
    return table


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    table = run(device=device)
    payload = add_metadata({
        "metric": "chip mismatch fraction, quantized vs exact replica (%)",
        "sweep": "N = 2048:2048:262144, GPS L1 C/A prn 0, phase 0.25 chips",
        "per_phase_bits": {str(k): v for k, v in table.items()},
        "shipped_default_bits": 12,
    }, "GPU" if device == "cuda" else "CPU", "replica")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
