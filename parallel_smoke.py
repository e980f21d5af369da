#!/usr/bin/env python3
"""Phase J of ``chip_smoke.py`` alone: the distributed layer on the card(s).

Usage: ``python3 parallel_smoke.py``

Builds the kernels, then runs ``chip_smoke.parallel_path``: each kernel at the
shard-local shapes against its plain version, the JAX dry run's two legs, the
K=1024 GPS L1 bank on meshes 2 x 1, 1 x 2 and 2 x 2 with its lock run and
block times, the A=4 L=7 and GPS L5 dual banks sharded, ``correlate_sharded``
on the per-channel kernels and the one-hot route. The meshes take every
visible card in turn, or repeat ``cuda:0`` on a one-card machine, so on a
machine with several cards this is the check of the cross-device path
without the rest of the smoke run. Exits nonzero on any failed check.
"""

import sys
import time

import numpy as np
import torch

import chip_smoke


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("parallel_smoke needs a CUDA device")
    from gpuacceleratedtracking_tpu_torch.models import GPSL1
    from gpuacceleratedtracking_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    print(f"[device] {torch.cuda.device_count()} x {card}", flush=True)
    _build.build()
    for stem in _build.SIGNATURES:
        _build.load_library(stem)
    system = GPSL1()
    sre, sim, _ = chip_smoke.mixed_blocks(system, 20)
    # GPS L5 blocks with planted overlay phases, as `dual_path` makes them.
    rng = np.random.default_rng(2)
    offsets = rng.integers(0, 20, len(chip_smoke.L5_PRNS))
    navs = rng.choice([-1.0, 1.0], (len(chip_smoke.L5_PRNS), 23))
    gen = torch.Generator(device="cuda").manual_seed(2)
    sre5, sim5 = chip_smoke.l5_dual_blocks(20, offsets, navs, gen)
    t0 = time.perf_counter()
    counts, errs, _ = chip_smoke.parallel_path(system, 0, sre, sim, sre5, sim5, offsets, card)
    print(f"[parallel] {time.perf_counter() - t0!r} s; launches {counts}; largest "
          f"kernel-vs-plain errors {errs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
