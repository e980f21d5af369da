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
without the rest of the smoke run. Then the sharded banks' captured block
loops (`graph_leg`): on distinct cards each channel shard of a time-1 mesh
replays a graph of its own on its own card, a time axis runs the eager loop;
each mesh once under ``tracking.eager()`` and once through the graphs, equal
bit for bit with equal launch counts, and both block times. Exits nonzero on
any failed check.
"""

import sys
import time

import numpy as np
import torch

import chip_smoke


def graph_leg(system, sre, sim, sre5, sim5, offsets, card, blocks: int = 10):
    """The K=1024 GPS L1 bank unsharded and on meshes 4 x 1 and 2 x 2, and the
    K=64 GPS L5 dual bank on chan 4, over ``blocks`` noiseless blocks: graph
    against eager, bit for bit, launches alike, and the block times."""
    from gpuacceleratedtracking_tpu_torch.models import GPSL5
    from gpuacceleratedtracking_tpu_torch.parallel import (
        channel_time_mesh, track_bank_dual_sharded, track_bank_sharded)
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, eager, track_bank)

    codes = torch.as_tensor(system.codes, device=chip_smoke.DEVICE)
    config = TrackConfig.for_system(system, chip_smoke.L1_FS, chip_smoke.N_1MS,
                                    algorithm="pallas_bank_auto")
    states = chip_smoke.bank_states(system, init_errors=False)
    sre, sim, sre5, sim5 = sre[:blocks], sim[:blocks], sre5[:blocks], sim5[:blocks]
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    codes_i = torch.as_tensor(sys_i.codes, device=chip_smoke.DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=chip_smoke.DEVICE)
    cfg5 = dual_config(TrackConfig.for_system(sys_i, chip_smoke.L1_FS, chip_smoke.N_1MS,
                                              algorithm="pallas_bank_auto",
                                              use_secondary=False))
    states5 = chip_smoke.dual_states(offsets, chip_smoke.L5_DOPPLERS)
    runs = {"rows unsharded": (lambda: track_bank(config, codes, states, sre, sim),
                               chip_smoke.NUM_K)}
    for chan, time_ in ((4, 1), (2, 2)):
        mesh = channel_time_mesh(chan, time_, devices=chip_smoke.mesh_devices(chan * time_))
        runs[f"rows mesh {chan}x{time_}"] = (
            lambda m=mesh: track_bank_sharded(config, codes, states, sre, sim, mesh=m),
            chip_smoke.NUM_K)
    mesh4 = channel_time_mesh(4, 1, devices=chip_smoke.mesh_devices(4))
    runs["L5 dual mesh chan 4"] = (
        lambda: track_bank_dual_sharded(cfg5, codes_i, codes_q, states5, sre5, sim5,
                                        mesh=mesh4), chip_smoke.DUAL_K)
    results = {}
    for name, (run, channels) in runs.items():
        with eager():
            want, eager_counts = chip_smoke.counted(run)
        got, graph_counts = chip_smoke.counted(run)
        chip_smoke.check(graph_counts == eager_counts,
                         f"[J graph] {name}: launches {graph_counts} against {eager_counts}")
        chip_smoke.bitwise(f"[J graph] {name}", got, want)
        with eager():
            e_med, e_min = chip_smoke.time_cuda(run, warmup=1)
        g_med, g_min = chip_smoke.time_cuda(run, warmup=1)
        results[name] = {"eager_block_ms": e_med / blocks, "graph_block_ms": g_med / blocks,
                         "eager_block_min_ms": e_min / blocks,
                         "graph_block_min_ms": g_min / blocks}
        print(f"[J graph] {name} on {torch.cuda.device_count()} card(s): graph equals eager "
              f"bit for bit, launches per call {dict((k, v) for k, v in graph_counts.items() if v)}; "
              f"block eager {e_med / blocks!r} ms (min {e_min / blocks!r}), graph "
              f"{g_med / blocks!r} ms (min {g_min / blocks!r}); real-time channels eager "
              f"{channels * blocks / e_med!r}, graph {channels * blocks / g_med!r} [{card}]",
              flush=True)
    return results


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
    t0 = time.perf_counter()
    graph_leg(system, sre, sim, sre5, sim5, offsets, card)
    print(f"[parallel] graph leg {time.perf_counter() - t0!r} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
