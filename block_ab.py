#!/usr/bin/env python3
"""Old-vs-new timing of the port's closed-loop blocks on one card.

Usage::

    mkdir -p build/old
    git archive <commit> | tar -x -C build/old
    python3 block_ab.py --old build/old [--rounds R] [--out results/block_ab.json]

``--old`` holds a whole earlier checkout of the repository. Both trees are
measured by the same code below, in turns (old, new, new, old; ``--rounds``
times over), one process per turn whose imports resolve to that tree's package and its
``chip_smoke.py`` helpers (inputs are made there from the same seeds), so
each tree builds and runs its own kernels. A turn measures, through the
entry points a user calls:

- the device time of one ``tracking.loop_update`` call on CUDA tensors at
  K=1024, A=1, L=3 (fresh outputs, as both trees have it): 20 calls
  captured in a CUDA graph, replayed;
- the 10-block call of ``track_bank`` (rows K=1024 GPS L1 at N=32768),
  ``track_bank_dual`` (GPS L5 K=64) and ``track`` (one channel through
  ``pallas_fused``), each replaying its captured block: milliseconds per
  block (CUDA events, median of 20 calls) and device ops per block
  (torch.profiler over two calls, the per-call copies included);
- the replayed K=1024 block of ``bench.run_track_benchmark`` (its B vs 2B
  differential, so the per-call copies cancel);
- the 1-block rows call (``__graft_entry__.py``'s shape): milliseconds per
  call (CUDA events) and its device ops and device milliseconds, in all
  and by op name (torch.profiler over five calls), the prologue included;
- that entry's prologue alone: milliseconds per replay of 20 back to back
  (CUDA events) and its device ops and their summed device milliseconds
  per replay (torch.profiler over 20 replays);
- ``track_bank_sharded`` on one card: the rows bank on meshes 2 x 2, 2 x 1
  and 1 x 2 and the A=4 L=7 bank (no steering weights) on 2 x 2 and
  unsharded, ms and device ops per block of 10-block calls, and the device
  ops of one replayed 2 x 2 rows block (torch.profiler over three replays);
- on a machine with several cards, ``cards_leg``:
  the rows bank on meshes of distinct cards, 4 x 1, 2 x 2, 2 x 1 and 1 x 2
  at K=1024 and 4 x 1 at K=4096, beside the unsharded K=1024 and K=4096
  banks on one card, ms and device ops per block of 10-block calls; and
  the correlators without code tiles (`CHANNEL_RUNS`: ``pallas_fused`` and
  ``pallas_taps`` at K=32, N=2^18, A=4, L=7 on 1 x 2, 2 x 2, 2 x 1 and 4 x 1,
  ``fused_xla`` and ``xla_bank`` at K=1024, N=32768 on 2 x 2 and 4 x 1),
  each beside its unsharded call, with also a steady call's host ops and
  each card's busy share (``--cards``: this leg alone).

``--dual ROUNDS`` instead times, in this tree and one process, the one-card
``track_bank_dual_sharded`` (one graph for every channel shard) against
``chip_smoke.dual_graph_per_shard`` (a graph per shard) at chan 2 and 4,
ROUNDS rounds of turns one, per shard, per shard, one, each turn the median
of 20 10-block calls; it prints each turn and the medians.

The script prints one JSON line per turn and, last, the medians of each
metric per tree; ``--out`` also writes them as JSON. The old tree is not
part of the repository; put it in a directory that ``.gitignore`` lists,
such as ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
BLOCKS = 10


def channel_bank_case(algorithm: str, num_k: int = 32, n: int = 1 << 18, num_ants=4,
                      taps: int = 7, blocks: int = BLOCKS, device="cuda"):
    """A GPS L1 bank of ``num_k`` channels (PRN k mod 32) over ``blocks``
    noiseless 1 ms blocks of ``n`` samples (fs = n kHz) on ``num_ants``
    antennas (None: ``[B, N]`` planes), PRNs 0-2 in the signal at -900,
    100 and 1500 Hz and the other channels' Dopplers spread over +-4 kHz,
    ``taps`` correlators: ``(config, codes, states, sre, sim)`` for
    ``algorithm``. By default the per-channel kernels' sharded shape, the
    top corner of the paper's sweep (K=32, N=2^18, A=4, L=7); K=1024,
    N=32768, A=None, L=3 is the batched correlators'."""
    import numpy as np
    import torch

    from gpuacceleratedtracking_tpu_torch.models import GPSL1, gen_signal_mixed, soa
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, init_state

    system = GPSL1()
    dops = np.linspace(-4000.0, 4000.0, num_k)
    dops[:3] = [-900.0, 100.0, 1500.0]
    sig, fs = gen_signal_mixed(system, [0, 1, 2], dops[:3], n * blocks, num_ants=num_ants,
                               duration=blocks * 1e-3, device=device)
    if num_ants:
        sre, sim = (x.reshape(num_ants, blocks, n).transpose(0, 1).contiguous()
                    for x in soa(sig))
    else:
        sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    del sig
    config = TrackConfig.for_system(system, fs, n, num_correlators=taps, algorithm=algorithm)
    states = init_state(np.arange(num_k) % 32, carrier_doppler=dops, num_taps=taps,
                        device=device)
    return config, torch.as_tensor(system.codes, device=device), states, sre, sim


# The correlators without code tiles on distinct cards: algorithm ->
# (`channel_bank_case`'s shape, the meshes beside the unsharded call).
CHANNEL_RUNS = {
    "pallas_fused": ({}, ((1, 2), (2, 2), (2, 1), (4, 1))),
    "pallas_taps": ({}, ((1, 2), (2, 2), (2, 1), (4, 1))),
    "fused_xla": (dict(num_k=1024, n=1 << 15, num_ants=None, taps=3), ((2, 2), (4, 1))),
    "xla_bank": (dict(num_k=1024, n=1 << 15, num_ants=None, taps=3), ((2, 2), (4, 1))),
}


def cards_leg(system, codes, sre, sim, states, rows) -> dict:
    """``track_bank_sharded`` of the rows bank on meshes of distinct cards
    (every mesh the visible cards hold: 4 x 1, 2 x 2, 2 x 1, 1 x 2 at K=1024,
    4 x 1 at K=4096) and the unsharded K=1024 and K=4096 banks on one card:
    ms and device ops per block of 10-block calls. Then the correlators
    without code tiles of `CHANNEL_RUNS`, unsharded and on their meshes
    that the cards hold: ms and device ops per block, a steady call's host
    ops (`chip_smoke.host_ops`: dispatched ops, CUDA runtime calls) and each
    card's busy share (`bench.profile.profile_calls`)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpuacceleratedtracking_tpu_torch.bench.profile import profile_calls
    from gpuacceleratedtracking_tpu_torch.parallel import make_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import init_state, track_bank

    cards = torch.cuda.device_count()
    num_k = 4 * cs.NUM_K
    dops = np.linspace(-4000.0, 4000.0, num_k)
    dops[:len(cs.SAT_DOPPLERS)] = cs.SAT_DOPPLERS
    phases = np.zeros(num_k)
    phases[:len(cs.SAT_CODE_PHASES)] = cs.SAT_CODE_PHASES
    states4k = init_state(np.arange(num_k) % 32, carrier_doppler=dops, code_phase=phases,
                          device="cuda")
    runs = {"unsharded_rows_K1024": lambda: track_bank(rows, codes, states, sre, sim),
            "unsharded_rows_K4096": lambda: track_bank(rows, codes, states4k, sre, sim)}
    for chan, time_, st, k in ((4, 1, states, 1024), (2, 2, states, 1024),
                               (2, 1, states, 1024), (1, 2, states, 1024),
                               (4, 1, states4k, 4096)):
        if chan * time_ <= cards:
            mesh = make_mesh({"chan": chan, "time": time_},
                             devices=[torch.device("cuda", i) for i in range(chan * time_)])
            runs[f"cards_{chan}x{time_}_rows_K{k}"] = (
                lambda m=mesh, st=st: track_bank_sharded(rows, codes, st, sre, sim, mesh=m))
    result = {}
    for name, run in runs.items():
        result[f"{name}_block_ms"] = cs.time_cuda(run, warmup=2)[0] / BLOCKS
        result[f"{name}_device_ops_per_block"] = cs.device_profile(run, calls=2)[0] / BLOCKS
    for algorithm, (shape, meshes) in CHANNEL_RUNS.items():
        config, codes_a, states_a, sre_a, sim_a = channel_bank_case(algorithm, **shape)
        label = (f"{algorithm.removeprefix('pallas_')}_K{states_a.prn.shape[0]}"
                 f"_A{sre_a.shape[1] if sre_a.ndim == 3 else 1}_L{len(config.sample_shifts)}")
        calls = {f"unsharded_{label}": lambda st, c=config: track_bank(c, codes_a, st, sre_a,
                                                                       sim_a)}
        for chan, time_ in meshes:
            if chan * time_ <= cards:
                mesh = make_mesh({"chan": chan, "time": time_},
                                 devices=[torch.device("cuda", i) for i in range(chan * time_)])
                calls[f"cards_{chan}x{time_}_{label}"] = (
                    lambda st, c=config, m=mesh: track_bank_sharded(c, codes_a, st, sre_a,
                                                                    sim_a, mesh=m))
        for name, call in calls.items():
            run = lambda call=call: call(states_a)   # noqa: E731
            result[f"{name}_block_ms"] = cs.time_cuda(run, warmup=2)[0] / BLOCKS
            result[f"{name}_device_ops_per_block"] = cs.device_profile(run, calls=2)[0] / BLOCKS
            ops = cs.host_ops(call, states_a)
            result[f"{name}_host_ops_per_call"] = ops["dispatched_ops"]
            result[f"{name}_runtime_calls_per_call"] = sum(ops["runtime_calls"].values())
            busy = profile_calls(run, reps=5, label=name)["device_timeline"]["per_device"]
            for card, line in busy.items():
                result[f"{name}_card{card}_busy_share"] = line["busy_share"]
        del sre_a, sim_a
    return result


def measure(root: pathlib.Path, cards_only: bool = False) -> dict:
    """One turn, inside the process that imports ``root``'s package (with
    ``cards_only``, `cards_leg` alone)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpuacceleratedtracking_tpu_torch.bench import run_track_benchmark
    from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import _build
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, init_state, loop_update, track, track_bank, track_bank_dual)

    _build.build()
    system = GPSL1()
    codes = torch.as_tensor(system.codes, device="cuda")
    sre, sim, _ = cs.mixed_blocks(system, BLOCKS)
    states = cs.bank_states(system, init_errors=False)
    rows = TrackConfig.for_system(system, cs.L1_FS, cs.N_1MS, algorithm="pallas_bank_auto")
    if cards_only:
        return dict({"tree": str(root), "card": cs.nvidia_smi()},
                    **cards_leg(system, codes, sre, sim, states, rows))
    fused = TrackConfig.for_system(system, cs.L1_FS, cs.N_1MS, algorithm="pallas_fused")
    one = init_state(5, carrier_doppler=float(cs.SAT_DOPPLERS[5]) + 20.0,
                     code_phase=float(cs.SAT_CODE_PHASES[5]) - 0.2, device="cuda")
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    rng = np.random.default_rng(2)
    offsets = rng.integers(0, 20, len(cs.L5_PRNS))
    navs = rng.choice([-1.0, 1.0], (len(cs.L5_PRNS), (20 + BLOCKS) // 10 + 1))
    gen = torch.Generator(device="cuda").manual_seed(2)
    s5re, s5im = cs.l5_dual_blocks(BLOCKS, offsets, navs, gen)
    cfg5 = dual_config(TrackConfig.for_system(sys_i, cs.L1_FS, cs.N_1MS,
                                              algorithm="pallas_bank_auto", use_secondary=False))
    states5 = cs.dual_states(offsets, cs.L5_DOPPLERS)
    codes_i = torch.as_tensor(sys_i.codes, device="cuda")
    codes_q = torch.as_tensor(sys_q.codes, device="cuda")
    paths = {
        "rows_K1024": lambda: track_bank(rows, codes, states, sre, sim),
        "l5_dual_K64": lambda: track_bank_dual(cfg5, codes_i, codes_q, states5, s5re, s5im),
        "track_fused": lambda: track(fused, codes, one, sre, sim),
    }
    result = {"tree": str(root), "card": cs.nvidia_smi()}
    acc = torch.randn((cs.NUM_K, 3), generator=gen, device="cuda") * 1000.0
    result["loop_update_ms"] = cs.graph_ms(lambda: loop_update(rows, states, acc, acc))[0]
    for name, run in paths.items():
        result[f"{name}_block_ms"] = cs.time_cuda(run, warmup=2)[0] / BLOCKS
        result[f"{name}_device_ops_per_block"] = cs.device_profile(run, calls=2)[0] / BLOCKS
    one_block = lambda: track_bank(rows, codes, states, sre[:1], sim[:1])  # noqa: E731
    result["one_block_K1024_ms"] = cs.time_cuda(one_block, warmup=2)[0]
    ops, device_ms, names = cs.device_profile(one_block, calls=5, by_name=True)
    result["one_block_K1024_device_ops_per_block"] = ops
    result["one_block_K1024_device_ms"] = device_ms
    result["one_block_K1024_device_ms_by_name"] = {name: ms for name, (_, ms) in names.items()}
    # The rows entry's prologue alone: 20 replays back to back (CUDA events:
    # a replay's host issue included where it is the longer), and its device
    # ops and their summed device time per replay (torch.profiler).
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    entry = list(graphs._ENTRIES[torch.device("cuda", torch.cuda.current_device())].values())[-1]
    result["prologue_replay_ms"] = cs.time_cuda(
        lambda: [entry.prologue() for _ in range(20)], warmup=2)[0] / 20
    ops, device_ms = cs.device_profile(entry.prologue, calls=20)
    result["prologue_device_ops_per_block"] = ops
    result["prologue_device_ms"] = device_ms
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded

    are, aim, _ = cs.mixed_blocks(system, BLOCKS, num_ants=cs.NUM_ANTS)
    states7 = cs.bank_states(system, init_errors=False, num_taps=7)
    array = TrackConfig.for_system(system, cs.L1_FS, cs.N_1MS, num_correlators=7,
                                   algorithm="pallas_bank_auto")
    meshes = {f"{c}x{t}": channel_time_mesh(c, t, devices=cs.mesh_devices(c * t))
              for c, t in ((2, 2), (2, 1), (1, 2))}
    sharded = {f"mesh_{key}_rows_K1024": (lambda m=mesh: track_bank_sharded(
        rows, codes, states, sre, sim, mesh=m)) for key, mesh in meshes.items()}
    sharded["array_K1024_A4_L7"] = lambda: track_bank(array, codes, states7, are, aim)
    sharded["mesh_2x2_array_K1024_A4_L7"] = lambda: track_bank_sharded(
        array, codes, states7, are, aim, mesh=meshes["2x2"])
    for name, run in sharded.items():
        result[f"{name}_block_ms"] = cs.time_cuda(run, warmup=2)[0] / BLOCKS
        result[f"{name}_device_ops_per_block"] = cs.device_profile(run, calls=2)[0] / BLOCKS
    _, block = cs.replay_op_names(sharded["mesh_2x2_rows_K1024"])
    result["mesh_2x2_rows_K1024_replayed_block_ops_per_block"] = sum(block.values()) / cs.REPLAYS
    result["mesh_2x2_rows_K1024_replayed_block_by_name"] = dict(block)
    if torch.cuda.device_count() > 1:
        result.update(cards_leg(system, codes, sre, sim, states, rows))
    r = run_track_benchmark({"GNSS": "GPSL1", "num_samples": cs.N_1MS,
                             "num_channels": cs.NUM_K, "algorithm": "pallas_bank_auto",
                             "processor": "GPU", "blocks": 8, "trials": 7})
    result["replayed_rows_block_ms"] = r["Median"] * 1e3
    return result


def dual_pairs(rounds: int) -> dict:
    """The one-card sharded GPS L5 dual bank, one graph for every channel
    shard against a graph per shard, in turns (one, per shard, per shard,
    one) ``rounds`` times at chan 2 and 4: ms per block of each turn (the
    median of 20 10-block calls) and the medians."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpuacceleratedtracking_tpu_torch.models import GPSL5
    from gpuacceleratedtracking_tpu_torch.ops import _build
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_dual_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, dual_config

    _build.build()
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    rng = np.random.default_rng(2)
    offsets = rng.integers(0, 20, len(cs.L5_PRNS))
    navs = rng.choice([-1.0, 1.0], (len(cs.L5_PRNS), (20 + BLOCKS) // 10 + 1))
    gen = torch.Generator(device="cuda").manual_seed(2)
    s5re, s5im = cs.l5_dual_blocks(BLOCKS, offsets, navs, gen)
    cfg5 = dual_config(TrackConfig.for_system(sys_i, cs.L1_FS, cs.N_1MS,
                                              algorithm="pallas_bank_auto", use_secondary=False))
    states5 = cs.dual_states(offsets, cs.L5_DOPPLERS)
    codes_i = torch.as_tensor(sys_i.codes, device="cuda")
    codes_q = torch.as_tensor(sys_q.codes, device="cuda")
    result = {"card": cs.nvidia_smi(), "rounds": rounds}
    for chan in (2, 4):
        mesh = channel_time_mesh(chan, 1, devices=cs.mesh_devices(chan))
        runs = {
            "one_graph": lambda: track_bank_dual_sharded(cfg5, codes_i, codes_q, states5, s5re,
                                                         s5im, mesh=mesh),
            "per_shard": lambda: cs.dual_graph_per_shard(cfg5, codes_i, codes_q, states5, s5re,
                                                         s5im, chan),
        }
        cs.bitwise(f"dual chan {chan}: one graph against a graph per shard", runs["one_graph"](),
                   runs["per_shard"]())
        turns = {name: [] for name in runs}
        for _ in range(rounds):
            for name in ("one_graph", "per_shard", "per_shard", "one_graph"):
                turns[name].append(cs.time_cuda(runs[name], warmup=1)[0] / BLOCKS)
        for name, times in turns.items():
            result[f"chan{chan}_{name}_block_ms"] = statistics.median(times)
            result[f"chan{chan}_{name}_block_ms_min"] = min(times)
            result[f"chan{chan}_{name}_block_ms_max"] = max(times)
            result[f"chan{chan}_{name}_turns"] = times
        print(json.dumps({k: v for k, v in result.items() if k.startswith(f"chan{chan}")}),
              flush=True)
    return result


def turn(root: pathlib.Path, cards_only: bool = False) -> dict:
    """A turn in a process of its own, with ``root`` first on its path."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, str(ROOT / "block_ab.py"), "--measure", str(root)]
                          + (["--cards"] if cards_only else []),
                          cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", help="an earlier checkout of the repository")
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--rounds", type=int, default=1,
                        help="rounds of turns old, new, new, old (default 1)")
    parser.add_argument("--dual", type=int, metavar="ROUNDS",
                        help="time the one-card dual bank's two graph layouts instead")
    parser.add_argument("--cards", action="store_true",
                        help="time only the rows bank on meshes of distinct cards")
    parser.add_argument("--measure", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dual:
        result = dual_pairs(args.dual)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        print(json.dumps({k: v for k, v in result.items() if not k.endswith("_turns")}))
        return 0
    if args.measure:
        root = pathlib.Path(args.measure).resolve()
        sys.path[:] = [str(root)] + [p for p in sys.path
                                     if p not in ("", str(ROOT), str(root))]
        print(json.dumps(measure(root, args.cards)))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("block_ab needs a CUDA device")
    old = pathlib.Path(args.old).resolve()
    turns = []
    for label, root in (("old", old), ("new", ROOT), ("new", ROOT), ("old", old)) * args.rounds:
        result = dict(turn(root, args.cards), version=label)
        print(json.dumps(result), flush=True)
        turns.append(result)
    keys = [k for k in turns[0]
            if k.endswith(("_ms", "_per_block", "_per_call", "_share")) and k in turns[-1]]
    summary = {label: {k: statistics.median(t[k] for t in turns if t["version"] == label)
                       for k in keys} for label in ("old", "new")}
    summary["card"] = turns[0]["card"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"turns": turns, "median": summary}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
