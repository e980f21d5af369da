#!/usr/bin/env python3
"""Phase J of ``chip_smoke.py`` alone: the distributed layer on the card(s).

Usage: ``python3 parallel_smoke.py [--split] [--spike]``

Builds the kernels, then runs ``chip_smoke.parallel_path``: each kernel at the
shard-local shapes against its plain version, the JAX dry run's two legs, the
K=1024 GPS L1 bank on meshes 2 x 1, 1 x 2 and 2 x 2 with its lock run and
block times, the A=4 L=7 and GPS L5 dual banks sharded, ``correlate_sharded``
on the per-channel kernels and the one-hot route. The meshes take every
visible card in turn, or repeat ``cuda:0`` on a one-card machine, so on a
machine with several cards this is the check of the cross-device path
without the rest of the smoke run. Then the sharded banks' captured block
loops (`graph_leg`): on distinct cards a bank route runs
`graphs.scan_mesh`, each channel shard's block one CUDA graph over its time
shards' cards; each mesh once under ``tracking.eager()`` and once through
the graphs, equal bit for bit with equal launch counts, both block times, a
steady call's host ops and each card's busy share; the correlators without
code tiles take the same path (`parallel/bank.py::_card_step_without_tiles`):
``pallas_fused`` and ``pallas_taps`` at K=32, N=2^18, A=4, L=7 on 1 x 2,
2 x 2, 2 x 1 and 4 x 1, ``fused_xla`` and ``xla_bank`` at K=1024, N=32768 on
2 x 2 and 4 x 1, each beside its unsharded call, with the device ops of a
replayed block card by card on distinct cards. ``--split`` runs only
`split_leg` (where a 10-block call's time goes, card by card), ``--spike``
only `ordering_spike` (the two cross-card orderings of a time-sharded
block). Exits nonzero on any failed check.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

import chip_smoke


def replayed_ops_per_card(mesh) -> dict:
    """The device ops of one replayed block of the mesh call's `_MeshEntry`
    (its latest), card by card: ``{card: {name: ops per block}}``
    (`chip_smoke.traced_ops` over ``REPLAYS`` replays of every group's
    graph)."""
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    entry = list(graphs._ENTRIES[tuple(mesh.devices.flat)].values())[-1]
    ops = chip_smoke.traced_ops(lambda: [replay() for replay, _ in entry.replays],
                                by_card=True)
    per_card: dict = {}
    for (index, name), count in ops.items():
        per_card.setdefault(index, {})[name] = count / chip_smoke.REPLAYS
    return per_card


def graph_leg(system, sre, sim, sre5, sim5, offsets, card, blocks: int = 10):
    """The K=1024 GPS L1 bank unsharded and on meshes 4 x 1, 2 x 2, 2 x 1 and
    1 x 2, the K=4096 bank unsharded and on 4 x 1, the K=64 GPS L5 dual
    bank on chan 4, and the correlators without code tiles of
    `block_ab.CHANNEL_RUNS` unsharded and on their meshes, over ``blocks``
    noiseless blocks: graph against eager, bit for bit, launches alike; both
    block times; a steady call's host ops (`chip_smoke.host_ops`, each call from
    the last one's final state) and each card's busy share over graph calls
    (`bench.profile.profile_calls`, ``per_device``); for a correlator
    without tiles on distinct cards, its replayed block's device ops card
    by card (`replayed_ops_per_card`)."""
    from block_ab import CHANNEL_RUNS, channel_bank_case
    from gpuacceleratedtracking_tpu_torch.bench.profile import profile_calls
    from gpuacceleratedtracking_tpu_torch.models import GPSL5
    from gpuacceleratedtracking_tpu_torch.parallel import (
        channel_time_mesh, track_bank_dual_sharded, track_bank_sharded)
    from gpuacceleratedtracking_tpu_torch.tracking import (
        TrackConfig, dual_config, eager, track_bank)

    codes = torch.as_tensor(system.codes, device=chip_smoke.DEVICE)
    config = TrackConfig.for_system(system, chip_smoke.L1_FS, chip_smoke.N_1MS,
                                    algorithm="pallas_bank_auto")
    states = chip_smoke.bank_states(system, init_errors=False)
    states4k = chip_smoke.bank_states(system, init_errors=False, num_k=4 * chip_smoke.NUM_K)
    sre, sim, sre5, sim5 = sre[:blocks], sim[:blocks], sre5[:blocks], sim5[:blocks]
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    codes_i = torch.as_tensor(sys_i.codes, device=chip_smoke.DEVICE)
    codes_q = torch.as_tensor(sys_q.codes, device=chip_smoke.DEVICE)
    cfg5 = dual_config(TrackConfig.for_system(sys_i, chip_smoke.L1_FS, chip_smoke.N_1MS,
                                              algorithm="pallas_bank_auto",
                                              use_secondary=False))
    states5 = chip_smoke.dual_states(offsets, chip_smoke.L5_DOPPLERS)
    # name -> (a call from a state, its start state, channels)
    runs = {"rows unsharded": (lambda st: track_bank(config, codes, st, sre, sim), states,
                               chip_smoke.NUM_K)}
    for chan, time_ in ((4, 1), (2, 2), (2, 1), (1, 2)):
        mesh = channel_time_mesh(chan, time_, devices=chip_smoke.mesh_devices(chan * time_))
        runs[f"rows mesh {chan}x{time_}"] = (
            lambda st, m=mesh: track_bank_sharded(config, codes, st, sre, sim, mesh=m),
            states, chip_smoke.NUM_K)
    mesh4 = channel_time_mesh(4, 1, devices=chip_smoke.mesh_devices(4))
    runs["rows K=4096 unsharded"] = (lambda st: track_bank(config, codes, st, sre, sim),
                                     states4k, 4 * chip_smoke.NUM_K)
    runs["rows K=4096 mesh 4x1"] = (
        lambda st: track_bank_sharded(config, codes, st, sre, sim, mesh=mesh4), states4k,
        4 * chip_smoke.NUM_K)
    runs["L5 dual mesh chan 4"] = (
        lambda st: track_bank_dual_sharded(cfg5, codes_i, codes_q, st, sre5, sim5, mesh=mesh4),
        states5, chip_smoke.DUAL_K)
    meshes = {}                 # run name -> its mesh, where its replayed block is counted
    for algorithm, (shape, axes) in CHANNEL_RUNS.items():
        cfg, codes_c, states_c, sre_c, sim_c = channel_bank_case(algorithm, blocks=blocks,
                                                                 **shape)
        num_k = states_c.prn.shape[0]
        num_ants = sre_c.shape[1] if sre_c.ndim == 3 else 1
        label = f"{algorithm} K={num_k} N={cfg.num_samples} A={num_ants} L={len(cfg.sample_shifts)}"
        runs[f"{label} unsharded"] = (
            lambda st, c=cfg, x=(codes_c, sre_c, sim_c): track_bank(c, x[0], st, x[1], x[2]),
            states_c, num_k)
        for chan, time_ in axes:
            mesh = channel_time_mesh(chan, time_, devices=chip_smoke.mesh_devices(chan * time_))
            name = f"{label} mesh {chan}x{time_}"
            runs[name] = (lambda st, c=cfg, m=mesh, x=(codes_c, sre_c, sim_c):
                          track_bank_sharded(c, x[0], st, x[1], x[2], mesh=m), states_c, num_k)
            if len({str(d) for d in mesh.devices.flat}) > 1:
                meshes[name] = mesh
    results = {}
    for name, (call, start, channels) in runs.items():
        run = lambda call=call, start=start: call(start)   # noqa: E731
        with eager():
            want, eager_counts = chip_smoke.counted(run)
        got, graph_counts = chip_smoke.counted(run)
        chip_smoke.check(graph_counts == eager_counts,
                         f"[J graph] {name}: launches {graph_counts} against {eager_counts}")
        chip_smoke.bitwise(f"[J graph] {name}", got, want)
        with eager():
            e_med, e_min = chip_smoke.time_cuda(run, warmup=1)
        g_med, g_min = chip_smoke.time_cuda(run, warmup=1)
        ops = chip_smoke.host_ops(call, start)
        busy = profile_calls(run, reps=5, label=f"graph {name}")["device_timeline"]
        results[name] = {"eager_block_ms": e_med / blocks, "graph_block_ms": g_med / blocks,
                         "eager_block_min_ms": e_min / blocks,
                         "graph_block_min_ms": g_min / blocks,
                         "host_dispatched_ops": ops["dispatched_ops"],
                         "host_runtime_calls": ops["runtime_calls"],
                         "device_ops_per_call": ops["device_ops"],
                         "busy_share_per_card": {k: v["busy_share"]
                                                 for k, v in busy["per_device"].items()}}
        if name in meshes:
            results[name]["replayed_ops_per_card"] = replayed_ops_per_card(meshes[name])
            print(f"[J graph] {name}: a replayed block's device ops per card "
                  f"{json.dumps(results[name]['replayed_ops_per_card'])} [{card}]", flush=True)
        print(f"[J graph] {name} on {torch.cuda.device_count()} card(s): graph equals eager "
              f"bit for bit, launches per call {dict((k, v) for k, v in graph_counts.items() if v)}; "
              f"block eager {e_med / blocks!r} ms (min {e_min / blocks!r}), graph "
              f"{g_med / blocks!r} ms (min {g_min / blocks!r}); real-time channels eager "
              f"{channels * blocks / e_med!r}, graph {channels * blocks / g_med!r}; a steady "
              f"call's host: {ops['dispatched_ops']} dispatched ops, runtime calls "
              f"{ops['runtime_calls']}, {ops['device_ops']} device ops; busy share per card "
              f"{results[name]['busy_share_per_card']} [{card}]", flush=True)
    return results


SPLIT_MESHES = ((4, 1), (2, 2), (2, 1), (1, 2))


def split_leg(system, sre, sim, card, blocks: int = 10, reps: int = 5) -> dict:
    """Where a 10-block K=1024 GPS L1 rows call's time goes on each mesh of
    `SPLIT_MESHES` that the visible cards hold (and unsharded): the host's
    own time per call, each card's device, copy and idle time per call and
    busy share (`bench.profile.profile_calls`, ``per_device``), and the
    call's host ops (`chip_smoke.host_ops`: dispatched ops, CUDA runtime
    calls, device ops), each call from the last one's final state."""
    from gpuacceleratedtracking_tpu_torch.bench.profile import profile_calls
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, track_bank

    codes = torch.as_tensor(system.codes, device=chip_smoke.DEVICE)
    config = TrackConfig.for_system(system, chip_smoke.L1_FS, chip_smoke.N_1MS,
                                    algorithm="pallas_bank_auto")
    states = chip_smoke.bank_states(system, init_errors=False)
    sre, sim = sre[:blocks], sim[:blocks]
    runs = {"unsharded": lambda st: track_bank(config, codes, st, sre, sim)}
    for chan, time_ in SPLIT_MESHES:
        if chan * time_ <= torch.cuda.device_count():
            mesh = channel_time_mesh(chan, time_, devices=chip_smoke.mesh_devices(chan * time_))
            runs[f"{chan}x{time_}"] = (lambda st, m=mesh: track_bank_sharded(
                config, codes, st, sre, sim, mesh=m))
    results = {}
    for name, run in runs.items():
        prof = profile_calls(lambda: run(states), reps=reps, label=f"split {name}")
        line = prof["device_timeline"]
        ops = chip_smoke.host_ops(run, states)
        ops.pop("dispatched_by_name")
        results[name] = {
            "wall_per_call_ms": prof["per_call_ms"],
            "host_per_call_ms": prof["host_per_call_ms"],
            "window_per_call_ms": line["window_per_call_ms"],
            "busy_share": line["busy_share"], "per_device": line["per_device"],
            "host_ops": ops}
        print(f"[J split] rows K={chip_smoke.NUM_K} {blocks}-block call, {name}: "
              f"{json.dumps(results[name])} [{card}]", flush=True)
    return results


def ordering_spike(blocks: int = 10, reps: int = 20, n: int = 1 << 16,
                   m: int = 1 << 14) -> dict:
    """The two ways of ordering a time-sharded block across cards, on a
    stand-in block: the cards in pairs (a channel shard's two time shards),
    each card writes a partial of its replica of a state, copies it to its
    peer, and both add the two partials in order into their replicas. (a)
    One CUDA graph over every card (`graphs.capture_mesh`), replayed once
    per block; (b) a graph per card for each side of the exchange, replayed
    per block with events between the cards' streams (the host issue of
    that design; its copies left out). Prints and returns ms per block
    (CUDA events on the first card around ``blocks`` blocks, median of
    ``reps``), the host's issue time per block, and whether (a) equals the
    eager block bit for bit with every pair's replicas equal."""
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    result = {"torch": torch.__version__, "cuda": torch.version.cuda, "cards": len(cards),
              "mem_pool": hasattr(torch.cuda, "use_mem_pool")}
    if len(cards) < 2:
        print(f"[J spike] {json.dumps(result)}: needs two cards", flush=True)
        return result
    cards = cards[:len(cards) // 2 * 2]
    peer = {i: i ^ 1 for i in range(len(cards))}
    gen = torch.Generator(device="cuda").manual_seed(7)
    start = torch.randn(n, generator=gen, device=cards[0])
    xs = [torch.empty(n, device=d) for d in cards]
    slots = [torch.zeros((2, m), device=d) for d in cards]

    def reset():
        for x in xs:
            x.copy_(start)
        for d in cards:
            torch.cuda.synchronize(d)

    def block():
        for i, d in enumerate(cards):
            with torch.cuda.device(d):
                torch.sin(xs[i][(i % 2) * m:(i % 2 + 1) * m], out=slots[i][i % 2])
                slots[peer[i]][i % 2].copy_(slots[i][i % 2])
        for i, d in enumerate(cards):
            with torch.cuda.device(d):
                xs[i][:m].add_(slots[i][0] + slots[i][1])

    def fence():
        for d in cards:
            torch.cuda.synchronize(d)

    def timed(run) -> tuple:
        times, hosts = [], []
        for _ in range(reps):
            fence()
            t0 = time.perf_counter()
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record(torch.cuda.current_stream(cards[0]))
            run()
            hosts.append((time.perf_counter() - t0) * 1e3 / blocks)
            for d in cards[1:]:
                torch.cuda.current_stream(cards[0]).wait_stream(torch.cuda.current_stream(d))
            end.record(torch.cuda.current_stream(cards[0]))
            end.synchronize()
            times.append(begin.elapsed_time(end) / blocks)
        return float(np.median(times)), float(np.median(hosts))

    reset()
    for _ in range(blocks):
        block()
    fence()
    want = [x.clone() for x in xs]
    reset()
    try:
        replay = graphs.capture_mesh(block, cards)
        reset()
        for _ in range(blocks):
            replay()
        fence()
        equal = all(torch.equal(x, w) for x, w in zip(xs, want))
        pairs = all(torch.equal(xs[i].cpu(), xs[peer[i]].cpu()) for i in range(len(cards)))
        ms, host = timed(lambda: [replay() for _ in range(blocks)])
        result["a"] = {"ok": True, "equal": equal, "pairs_equal": pairs, "block_ms": ms,
                       "host_ms_per_block": host}
    except Exception as err:  # noqa: BLE001 - the spike reports what failed
        result["a"] = {"ok": False, "error": f"{type(err).__name__}: {err}"[:400]}
    reset()
    graphs_a, graphs_b = [], []
    for i, d in enumerate(cards):
        with torch.cuda.device(d):
            side = torch.cuda.Stream(d)
            with torch.cuda.stream(side):
                ga, gb = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
                with torch.cuda.graph(ga, stream=side):
                    torch.sin(xs[i][(i % 2) * m:(i % 2 + 1) * m], out=slots[i][i % 2])
                with torch.cuda.graph(gb, stream=side):
                    xs[i][:m].add_(slots[i][0] + slots[i][1])
        graphs_a.append(ga)
        graphs_b.append(gb)
    done_a = [torch.cuda.Event() for _ in cards]
    done_b = [torch.cuda.Event() for _ in cards]
    streams = [torch.cuda.current_stream(d) for d in cards]

    def per_card():
        for _ in range(blocks):
            for i, d in enumerate(cards):
                with torch.cuda.device(d):
                    streams[i].wait_event(done_b[peer[i]])
                    graphs_a[i].replay()
                    done_a[i].record(streams[i])
            for i, d in enumerate(cards):
                with torch.cuda.device(d):
                    streams[i].wait_event(done_a[peer[i]])
                    graphs_b[i].replay()
                    done_b[i].record(streams[i])

    for i, d in enumerate(cards):
        done_b[i].record(streams[i])
    ms, host = timed(per_card)
    result["b"] = {"block_ms": ms, "host_ms_per_block": host}
    print(f"[J spike] {json.dumps(result)}", flush=True)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--split", action="store_true",
                        help="only the host/copy/device split of the rows meshes")
    parser.add_argument("--spike", action="store_true",
                        help="only the two cross-card orderings of a time-sharded block")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("parallel_smoke needs a CUDA device")
    from gpuacceleratedtracking_tpu_torch.models import GPSL1
    from gpuacceleratedtracking_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    print(f"[device] {torch.cuda.device_count()} x {card}", flush=True)
    if args.spike:
        ordering_spike()
    _build.build()
    for stem in _build.SIGNATURES:
        _build.load_library(stem)
    system = GPSL1()
    sre, sim, _ = chip_smoke.mixed_blocks(system, 20)
    if args.split:
        split_leg(system, sre, sim, card)
    if args.split or args.spike:
        return 0
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
