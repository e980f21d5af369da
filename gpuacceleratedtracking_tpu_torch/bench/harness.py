"""Benchmark harness: kernel, closed-loop, reduction and replica benchmarks,
dict-driven.

Port of `gpuacceleratedtracking_tpu.bench.harness` with the same config keys
(``processor / GNSS / num_samples / num_ants / num_correlators / algorithm``
…) and the same result keys (``Minimum`` … ``Maximum``, ``realtime_ratio``,
``samples_per_s``, ``realtime_channels``, ``bank_channels``).

``processor`` selects where the tensors live: ``"GPU"`` (the first CUDA
device; a host without one raises) or ``"CPU"``. Any other value raises.

Timing is differential (`timing.benchmark_differential`): one timed call
holds ``reps`` back-to-back calls of the workload, with per-call inputs that
differ (the phase offsets are device tensors, ``offs[i]``, so no
host-to-device copy enters the span), and their running total. As the JAX
harness compiles its reps into one program, on the card a timed call is a
replayed CUDA graph of the reps (`reps_program`, ``reps_mode`` "unroll" or
"scan"), so its per-call time is device time; ``reps_mode="calls"`` issues
each call from Python, the dispatch view.
Acquisition (`run_acquire_benchmark`) times one full PCPS call. The TPU
launch-shape autotuner is not ported (the port's kernels have no launch
knobs).
"""

from __future__ import annotations

import functools
import pathlib
import platform
import subprocess
from typing import Optional

import numpy as np
import torch

from ..models import EPLCorrelator, correlator_sample_shifts, gen_signal, get_system, soa
from ..ops import registry
from ..ops.reduce import get_reduction
from ..ops.replica_kernel import code_replica
from .timing import benchmark, benchmark_differential

REALTIME_BOUND_S = 1e-3  # process 1 ms of signal in under 1 ms
REPS_MODES = ("unroll", "scan", "calls")
SCAN_UNROLL = 4          # reps per graph in run_kernel_benchmark's "scan" (JAX: unroll=4)
REDUCTION_UNROLL = 32    # reps per graph of the reduction and replica benchmarks (unroll=32)


@functools.lru_cache(maxsize=None)
def _git_sha() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=str(pathlib.Path(__file__).parent),
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


@functools.lru_cache(maxsize=None)
def _card() -> tuple[Optional[str], Optional[str]]:
    """The first card's name and power limit as ``nvidia-smi`` reports them,
    or ``(None, None)`` where it is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    name, _, limit = out.rpartition(",")
    return name.strip(), limit.strip()


def add_metadata(results: dict, processor: str, algorithm: str) -> dict:
    """Environment metadata: the host, torch and CUDA versions, and the device
    with, on a GPU, the card's name and power limit from ``nvidia-smi``."""
    gpu = processor.upper() == "GPU"
    name, limit = _card() if gpu else (None, None)
    results.update(
        {
            "os": platform.platform(),
            "cpu_model": platform.processor() or platform.machine(),
            "backend": "cuda" if gpu else "cpu",
            "device_kind": torch.cuda.get_device_name(0) if gpu else platform.machine(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "gpu_name": name,
            "power_limit": limit,
            "processor": processor,
            "algorithm": algorithm,
            "git_sha": _git_sha(),
        }
    )
    return results


def resolve_device(processor: str) -> torch.device:
    """``"GPU"``: the first CUDA device (raises without one); ``"CPU"``."""
    kind = str(processor).upper()
    if kind == "CPU":
        return torch.device("cpu")
    if kind == "GPU":
        if not torch.cuda.is_available():
            raise RuntimeError("processor='GPU' needs a CUDA device; none is available")
        return torch.device("cuda", 0)
    raise ValueError(f"processor must be 'GPU' or 'CPU', got {processor!r}")


def _finish(config: dict, stats, processor: str, algorithm: str, **derived) -> dict:
    results = dict(config)
    results.update(stats.to_dict())
    results.update(derived)
    return add_metadata(results, processor, algorithm)


def _resolve_mode(config: dict, default: str) -> str:
    mode = config.get("reps_mode", default)
    if mode not in REPS_MODES:
        raise ValueError(f"reps_mode is one of {REPS_MODES}, not {mode!r}")
    return mode


def _accumulate(total: torch.Tensor, outs) -> None:
    """``total = total + out.sum()`` for each output in turn, in place: the
    JAX bodies' ``total + are.sum() + aim.sum()``, rounded alike."""
    for out in outs:
        total.add_(out.sum())


def reps_program(step, xs: torch.Tensor, mode: str, unroll: int):
    """A callable that runs ``r = len(xs)`` reps, ``step(xs[i])`` each, and
    returns their running f32 total, a 0-d tensor on ``xs``'s device: the
    port's counterpart of the JAX harness's jitted reps.

    ``step(x)`` returns the rep's outputs, each summed into the total.
    ``mode``: ``"calls"`` issues every rep from Python (the dispatch view);
    on a CUDA device outside `tracking.eager()`, ``"unroll"`` replays one
    CUDA graph of all r reps (JAX: the reps unrolled in one jitted program),
    and ``"scan"`` a graph of ``unroll`` reps ``r // unroll`` times, then one
    of ``r % unroll`` (JAX: ``lax.scan(..., unroll=unroll)``), whose reps read
    their input at a device-side index. Elsewhere every mode runs its reps
    eagerly, as `tracking.graphs.loop` does. The graphs are captured here,
    after one rep run eagerly (the libraries and constant caches are built
    on first use, and a capture may not build them); its launches and the
    captures' are not counted, and each replay adds the launches that its
    capture recorded. A capture that fails raises. A graph reads its inputs
    at the addresses it was captured with, so the callable holds ``step``
    (and, through its closure, the tensors it reads) and ``xs``; the graphs
    and their memory pools live as long as the callable.
    """
    from ..tracking import graphs

    device = xs.device
    num_reps = xs.shape[0]

    def eager():
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(num_reps):
            _accumulate(total, step(xs[i]))
        return total

    if mode == "calls" or not graphs.enabled(device):
        return eager
    with graphs.uncounted():
        step(xs[0])
    torch.cuda.synchronize(device)
    if mode == "unroll":
        static = {}

        def body():
            static["total"] = eager()

        replay, launched = graphs.capture_counted(body, device)
        total = static["total"]

        def run():
            replay()
            graphs.count_replays(launched)
            return total

        run.inputs = (step, xs)
        return run

    total = torch.zeros((), dtype=torch.float32, device=device)
    index = torch.zeros((), dtype=torch.int64, device=device)

    def scan_body(reps):
        def body():
            for _ in range(reps):
                _accumulate(total, step(torch.index_select(xs, 0, index.view(1))[0]))
                index.add_(1)

        return graphs.capture_counted(body, device)

    full, rest = divmod(num_reps, unroll)
    programs = [(scan_body(unroll), full)] if full else []
    if rest:
        programs.append((scan_body(rest), 1))

    def run():
        total.zero_()
        index.zero_()
        for (replay, launched), times in programs:
            for _ in range(times):
                replay()
            graphs.count_replays(launched, times)
        return total

    run.inputs = (step, xs)
    return run


def _kernel_case(config: dict) -> dict:
    """`run_kernel_benchmark`'s scenario: its keys resolved, the signal, and
    ``step(off)``, one correlator call with the phase offset ``off`` (a
    device tensor: ``[1]`` for the bank signature, 0-d else)."""
    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    num_ants = int(config.get("num_ants", 1))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "fused_xla")
    processor = config.get("processor", "GPU")
    reps = config.get("reps", 20)
    if reps == "auto":
        # More calls at small N, where one call is tens of microseconds.
        reps = int(min(128, max(8, (1 << 22) // num_samples)))
    device = resolve_device(processor)

    fs = num_samples / 1e-3
    shifts = tuple(int(s) for s in correlator_sample_shifts(
        system, EPLCorrelator(num_correlators), fs))
    signal, _ = gen_signal(system, 0, 1500.0, num_samples, num_ants=num_ants,
                           device=device)
    sre, sim = soa(signal)
    codes = torch.as_tensor(system.codes, device=device)
    corr = functools.partial(registry.get(algorithm), sample_shifts=shifts,
                             code_length=system.code_length)
    if algorithm == "pallas_bank":
        corr = functools.partial(corr, nominal_code_frequency=system.code_frequency)
    # Channel parameters as device tensors: [1] for the bank signature (K=1,
    # so the sweep covers every registry algorithm on equal terms), 0-d else.
    shape = (1,) if algorithm in registry.BANK_ALGORITHMS else ()
    prn = torch.zeros(shape, dtype=torch.int32, device=device)
    fcar = torch.full(shape, 1500.0, dtype=torch.float32, device=device)
    fcode = torch.full(shape, system.code_frequency, dtype=torch.float32, device=device)

    def step(off):
        return corr(sre, sim, codes, prn, fcar, fs, off, fcode, off)

    return dict(num_samples=num_samples, num_ants=num_ants, algorithm=algorithm,
                processor=processor, reps=int(reps), trials=int(config.get("trials", 7)),
                reps_mode=_resolve_mode(config, "unroll"), device=device, shape=shape,
                step=step)


def _kernel_program(case: dict, reps: int):
    offs = torch.linspace(0.0, 0.1, reps, dtype=torch.float32, device=case["device"])
    return reps_program(case["step"], offs.reshape((reps,) + case["shape"]),
                        case["reps_mode"], SCAN_UNROLL)


def kernel_program(config: dict, reps: int):
    """The callable that one timed call of `run_kernel_benchmark` makes for
    ``config`` with ``reps`` reps (per-rep phase offsets
    ``linspace(0, 0.1, reps)``, as the JAX harness's): it returns the reps'
    running total of ``are.sum() + aim.sum()``."""
    return _kernel_program(_kernel_case(config), int(reps))


def run_kernel_benchmark(config: dict) -> dict:
    """Benchmark one correlator algorithm for one scenario dict.

    Keys: ``GNSS`` ("GPSL1"/"GPSL5"), ``num_samples``, ``num_ants``,
    ``num_correlators``, ``algorithm`` (registry name), ``processor``
    ("GPU"/"CPU"), optional ``reps`` (or ``"auto"``), ``trials`` and
    ``reps_mode`` (`reps_program`: ``"unroll"``, the default, ``"scan"`` or
    ``"calls"``). Bank algorithms run at K=1. Times are per call.
    """
    case = _kernel_case(config)
    reps = case["reps"]
    stats = benchmark_differential(lambda r: (_kernel_program(case, r), ()), reps,
                                   trials=case["trials"])
    # Derived rates use the median: a differential minimum can clamp to 0.
    floor = max(stats.median, 1e-9)
    return _finish(config, stats, case["processor"], case["algorithm"], reps_resolved=reps,
                   reps_mode=case["reps_mode"], realtime_ratio=floor / REALTIME_BOUND_S,
                   samples_per_s=case["num_samples"] * case["num_ants"] / floor)


def _blocks(signal: torch.Tensor, num_blocks: int, num_samples: int):
    """``[B, N]`` or ``[B, A, N]`` contiguous planes of a ``[A, B*N]`` signal."""
    sre, sim = soa(signal)
    num_ants = sre.shape[0]
    if num_ants == 1:
        return sre.reshape(num_blocks, num_samples), sim.reshape(num_blocks, num_samples)
    return tuple(x.reshape(num_ants, num_blocks, num_samples).transpose(0, 1).contiguous()
                 for x in (sre, sim))


def run_track_benchmark(config: dict) -> dict:
    """Benchmark the closed tracking loop: per-block correlate + DLL/PLL/FLL.

    One timed unit is a 1 ms block of a K-channel bank through `track_bank`:
    bank correlation, discriminators, loop filters and NCO advance. Keys:
    ``GNSS``, ``num_samples`` (per block), ``num_channels``, ``num_ants``,
    ``num_correlators``, ``algorithm`` (bank algorithms run one kernel launch
    per block), ``processor``, optional ``blocks``/``trials``. Timing is
    differential over B vs 2B blocks; times are per block. On the GPU each
    block is one replay of the captured block body (`tracking.graphs`), as
    the JAX harness times its `lax.scan`: B and 2B blocks share one graph,
    captured in `benchmark_differential`'s warm-up call, never in a timed one.
    """
    from ..tracking import TrackConfig, init_state, track_bank

    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    num_channels = int(config.get("num_channels", 1))
    num_ants = int(config.get("num_ants", 1))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "pallas_bank")
    processor = config.get("processor", "GPU")
    blocks = int(config.get("blocks", 8))
    trials = int(config.get("trials", 7))
    device = resolve_device(processor)

    fs = num_samples / 1e-3
    cfg = TrackConfig.for_system(system, fs, num_samples, num_correlators=num_correlators,
                                 algorithm=algorithm)
    prns = np.arange(num_channels) % system.codes.shape[1]
    dops = np.linspace(-4000.0, 4000.0, num_channels)
    states = init_state(prns, carrier_doppler=dops, num_taps=num_correlators, device=device)
    codes = torch.as_tensor(system.codes, device=device)

    def make_fn(b):
        signal, _ = gen_signal(system, 0, 1500.0, num_samples * b, num_ants=num_ants,
                               duration=b * 1e-3, device=device)
        sre, sim = _blocks(signal, b, num_samples)
        return (lambda: track_bank(cfg, codes, states, sre, sim)), ()

    stats = benchmark_differential(make_fn, blocks, trials=trials)
    floor = max(stats.median, 1e-9)
    return _finish(config, stats, processor, algorithm,
                   realtime_ratio=floor / REALTIME_BOUND_S,
                   samples_per_s=num_channels * num_samples * num_ants / floor,
                   realtime_channels=num_channels * REALTIME_BOUND_S / floor)


def run_dual_track_benchmark(config: dict) -> dict:
    """Benchmark the closed dual-component (data + pilot) GPS L5 loop.

    K dual channels run as one 2K-channel bank call per block
    (`tracking.track_bank_dual`), with the overlay wipe-off and the
    pilot-driven atan2 loop closure in the timed path, replayed per block as
    a captured graph on the GPU (as `run_track_benchmark`). Keys as
    `run_track_benchmark`; ``num_channels`` counts dual channels
    (``bank_channels = 2 K``), and ``realtime_channels`` is dual channels.
    """
    from ..models import GPSL5
    from ..tracking import TrackConfig, dual_config, init_state, track_bank_dual

    num_samples = int(config["num_samples"])
    num_channels = int(config.get("num_channels", 1))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "pallas_bank_auto")
    processor = config.get("processor", "GPU")
    blocks = int(config.get("blocks", 8))
    trials = int(config.get("trials", 7))
    device = resolve_device(processor)

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    fs = num_samples / 1e-3
    cfg = dual_config(TrackConfig.for_system(
        sys_i, fs, num_samples, num_correlators=num_correlators,
        algorithm=algorithm, use_secondary=False,
    ))
    prns = np.arange(num_channels) % sys_i.codes.shape[1]
    dops = np.linspace(-4000.0, 4000.0, num_channels)
    states = init_state(prns, carrier_doppler=dops, num_taps=num_correlators, device=device)
    codes_i = torch.as_tensor(sys_i.codes, device=device)
    codes_q = torch.as_tensor(sys_q.codes, device=device)

    def make_fn(b):
        signal, _ = gen_signal(sys_i, 0, 1500.0, num_samples * b, duration=b * 1e-3,
                               secondary_code=sys_i.secondary_code, device=device)
        sre, sim = (x.reshape(b, num_samples) for x in soa(signal))
        return (lambda: track_bank_dual(cfg, codes_i, codes_q, states, sre, sim)), ()

    stats = benchmark_differential(make_fn, blocks, trials=trials)
    floor = max(stats.median, 1e-9)
    return _finish(config, stats, processor, algorithm,
                   bank_channels=2 * num_channels,
                   realtime_ratio=floor / REALTIME_BOUND_S,
                   samples_per_s=2 * num_channels * num_samples / floor,
                   realtime_channels=num_channels * REALTIME_BOUND_S / floor)


def run_acquire_benchmark(config: dict) -> dict:
    """Benchmark PCPS acquisition: circular correlation over a Doppler grid,
    K PRNs searched at once, noncoherent round summation (`acquire.acquire`,
    `torch.fft`: cuFFT on the card).

    Keys: ``GNSS``, ``num_samples``, ``num_prns``, ``processor``
    ("GPU"/"CPU"), ``rounds`` (noncoherent), ``max_doppler``/``doppler_step``,
    ``trials``. The unit is one full acquisition call (all PRNs x all bins x
    rounds).
    """
    from ..acquire import acquire

    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    num_prns = int(config.get("num_prns", 8))
    rounds = int(config.get("rounds", 1))
    trials = int(config.get("trials", 7))
    processor = config.get("processor", "GPU")
    max_doppler = float(config.get("max_doppler", 5000.0))
    fs = num_samples / 1e-3
    doppler_step = float(config.get("doppler_step", 2.0 / (3.0 * (num_samples / fs))))
    num_bins = int(2 * max_doppler / doppler_step) + 1
    device = resolve_device(processor)

    signal, _ = gen_signal(system, 0, 1200.0, num_samples * rounds,
                           duration=rounds * 1e-3, device=device)
    sre, sim = soa(signal)
    if rounds > 1:
        sre = sre.reshape(rounds, num_samples)
        sim = sim.reshape(rounds, num_samples)
    prns = np.arange(num_prns) % system.codes.shape[1]

    def run():
        return acquire(system, sre, sim, prns, fs, max_doppler=max_doppler,
                       doppler_step=doppler_step, fft_mode="fft")

    stats = benchmark(run, trials=trials)
    return _finish(config, stats, processor, "pcps", num_bins=num_bins, rounds=rounds,
                   num_prns=num_prns, fft_mode="fft")


def run_reduction_benchmark(config: dict) -> dict:
    """Benchmark a reduction fusion degree over ``[N, A, L]`` product planes.

    Keys: ``num_samples``, ``num_ants``, ``num_correlators``, ``algorithm``
    ("pure"/"cplx"/"cplx_multi"), ``processor``, optional ``reps``/``trials``
    and ``reps_mode``: ``"scan"`` by default, a graph of `REDUCTION_UNROLL`
    reps replayed (the JAX ``lax.scan(..., unroll=32)``; `reps_program`).
    """
    num_samples = int(config["num_samples"])
    num_ants = int(config.get("num_ants", 4))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "cplx_multi")
    processor = config.get("processor", "GPU")
    reps = config.get("reps", 20)
    if reps == "auto":
        reps = int(min(8192, max(256, (1 << 24) // num_samples)))
    reps = int(reps)
    trials = int(config.get("trials", 7))
    mode = _resolve_mode(config, "scan")
    device = resolve_device(processor)

    red = get_reduction(algorithm)
    shape = (num_samples, num_ants, num_correlators)
    gen = torch.Generator(device=device)
    prod_re = torch.randn(shape, generator=gen.manual_seed(0), device=device)
    prod_im = torch.randn(shape, generator=gen.manual_seed(1), device=device)

    def make_fn(r):
        scales = torch.linspace(1.0, 1.01, r, dtype=torch.float32, device=device)
        return reps_program(lambda s: red(prod_re * s, prod_im * s), scales, mode,
                            REDUCTION_UNROLL), ()

    stats = benchmark_differential(make_fn, reps, trials=trials)
    return _finish(config, stats, processor, algorithm, reps_mode=mode)


def run_replica_benchmark(config: dict) -> dict:
    """Benchmark code-replica generation: exact vs quantized-NCO lookup.

    ``algorithm`` is ``"exact"`` (`gen_code_replica`) or ``"quantized"``
    (`gen_code_replica_quantized`, the texture-lookup analog); on the card
    one launch of ``csrc/replica.cu`` per rep (`replica_kernel.code_replica`,
    the counterpart of XLA's fusion of the function), on the CPU the plain
    version. Keys: ``GNSS``, ``num_samples``, ``processor``, optional
    ``reps``/``trials`` and ``reps_mode`` (``"scan"`` by default, as
    `run_reduction_benchmark`).
    """
    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    algorithm = config.get("algorithm", "exact")
    processor = config.get("processor", "GPU")
    reps = config.get("reps", 20)
    if reps == "auto":
        reps = int(min(4096, max(32, (1 << 23) // num_samples)))
    reps = int(reps)
    trials = int(config.get("trials", 7))
    mode = _resolve_mode(config, "scan")
    fs = num_samples / 1e-3
    device = resolve_device(processor)

    codes = torch.as_tensor(system.codes, device=device)
    prn = torch.zeros((), dtype=torch.int32, device=device)
    fcode = torch.tensor(system.code_frequency, dtype=torch.float32, device=device)

    def step(phase):
        return (code_replica(codes, prn, fcode, fs, phase, num_samples, -1, 1,
                             system.code_length, mode=algorithm),)

    def make_fn(r):
        phases = torch.linspace(0.0, 0.5, r, dtype=torch.float32, device=device)
        return reps_program(step, phases, mode, REDUCTION_UNROLL), ()

    stats = benchmark_differential(make_fn, reps, trials=trials)
    return _finish(config, stats, processor, algorithm, reps_mode=mode)
