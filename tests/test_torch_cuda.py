"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import collections
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu_torch.models import (
    GPSL1, GPSL5, BeiDouB1I, GalileoE1, GLONASSL1, EPLCorrelator, correlator_sample_shifts, gen_carrier, gen_signal,
    gen_signal_mixed, soa)
from gpuacceleratedtracking_tpu_torch.ops import (
    bank_comp, channel_kernels, epl_kernels, loop_kernel, registry, replica_kernel)
from gpuacceleratedtracking_tpu_torch.tracking import (
    TrackConfig, dual_config, init_state, state_from_numpy, track, track_bank,
    track_bank_dual)

pytestmark = pytest.mark.cuda

SYSTEM = GPSL1()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(device, n, k, num_ants=1, taps=3, shifts=None, seed=0, system=SYSTEM, fs=None):
    rng = np.random.default_rng(seed)
    fs = n / 1e-3 if fs is None else fs
    signal, _ = gen_signal(system, 0, 1500.0, n, duration=n / fs,
                           num_ants=None if num_ants == 1 else num_ants, device=device)
    sre, sim = soa(signal)
    if shifts is None:
        shifts = correlator_sample_shifts(system, EPLCorrelator(taps), fs)
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    return dict(
        signal_re=sre, signal_im=sim, codes=t(system.codes),
        prn=t(np.arange(k) % 32, torch.int32),
        carrier_frequency=t(1500.0 + rng.uniform(-4000.0, 4000.0, k)),
        sampling_frequency=fs,
        carrier_phase=t(rng.uniform(0, 2 * np.pi, k)),
        code_frequency=t(system.code_frequency + rng.uniform(-3, 3, k)),
        code_phase=t(rng.uniform(0, system.code_length, k)),
        sample_shifts=tuple(int(s) for s in shifts),
        code_length=system.code_length,
        nominal_code_frequency=system.code_frequency,
    )


CASES = {
    "n8192_k5": dict(n=8192, k=5),
    "n32768_k8_a2": dict(n=32768, k=8, num_ants=2),
    "wide_span": dict(n=8192, k=4, shifts=(-160, 0, 170)),
    "five_taps": dict(n=16384, k=6, taps=5),
    "seven_taps_a4": dict(n=16384, k=3, taps=7, num_ants=4),
    "ragged_tile": dict(n=10000, k=3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    # Kernel and plain version share their f32 phase arithmetic; the
    # tolerance is the JAX suite's chip-flip envelope (+/-2 per flip).
    case = _case(cuda, **CASES[name])
    before = epl_kernels.correlate_pallas_bank_rows.launches
    got = epl_kernels.correlate_pallas_bank_rows(**case)
    torch.cuda.synchronize()
    assert epl_kernels.correlate_pallas_bank_rows.launches == before + 1
    want = epl_kernels.correlate_bank_rows_reference(**case)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        torch.testing.assert_close(g, w, rtol=2e-3, atol=4.5)


def test_golden_prompt_is_exactly_n(cuda):
    n = 32768
    case = _case(cuda, n, 3)
    z = torch.zeros(3, device=cuda)
    case.update(carrier_frequency=z + 1500.0, carrier_phase=z,
                code_frequency=z + SYSTEM.code_frequency, code_phase=z,
                prn=torch.zeros(3, dtype=torch.int32, device=cuda))
    are, _ = epl_kernels.correlate_pallas_bank_rows(**case)
    assert are[:, 1].tolist() == [float(n)] * 3


def test_kernel_is_deterministic(cuda):
    case = _case(cuda, 32768, 64, seed=3)
    a = epl_kernels.correlate_pallas_bank_rows(**case)
    b = epl_kernels.correlate_pallas_bank_rows(**case)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_unsupported_shape_raises_before_launch(cuda):
    # A=5 is outside the kernel's instantiations (A <= 4): two launches (4 + 1
    # antennas) that match the plain version. A float64 plane still raises
    # before any launch.
    case = _case(cuda, 8192, 2, num_ants=5)
    before = epl_kernels.correlate_pallas_bank_rows.launches
    got = epl_kernels.correlate_pallas_bank_rows(**case)
    torch.cuda.synchronize()
    assert epl_kernels.correlate_pallas_bank_rows.launches == before + 2
    want = epl_kernels.correlate_bank_rows_reference(**case)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 5, 3)
        torch.testing.assert_close(g, w, rtol=2e-3, atol=4.5)
    case = _case(cuda, 8192, 2)
    case["signal_re"] = case["signal_re"].double()
    with pytest.raises(TypeError, match="float32"):
        epl_kernels.correlate_pallas_bank_rows(**case)
    assert epl_kernels.correlate_pallas_bank_rows.launches == before + 2


def test_track_bank_launches_once_per_block(cuda):
    n, blocks, k = 8192, 5, 16
    dops = np.linspace(-4000.0, 4000.0, k)
    dops[:3] = [-900.0, 100.0, 1500.0]
    sig, fs = gen_signal_mixed(SYSTEM, [0, 1, 2], dops[:3], n * blocks,
                               duration=blocks * 1e-3, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    states = init_state(np.arange(k) % 32, carrier_doppler=dops, device=cuda)
    outs = {}
    for algo in ("pallas_bank_auto", "xla_bank"):
        config = TrackConfig.for_system(SYSTEM, fs, n, algorithm=algo)
        before = epl_kernels.correlate_pallas_bank_rows.launches
        _, outs[algo] = track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        launched = epl_kernels.correlate_pallas_bank_rows.launches - before
        assert launched == (blocks if algo == "pallas_bank_auto" else 0)
    got, want = outs["pallas_bank_auto"], outs["xla_bank"]
    # Block 0 for every channel (same start state); locked channels always.
    torch.testing.assert_close(got.prompt_re[0], want.prompt_re[0], rtol=5e-3, atol=10.0)
    torch.testing.assert_close(got.prompt_re[:, :3], want.prompt_re[:, :3],
                               rtol=5e-3, atol=10.0)


COMP_CASES = {
    "n32768_k8": dict(n=32768, k=8),
    "padded_k5": dict(n=32768, k=5, seed=3),
    "unaligned_n20000": dict(n=20000, k=3, seed=5),
    "wide_span_a2": dict(n=8192, k=3, num_ants=2, shifts=(-160, 0, 170), seed=6),
    "seven_taps_a4": dict(n=32768, k=16, taps=7, num_ants=4, seed=2),
    "five_taps_a3": dict(n=16384, k=9, taps=5, num_ants=3, seed=4),
    "k1024_a4_l7": dict(n=32768, k=1024, taps=7, num_ants=4, seed=8),
}


@pytest.mark.parametrize("z_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(COMP_CASES))
def test_comp_kernel_matches_plain_version(cuda, name, z_dtype):
    # Same Z phase arithmetic as the plain version; the sums differ in order
    # only (tensor-core products per 1024-sample tile, then summed over
    # tiles; f32 as three TF32 passes, bf16 products exact in f32).
    case = _case(cuda, **COMP_CASES[name])
    before = bank_comp.correlate_pallas_bank_comp.launches
    got = bank_comp.correlate_pallas_bank_comp(**case, z_dtype=z_dtype)
    torch.cuda.synchronize()
    assert bank_comp.correlate_pallas_bank_comp.launches == before + 1
    want = bank_comp.correlate_bank_comp_reference(**case, z_dtype=z_dtype)
    scale = float(want[0].abs().max())
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        torch.testing.assert_close(g, w, rtol=0, atol=3e-5 * scale + 1e-3)


@pytest.mark.parametrize("route", ["pallas_bank_rows", "f32", "bf16"])
def test_channels_outside_the_envelope_take_the_general_chip_wrap(cuda, route):
    # The wrappers check the nominal chip rate only; a channel's own rate can
    # still leave the envelope (a negative rate, or ~2 chips per sample).
    # Such a channel's chips leave [0, 2 Lc) and take the general wrap.
    case = _case(cuda, 16384, 5, num_ants=1 if route == "pallas_bank_rows" else 2, seed=11)
    case["code_frequency"][:2] = torch.tensor([-SYSTEM.code_frequency,
                                               70 * SYSTEM.code_frequency], device=cuda)
    if route == "pallas_bank_rows":
        got = epl_kernels.correlate_pallas_bank_rows(**case)
        want = epl_kernels.correlate_bank_rows_reference(**case)
        tol = dict(rtol=2e-3, atol=4.5)
    else:
        got = bank_comp.correlate_pallas_bank_comp(**case, z_dtype=route)
        want = bank_comp.correlate_bank_comp_reference(**case, z_dtype=route)
        tol = dict(rtol=0, atol=3e-5 * float(want[0].abs().max()) + 1e-3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol)


# The rows kernel's two replica-row builds, bit for bit: its boundary build
# (`epl_kernels.rows_min_run` > 0) against its per-position build (0).

def _bits(x):
    return x.contiguous().view(torch.int32)


def _both_builds(monkeypatch, launch):
    """``launch()``'s tensors with every bank_rows launch forced to the
    boundary build (``min_run`` 1: wherever chips_near holds) and to the
    per-position build, and the build counters' moves."""
    results, moved = [], []
    for min_run in (1, 0):
        monkeypatch.setattr(epl_kernels, "rows_min_run", lambda rho_nom, m=min_run: m)
        before = (epl_kernels.boundary_rows.launches, epl_kernels.position_rows.launches)
        results.append(launch())
        torch.cuda.synchronize()
        moved.append((epl_kernels.boundary_rows.launches - before[0],
                      epl_kernels.position_rows.launches - before[1]))
    monkeypatch.undo()
    return results, moved


def _assert_same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


def _near_boundaries(case):
    """The case's first channels at exactly 1/32 chip a sample, so that in the
    first phase tile a chip boundary falls on a sample, with code phases a
    few f32 ulps either side of it (the sample's chip flips with them), and
    just below Lc (the wrap)."""
    f32, c = np.float32, np.float32(412)
    lc = f32(case["code_length"])
    near = [np.nextafter(c, f32(0)), c, np.nextafter(c, f32(1e4)), c - 3 * np.spacing(c),
            c + 3 * np.spacing(c), np.nextafter(lc, f32(0)), lc - 4 * np.spacing(lc), f32(0)]
    count = min(len(near), case["code_phase"].numel())
    case["code_phase"][:count] = torch.as_tensor(np.asarray(near[:count], dtype=f32),
                                                 device=case["code_phase"].device)
    case["code_frequency"][:count] = case["sampling_frequency"] / 32
    return case


ROW_BUILD_CASES = {
    "k1024": dict(n=32768, k=1024),
    "k13_ragged": dict(n=10000, k=13, seed=2),
    **{f"a{a}_l{taps}_k11": dict(n=8192, k=11, num_ants=a, taps=taps, seed=10 * a + taps)
       for a in (1, 2, 3, 4) for taps in (3, 5, 7)},
    **{f"shifts_{i}": dict(n=32768, k=13, shifts=shifts, seed=20 + i)
       for i, shifts in enumerate([(-16, 0, 16), (-160, 0, 170),
                                   (-48, -32, -16, 0, 16, 32, 48), (-5, 0, 325)])},
}


@pytest.mark.parametrize("name", sorted(ROW_BUILD_CASES))
def test_boundary_rows_equal_per_position_rows_bit_for_bit(cuda, monkeypatch, name):
    # The boundary build's rows are the per-position formula's chips, so the
    # accumulators agree to the bit, phases beside chip boundaries included.
    case = _near_boundaries(_case(cuda, **ROW_BUILD_CASES[name]))
    (runs, each), moved = _both_builds(
        monkeypatch, lambda: epl_kernels.correlate_pallas_bank_rows(**case))
    _assert_same_bits(runs, each)
    launches = len(epl_kernels.launch_groups(case["signal_re"].shape[0]
                                             if case["signal_re"].ndim == 2 else 1,
                                             len(case["sample_shifts"])))
    assert moved == [(launches, 0), (0, launches)]


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_row_builds_agree_either_side_of_the_crossover(cuda, monkeypatch, offset):
    # GPS L1 where a chip lasts MIN_CHIP_RUN - 1, MIN_CHIP_RUN and
    # MIN_CHIP_RUN + 1 samples, some channels' rates 2 % either side of the
    # nominal one: the launch takes the rule's build (the boundary build
    # from MIN_CHIP_RUN on, for each channel whose own rate gives chips that
    # long), equal to both builds forced, to the bit.
    run = epl_kernels.MIN_CHIP_RUN + offset
    fs = run * SYSTEM.code_frequency
    case = _near_boundaries(_case(cuda, 8192, 64, fs=fs, seed=30 + run))
    case["code_frequency"][-16:] = SYSTEM.code_frequency * (
        1.0 + torch.linspace(-0.02, 0.02, 16, device=cuda))
    fn = (epl_kernels.correlate_pallas_bank_rows if run >= 6
          else epl_kernels.correlate_pallas_bank)
    before = (epl_kernels.boundary_rows.launches, epl_kernels.position_rows.launches)
    rule = fn(**case)
    torch.cuda.synchronize()
    boundary = offset >= 0
    assert (epl_kernels.boundary_rows.launches - before[0],
            epl_kernels.position_rows.launches - before[1]) == (int(boundary), int(not boundary))
    (runs, each), _ = _both_builds(monkeypatch, lambda: fn(**case))
    _assert_same_bits(rule, each)
    _assert_same_bits(runs, each)


def test_row_builds_agree_on_channels_outside_the_envelope(cuda, monkeypatch):
    # A negative rate and ~2 chips a sample take the general wrap; a NaN code
    # phase converts to chip 0 and keeps chips_near; so do a zero rate and
    # 0.2 chips a sample (several boundaries in a group of 32 positions).
    case = _near_boundaries(_case(cuda, 16384, 13, seed=11))
    case["code_frequency"][:4] = torch.tensor(
        [-SYSTEM.code_frequency, 70 * SYSTEM.code_frequency, 0.0, 0.2 * 16384e3], device=cuda)
    case["code_phase"][4] = float("nan")
    (runs, each), _ = _both_builds(
        monkeypatch, lambda: epl_kernels.correlate_pallas_bank_rows(**case))
    _assert_same_bits(runs, each)


def test_row_builds_agree_on_time_shards(cuda, monkeypatch):
    # Four time shards of a [chunk, N] buffer's row at the device index, each
    # at its sample offset: every shard's partials and the joint finish.
    from gpuacceleratedtracking_tpu_torch.parallel import nominal_advance_tables, time_shard

    rng = np.random.default_rng(12)
    n, k, num_time, fs = 32768, 21, 4, 32.768e6
    sre, sim = (torch.as_tensor(rng.standard_normal((3, n)), dtype=torch.float32, device=cuda)
                for _ in range(2))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    prn = torch.as_tensor(np.arange(k) % 32, device=cuda)
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=cuda)  # noqa: E731
    phi_code = rng.uniform(0, 1023, k).astype(np.float32)
    phi_code[:3] = [np.nextafter(np.float32(7), np.float32(0)), 7.0,
                    np.nextafter(np.float32(1023), np.float32(0))]
    channels = dict(intermediate_frequency=0.0, carrier_doppler=t(rng.uniform(-4000, 4000, k)),
                    carrier_phase=t(rng.uniform(0, 2 * np.pi, k)),
                    code_frequency=SYSTEM.code_frequency,
                    code_doppler=t(rng.uniform(-3, 3, k)), code_phase=t(phi_code))
    shifts = tuple(int(s) for s in correlator_sample_shifts(SYSTEM, EPLCorrelator(3), fs))
    tables = nominal_advance_tables(0.0, SYSTEM.code_frequency, fs, n // num_time, num_time,
                                    1023)
    tiles = epl_kernels.pack_code_tiles(codes, prn)
    index = torch.tensor(2, dtype=torch.int64, device=cuda)

    def launch():
        total = epl_kernels.ShardSum(num_time, cuda)
        for i in range(num_time):
            ch = epl_kernels.BankChannels(**channels, shard=time_shard(i, tables, fs,
                                                                       n // num_time, 1023))
            assert ch.shard.offset == i * (n // num_time)
            epl_kernels.correlate_pallas_bank_rows(
                sre, sim, codes, prn, None, fs, None, None, None, shifts, 1023,
                nominal_code_frequency=SYSTEM.code_frequency, code_tiles=tiles, channels=ch,
                block_index=index, shard_sum=total)
        return list(total.finish()) + list(total.partials.values())

    (runs, each), moved = _both_builds(monkeypatch, launch)
    assert moved == [(num_time, 0), (0, num_time)]
    _assert_same_bits(runs, each)


def test_track_bank_at_the_main_paths_shape_takes_the_boundary_build(cuda):
    # K=1024 GPS L1 at 32.768 MHz, captured: every replayed block's bank_rows
    # launch counts as a boundary build.
    n, blocks, k = 32768, 3, 1024
    sig, fs = gen_signal_mixed(SYSTEM, [0, 1, 2], [-900.0, 100.0, 1500.0], n * blocks,
                               duration=blocks * 1e-3, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    states = init_state(np.arange(k) % 32, carrier_doppler=np.linspace(-4000.0, 4000.0, k),
                        device=cuda)
    config = TrackConfig.for_system(SYSTEM, fs, n, algorithm="pallas_bank_auto")
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    for _ in range(2):                               # the capture, then a replayed call
        before = (epl_kernels.boundary_rows.launches, epl_kernels.position_rows.launches,
                  epl_kernels.correlate_pallas_bank_rows.launches)
        track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        assert (epl_kernels.boundary_rows.launches - before[0],
                epl_kernels.position_rows.launches - before[1],
                epl_kernels.correlate_pallas_bank_rows.launches - before[2]) == (blocks, 0, blocks)


def test_comp_golden_prompt(cuda):
    n = 32768
    case = _case(cuda, n, 3)
    z = torch.zeros(3, device=cuda)
    case.update(carrier_frequency=z + 1500.0, carrier_phase=z,
                code_frequency=z + SYSTEM.code_frequency, code_phase=z,
                prn=torch.zeros(3, dtype=torch.int32, device=cuda))
    are, _ = bank_comp.correlate_pallas_bank_comp(**case)
    torch.testing.assert_close(are[:, 1], torch.full((3,), float(n), device=cuda),
                               rtol=1e-5, atol=0)


def test_comp_kernel_is_deterministic(cuda):
    case = _case(cuda, 32768, 64, num_ants=4, taps=7, seed=3)
    a = bank_comp.correlate_pallas_bank_comp(**case)
    b = bank_comp.correlate_pallas_bank_comp(**case)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_comp_kernel_is_deterministic_in_bf16(cuda):
    case = _case(cuda, 32768, 1024, num_ants=4, taps=7, seed=3)
    a = bank_comp.correlate_pallas_bank_comp(**case, z_dtype="bf16")
    b = bank_comp.correlate_pallas_bank_comp(**case, z_dtype="bf16")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["l1_k1024", "l5_k128"])
def test_rows_kernel_takes_packed_columns(cuda, name):
    # The code table prepared once (as track_bank does), one bit per chip.
    system, k = (SYSTEM, 1024) if name == "l1_k1024" else (GPSL5(), 128)
    case = _case(cuda, 32768, k, system=system, seed=9)
    case["code_tiles"] = epl_kernels.prepare_bank_code_tiles_rows(case["codes"], case["prn"])
    assert case["code_tiles"].shape == (k, -(-system.code_length // 32))
    got = epl_kernels.correlate_pallas_bank_auto(**case)
    torch.cuda.synchronize()
    route = "pallas_bank_rows" if name == "l1_k1024" else "pallas_bank"
    want = epl_kernels.correlate_bank_rows_reference(**case, route=route)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=4.5)


def test_constructors_default_to_the_card(cuda):
    signal, _ = gen_signal(SYSTEM, 0, 1500.0, 4096)
    mixed, _ = gen_signal_mixed(SYSTEM, [0, 1], [100.0, -200.0], 4096)
    carrier = gen_carrier(4096, 1500.0, 4.096e6, 0.3)
    state = init_state(np.arange(4), carrier_doppler=100.0)
    from gpuacceleratedtracking_tpu_torch.tracking import cn0, loop_filter, state_to_numpy
    state2 = state_from_numpy(state_to_numpy(state))
    tensors = [signal, mixed, carrier, cn0.init(20).prompts_re, loop_filter.init(1.0).x1,
               *(x for x in state if isinstance(x, torch.Tensor)),
               *(x for x in state2 if isinstance(x, torch.Tensor))]
    assert all(x.device.type == "cuda" for x in tensors)


TRANSITION_CASES = {
    "l5_k128": dict(n=32768, k=128, system=GPSL5(), seed=1),
    "l5_a4_l7_k8": dict(n=32768, k=8, num_ants=4, taps=7, system=GPSL5(), seed=2),
    "l1_4096khz_k64": dict(n=4096, k=64, seed=3),
    "l1_2500khz_k5": dict(n=2500, k=5, seed=4),
}


@pytest.mark.parametrize("name", sorted(TRANSITION_CASES))
def test_transition_route_matches_plain_version(cuda, name):
    case = _case(cuda, **TRANSITION_CASES[name])
    assert epl_kernels.bank_algorithm_for(
        case["signal_re"].shape[-1], case["sampling_frequency"], case["code_length"],
        case["nominal_code_frequency"]) == "pallas_bank"
    before = (epl_kernels.correlate_pallas_bank.launches,
              epl_kernels.correlate_pallas_bank_rows.launches)
    got = epl_kernels.correlate_pallas_bank_auto(**case)
    torch.cuda.synchronize()
    assert (epl_kernels.correlate_pallas_bank.launches,
            epl_kernels.correlate_pallas_bank_rows.launches) == (before[0] + 1, before[1])
    want = epl_kernels.correlate_bank_rows_reference(**case, route="pallas_bank")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=4.5)


def test_track_bank_comp_launches_once_per_block(cuda):
    n, blocks, k = 8192, 5, 16
    dops = np.linspace(-4000.0, 4000.0, k)
    dops[:3] = [-900.0, 100.0, 1500.0]
    sig, fs = gen_signal_mixed(SYSTEM, [0, 1, 2], dops[:3], n * blocks, num_ants=2,
                               duration=blocks * 1e-3, device=cuda)
    sre, sim = (x.reshape(2, blocks, n).transpose(0, 1).contiguous() for x in soa(sig))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    states = init_state(np.arange(k) % 32, carrier_doppler=dops, device=cuda)
    outs = {}
    for algo in ("pallas_bank_auto", "xla_bank"):
        config = TrackConfig.for_system(SYSTEM, fs, n, algorithm=algo)
        before = bank_comp.correlate_pallas_bank_comp.launches
        _, outs[algo] = track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        launched = bank_comp.correlate_pallas_bank_comp.launches - before
        assert launched == (blocks if algo == "pallas_bank_auto" else 0)
    got, want = outs["pallas_bank_auto"], outs["xla_bank"]
    torch.testing.assert_close(got.prompt_re[0], want.prompt_re[0], rtol=5e-3, atol=10.0)
    torch.testing.assert_close(got.prompt_re[:, :3], want.prompt_re[:, :3],
                               rtol=5e-3, atol=10.0)


def test_track_bank_dual_launches_once_per_block(cuda):
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    n, blocks, k = 32768, 4, 8
    fs = n / 1e-3
    sig_i, _ = gen_signal(sys_i, 3, 900.0, n * blocks, duration=blocks * 1e-3,
                          secondary_code=sys_i.secondary_code, device=cuda)
    sig_q, _ = gen_signal(sys_q, 3, 900.0, n * blocks, duration=blocks * 1e-3,
                          secondary_code=sys_q.secondary_code,
                          start_carrier_phase=np.pi / 2, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig_i + sig_q))
    config = dual_config(TrackConfig.for_system(sys_i, fs, n, algorithm="pallas_bank_auto",
                                                use_secondary=False))
    states = init_state(np.arange(k) + 3, carrier_doppler=np.full(k, 900.0), device=cuda)
    before = epl_kernels.correlate_pallas_bank.launches
    _, out = track_bank_dual(config, torch.as_tensor(sys_i.codes, device=cuda),
                             torch.as_tensor(sys_q.codes, device=cuda), states, sre, sim)
    torch.cuda.synchronize()
    assert epl_kernels.correlate_pallas_bank.launches == before + blocks
    assert out.pilot.prompt_re.shape == (blocks, k)
    assert float(out.pilot.prompt_re[-1, 0]) > 0.5 * n


# tests/test_pallas.py:42-110 and :715-726, plus the sweep's top corner.
# name -> (system, N, A, taps or shifts, prn, f_carrier, carrier phase, code phase)
CHANNEL_CASES = {
    "golden": (SYSTEM, 2500, 1, 3, 0, 1500.0, 0.0, 0.0),
    "offsets": (SYSTEM, 4096, 1, 3, 5, -2345.0, 0.9, 517.3),
    "multi_antenna": (SYSTEM, 2500, 4, 3, 0, 1500.0, 0.0, 0.0),
    "seven_taps": (SYSTEM, 8192, 1, 7, 0, 1500.0, 0.0, 0.0),
    "l5": (GPSL5(), 32768, 1, 3, 3, 2000.0, 0.0, 0.0),
    "wide_span": (SYSTEM, 4096, 1, (-150, 0, 163), 0, 1500.0, 0.0, 0.0),
    "sub_tile": (SYSTEM, 1000, 1, 3, 0, 500.0, 0.0, 0.0),
    "wide_n131072_l7": (SYSTEM, 131072, 1, 7, 0, 1500.0, 0.0, 0.0),
    "n262144_a4_l7": (SYSTEM, 262144, 4, 7, 0, 1500.0, 0.0, 0.0),
    # The sweep's launch-weighted corner, its smallest block, ragged blocks
    # (N % 4 != 0 takes the scalar loads), ~2 chips per sample and a
    # negative chip rate (the general chip wrap), and a span past the fused
    # kernel's replica row (its per-tap lookup branch).
    "n32768_l3": (SYSTEM, 32768, 1, 3, 7, -1200.0, 1.1, 311.7),
    "n2048": (SYSTEM, 2048, 1, 3, 2, 900.0, 0.4, 17.25),
    "ragged_n20000_a4": (SYSTEM, 20000, 4, 3, 1, 300.0, 2.0, 600.5),
    "ragged_n2049_a4": (SYSTEM, 2049, 4, 5, 1, 300.0, 2.0, 600.5),
    "two_chips_per_sample": (SYSTEM, 512, 1, 3, 0, 100.0, 0.0, 3.5),
    "negative_rate": (SYSTEM, 8192, 2, 3, 0, 100.0, 0.0, 3.5, -SYSTEM.code_frequency),
    "span_past_the_row": (SYSTEM, 8192, 1, (-4000, 0, 4000), 0, 1500.0, 0.0, 0.0),
}


def _channel_args(device, name, prn_dtype=torch.int32):
    system, n, a, taps, prn, fcar, phicar, phicode, *fcode = CHANNEL_CASES[name]
    signal, fs = gen_signal(system, prn, fcar, n, num_ants=None if a == 1 else a,
                            start_code_phase=phicode, start_carrier_phase=phicar,
                            device=device)
    if isinstance(taps, int):
        taps = correlator_sample_shifts(system, EPLCorrelator(taps), fs)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=device)  # noqa: E731
    return (*soa(signal), torch.as_tensor(system.codes, device=device),
            prn if prn_dtype is int else t(prn, prn_dtype), t(fcar), fs, t(phicar),
            t(fcode[0] if fcode else system.code_frequency), t(phicode),
            tuple(int(s) for s in taps), system.code_length)


def _assert_channel_close(got, want, n):
    # Same phase and chip arithmetic: the sums differ in order only
    # (relative 1e-6 of the block length).
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * n + 1e-3)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
@pytest.mark.parametrize("name", sorted(CHANNEL_CASES))
def test_channel_kernel_matches_plain_version(cuda, name, kernel):
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    plain = getattr(channel_kernels, f"correlate_{kernel}_reference")
    args = _channel_args(cuda, name)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    _assert_channel_close(got, want, args[0].shape[-1])
    if name in ("golden", "multi_antenna"):
        torch.testing.assert_close(got[0].reshape(-1, 3),
                                   torch.tensor([[1476.0, 2500.0, 1476.0]], device=cuda)
                                   .expand(got[0].numel() // 3, 3), rtol=3.5e-4, atol=0)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
def test_channel_kernel_is_deterministic(cuda, kernel):
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    args = _channel_args(cuda, "n262144_a4_l7")
    a, b = fn(*args), fn(*args)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("prn_dtype", [int, torch.int32, torch.int64])
def test_fused_kernel_takes_the_prn_as_an_int_or_a_tensor(cuda, prn_dtype):
    args = _channel_args(cuda, "offsets", prn_dtype=prn_dtype)
    got = channel_kernels.correlate_pallas_fused(*args)
    want = channel_kernels.correlate_fused_reference(*_channel_args(cuda, "offsets"))
    _assert_channel_close(got, want, 4096)


def test_fused_kernel_traps_on_a_device_prn_out_of_range(cuda):
    # As index_select's device assert would: the kernel reads the PRN on the
    # card and traps, which ends the process's CUDA context, so the call
    # runs in a process of its own.
    code = textwrap.dedent("""
        import torch
        from gpuacceleratedtracking_tpu_torch.models import GPSL1
        from gpuacceleratedtracking_tpu_torch.ops import channel_kernels
        x = torch.ones(2048, device="cuda")
        codes = torch.as_tensor(GPSL1().codes, device="cuda")
        prn = torch.tensor(codes.shape[1], dtype=torch.int32, device="cuda")
        channel_kernels.correlate_pallas_fused(x, x, codes, prn, 0.0, 2.048e6, 0.0, 1.023e6,
                                               0.0, (-1, 0, 1), 1023)
        torch.cuda.synchronize()
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode != 0 and "Error" in proc.stderr, proc.stderr[-2000:]


def _offset_calls(device, name, count):
    """``count`` calls' arguments that differ in their carrier and code
    phases, device tensors as the sweep passes them (``offs[i]``)."""
    args = list(_channel_args(device, name))
    offs = torch.linspace(0.0, 0.1, count, dtype=torch.float32, device=device)
    calls = []
    for i in range(count):
        args[6], args[8] = offs[i], offs[i] + 311.7
        calls.append(tuple(args))
    return calls


@pytest.mark.parametrize("kernel", ["taps", "fused"])
@pytest.mark.parametrize("name", ["n2048", "n32768_l3", "n262144_a4_l7"])
def test_channel_kernel_back_to_back_and_in_a_cuda_graph(cuda, kernel, name):
    # The finish counter is left at zero by every launch and the scratch is
    # cached: 50 calls with no sync in between, and 20 captured in one CUDA
    # graph and replayed twice, all equal the plain version.
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    plain = getattr(channel_kernels, f"correlate_{kernel}_reference")
    calls = _offset_calls(cuda, name, 50)
    n = calls[0][0].shape[-1]
    want = [plain(*c) for c in calls]
    got = [fn(*c) for c in calls]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_channel_close(g, w, n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*calls[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [fn(*c) for c in calls[:20]]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(captured, want):
            _assert_channel_close(g, w, n)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
def test_channel_kernel_on_two_streams_at_once(cuda, kernel):
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    plain = getattr(channel_kernels, f"correlate_{kernel}_reference")
    calls = _offset_calls(cuda, "n262144_a4_l7", 2)
    want = [plain(*c) for c in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(10):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(fn(*calls[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for g in got[i]:
            _assert_channel_close(g, want[i], 1 << 18)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
@pytest.mark.parametrize("name", ["n32768_l3", "n262144_a4_l7"])
def test_channel_kernel_in_two_cuda_graphs_on_two_streams(cuda, kernel, name):
    # Two graphs captured on torch's one capture stream at the same shape
    # (more than one cluster, so the kernels count and leave partials),
    # replayed at once on two streams: each capture holds a scratch of its
    # own, so neither overwrites the other's counter or partials.
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    plain = getattr(channel_kernels, f"correlate_{kernel}_reference")
    calls = _offset_calls(cuda, name, 2)
    n = calls[0][0].shape[-1]
    want = [plain(*c) for c in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*calls[0])
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for c in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append([fn(*c) for _ in range(10)])
        graphs.append(graph)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(5):
        for graph, s in zip(graphs, streams):
            with torch.cuda.stream(s):
                graph.replay()
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            _assert_channel_close(got, want[i], n)


SPINS = 4              # spin kernels that open a counted profiler session


def _spin_first() -> None:
    """Open a profiler session with `SPINS` spin kernels (~0.1 ms each),
    left out of its counts (`_counted_ops`): torch.profiler may drop a short
    session's first device events, so the counted calls come after these."""
    for _ in range(SPINS):
        torch.cuda._sleep(100_000)


def _counted_ops(prof) -> list:
    """The names of a session's device ops, its opening spin kernels left out."""
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]


def test_pallas_fused_call_is_one_device_op(cuda):
    # The kernel derives its parameters and reads the PRN's column itself:
    # a wrapper call issues the kernel and nothing else on the card.
    from torch.profiler import ProfilerActivity, profile

    args = _channel_args(cuda, "n32768_l3")
    channel_kernels.correlate_pallas_fused(*args)
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _spin_first()
        for _ in range(calls):
            channel_kernels.correlate_pallas_fused(*args)
        torch.cuda.synchronize()
    device_ops = _counted_ops(prof)
    assert sum("fused_kernel" in name for name in device_ops) == calls
    assert len(device_ops) <= 2 * calls, device_ops


ONEHOT_CASES = {
    "wide_span_k2": dict(n=4096, k=2, shifts=(-160, 0, 170)),
    "k1024": dict(n=32768, k=1024, seed=7),
    "low_rate_k5": dict(n=2500, k=5, seed=8),
    # ~2 chips per sample: a tile's chips pass 2 Lc, so the kernels take the
    # general chip wrap instead of the envelope's single subtraction.
    "two_chips_per_sample_k3": dict(n=500, k=3, seed=9),
}


@pytest.mark.parametrize("name", sorted(ONEHOT_CASES))
def test_onehot_route_matches_plain_version(cuda, name):
    case = _case(cuda, **ONEHOT_CASES[name])
    del case["nominal_code_frequency"]
    before = (epl_kernels.correlate_pallas_bank_onehot.launches,
              epl_kernels.correlate_pallas_bank_rows.launches)
    got = epl_kernels.correlate_pallas_bank_onehot(**case)
    torch.cuda.synchronize()
    assert (epl_kernels.correlate_pallas_bank_onehot.launches,
            epl_kernels.correlate_pallas_bank_rows.launches) == (before[0] + 1, before[1])
    want = epl_kernels.correlate_bank_rows_reference(**case, route="pallas_bank_onehot")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=4.5)


def test_track_with_pallas_fused_launches_once_per_block(cuda):
    n, blocks = 8192, 6
    sig, fs = gen_signal(SYSTEM, 0, 700.0, n * blocks, duration=blocks * 1e-3, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    state = init_state(0, carrier_doppler=700.0, device=cuda)
    outs = {}
    for algo in ("pallas_fused", "fused_xla"):
        config = TrackConfig.for_system(SYSTEM, fs, n, algorithm=algo)
        before = channel_kernels.correlate_pallas_fused.launches
        _, outs[algo] = track(config, codes, state, sre, sim)
        torch.cuda.synchronize()
        launched = channel_kernels.correlate_pallas_fused.launches - before
        assert launched == (blocks if algo == "pallas_fused" else 0)
    torch.testing.assert_close(outs["pallas_fused"].prompt_re, outs["fused_xla"].prompt_re,
                               rtol=5e-3, atol=10.0)


def test_track_bank_onehot_launches_once_per_block(cuda):
    n, blocks, k = 8192, 5, 16
    dops = np.linspace(-4000.0, 4000.0, k)
    dops[:3] = [-900.0, 100.0, 1500.0]
    sig, fs = gen_signal_mixed(SYSTEM, [0, 1, 2], dops[:3], n * blocks,
                               duration=blocks * 1e-3, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    states = init_state(np.arange(k) % 32, carrier_doppler=dops, device=cuda)
    outs = {}
    for algo in ("pallas_bank_onehot", "xla_bank"):
        config = TrackConfig.for_system(SYSTEM, fs, n, algorithm=algo)
        before = epl_kernels.correlate_pallas_bank_onehot.launches
        _, outs[algo] = track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        launched = epl_kernels.correlate_pallas_bank_onehot.launches - before
        assert launched == (blocks if algo == "pallas_bank_onehot" else 0)
    got, want = outs["pallas_bank_onehot"], outs["xla_bank"]
    torch.testing.assert_close(got.prompt_re[:, :3], want.prompt_re[:, :3],
                               rtol=5e-3, atol=10.0)


def test_per_channel_calls_do_not_wait_on_the_card(cuda):
    # A tracking loop issues these calls block after block: none may read a
    # device value on the host or copy a host value to the card.
    args = _channel_args(cuda, "offsets")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for algo in ("pallas_fused", "pallas_taps", "fused_xla", "unfused_xla"):
            registry.get(algo)(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# The GLONASS L1OF, Galileo E1 and BeiDou B1I cells through pallas_bank_auto:
# name -> (system, N, K, seed, code phases or None, route). At 2.048 MHz a
# 2048-sample block covers 512 GLONASS chips, so phases past 510 chips wrap
# the 511-chip code twice (the general chip wrap).
FAMILY_CASES = {
    "glonass_wrap_n2048": (GLONASSL1(), 2048, 8, 31,
                           np.linspace(505.0, 510.9, 8), "pallas_bank"),
    "glonass_n32768_k256": (GLONASSL1(), 32768, 256, 32, None, "pallas_bank_rows"),
    "galileo_e1c_n8192": (GalileoE1(pilot=True), 8192, 64, 33, None, "pallas_bank"),
    "galileo_e1c_n32768_k256": (GalileoE1(pilot=True), 32768, 256, 34, None,
                                "pallas_bank_rows"),
    "beidou_n8192": (BeiDouB1I(), 8192, 64, 35, None, "pallas_bank"),
    "beidou_n32768_k256": (BeiDouB1I(), 32768, 256, 36, None, "pallas_bank_rows"),
}


def _family_case(device, name):
    system, n, k, seed, phases, route = FAMILY_CASES[name]
    case = _case(device, n, k, seed=seed, system=system)
    case["prn"] = case["prn"] % system.num_prns
    if phases is not None:
        case["code_phase"] = torch.as_tensor(phases, dtype=torch.float32, device=device)
    return case, route


@pytest.mark.parametrize("name", sorted(FAMILY_CASES))
def test_family_cells_match_plain_version(cuda, name):
    # The JAX suite's envelopes: 9.0 at Galileo's doubled transition density
    # (tests/test_galileo.py:172-175), the rows tolerance 4.5 elsewhere.
    case, route = _family_case(cuda, name)
    assert epl_kernels.bank_algorithm_for(
        case["signal_re"].shape[-1], case["sampling_frequency"], case["code_length"],
        case["nominal_code_frequency"]) == route
    counter = epl_kernels._ROWS_KERNEL_ROUTES[route]
    before = counter.launches
    got = epl_kernels.correlate_pallas_bank_auto(**case)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = epl_kernels.correlate_bank_rows_reference(**case, route=route)
    atol = 9.0 if name.startswith("galileo") else 4.5
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=2e-3, atol=atol)


def test_acquire_on_the_card_matches_the_cpu(cuda):
    from gpuacceleratedtracking_tpu_torch.acquire import acquire

    prns, dops = np.array([2, 9, 17]), np.array([1250.0, -2400.0, 300.0])
    phases = np.array([100.25, 511.0, 900.5])
    gen = torch.Generator().manual_seed(7)
    sig, fs = gen_signal_mixed(SYSTEM, prns, dops, 4 * 8192, duration=4e-3,
                               start_code_phases=phases, noise_std=2.0, generator=gen,
                               device="cpu")
    sre, sim = (x.reshape(4, 8192) for x in soa(sig))
    want = acquire(SYSTEM, sre, sim, np.arange(32), fs, doppler_step=100.0)
    got = acquire(SYSTEM, sre.to(cuda), sim.to(cuda), np.arange(32), fs, doppler_step=100.0)
    assert got.carrier_doppler.device.type == "cuda"
    torch.testing.assert_close(got.carrier_doppler.cpu(), want.carrier_doppler, rtol=0, atol=0)
    torch.testing.assert_close(got.code_phase.cpu(), want.code_phase, rtol=0, atol=1e-4)
    found = got.peak_metric.cpu().numpy() > 20.0
    assert np.flatnonzero(found).tolist() == sorted(prns.tolist())
    torch.testing.assert_close(got.peak_metric.cpu()[prns], want.peak_metric[prns], rtol=1e-3,
                               atol=0)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
def test_track_bank_dual_on_the_per_channel_kernels(cuda, kernel):
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    n, blocks, k = 8192, 3, 4
    fs = n / 1e-3
    sig_i, _ = gen_signal(sys_i, 3, 900.0, n * blocks, duration=blocks * 1e-3,
                          secondary_code=sys_i.secondary_code, device=cuda)
    sig_q, _ = gen_signal(sys_q, 3, 900.0, n * blocks, duration=blocks * 1e-3,
                          secondary_code=sys_q.secondary_code,
                          start_carrier_phase=np.pi / 2, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig_i + sig_q))
    codes = (torch.as_tensor(sys_i.codes, device=cuda), torch.as_tensor(sys_q.codes, device=cuda))
    states = init_state(np.arange(k) + 3, carrier_doppler=np.full(k, 900.0), device=cuda)
    outs = {}
    for algo in (f"pallas_{kernel}", "xla_bank"):
        config = dual_config(TrackConfig.for_system(sys_i, fs, n, algorithm=algo,
                                                    use_secondary=False))
        fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
        before = fn.launches
        _, outs[algo] = track_bank_dual(config, *codes, states, sre, sim)
        torch.cuda.synchronize()
        assert fn.launches - before == (2 * k * blocks if algo != "xla_bank" else 0)
    got, want = outs[f"pallas_{kernel}"], outs["xla_bank"]
    torch.testing.assert_close(got.pilot.prompt_re[:, 0], want.pilot.prompt_re[:, 0],
                               rtol=5e-3, atol=10.0)
    torch.testing.assert_close(got.data_prompt_re[:, 0], want.data_prompt_re[:, 0],
                               rtol=5e-3, atol=10.0)


def test_loop_update_with_an_overlay_does_not_wait_on_the_card(cuda):
    # The overlay table is copied to the card once per (code, device): the
    # first call builds it, later blocks only read it.
    from gpuacceleratedtracking_tpu_torch.tracking import loop_update

    config = TrackConfig.for_system(BeiDouB1I(), 8.192e6, 8192)
    assert len(config.secondary_code) == 20
    states = init_state(np.arange(64), carrier_doppler=np.linspace(-3000, 3000, 64), device=cuda)
    acc = torch.randn((64, 3), generator=torch.Generator(device=cuda).manual_seed(0),
                      device=cuda) * 1000.0
    states, _ = loop_update(config, states, acc, acc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            states, _ = loop_update(config, states, acc, acc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_stream_dispatch_does_not_wait_on_the_card(cuda):
    # A StreamTracker chunk (pinned staging, side-stream copy, track_bank on
    # the rows kernel) without measure_dispatch queues its work and returns.
    from gpuacceleratedtracking_tpu_torch.runtime import StreamTracker

    n, bpd = 32768, 4
    config = TrackConfig.for_system(BeiDouB1I(), n / 1e-3, n, algorithm="pallas_bank_auto")
    states = init_state(np.arange(16), carrier_doppler=np.linspace(-3000, 3000, 16),
                        device=cuda)
    codes = torch.as_tensor(BeiDouB1I().codes, device=cuda)
    tracker = StreamTracker(config, codes, states, blocks_per_dispatch=bpd)
    rng = np.random.default_rng(0)
    chunks = [rng.standard_normal((2, bpd, n)).astype(np.float32) for _ in range(3)]
    tracker.process(*chunks[0])
    torch.cuda.synchronize()
    start = tracker.states
    before = epl_kernels.correlate_pallas_bank_rows.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [tracker.process(*c) for c in chunks[1:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert epl_kernels.correlate_pallas_bank_rows.launches == before + 2 * bpd
    # The staged chunks give what the same blocks give copied directly (the
    # pinned buffers are reused from chunk to chunk).
    states = start
    for c, out in zip(chunks[1:], outs):
        states, ref = track_bank(config, codes, states, torch.as_tensor(c[0], device=cuda),
                                 torch.as_tensor(c[1], device=cuda))
        torch.testing.assert_close(out.prompt_re, ref.prompt_re, rtol=0, atol=0)
        torch.testing.assert_close(out.carrier_doppler, ref.carrier_doppler, rtol=0, atol=0)


# The distributed layer: sharded banks on a mesh of repeated cuda:0 (every
# visible card where there are two or more), against the unsharded bank.

def _sharded_case(cuda, n=8192, blocks=5, k=64, num_ants=None):
    dops = np.linspace(-4000.0, 4000.0, k)
    dops[:3] = [-900.0, 100.0, 1500.0]
    sig, fs = gen_signal_mixed(SYSTEM, [0, 1, 2], dops[:3], n * blocks, num_ants=num_ants,
                               duration=blocks * 1e-3, device=cuda)
    if num_ants:
        sre, sim = (x.reshape(num_ants, blocks, n).transpose(0, 1).contiguous()
                    for x in soa(sig))
    else:
        sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    states = init_state(np.arange(k) % 32, carrier_doppler=dops, device=cuda)
    return fs, codes, states, sre, sim


def _mesh_devices(cuda):
    count = torch.cuda.device_count()
    return ([torch.device("cuda", i % count) for i in range(4)] if count >= 2
            else [cuda] * 4)


@pytest.mark.parametrize("num_ants,fn", [(None, epl_kernels.correlate_pallas_bank_rows),
                                         (4, bank_comp.correlate_pallas_bank_comp)])
def test_sharded_bank_matches_track_bank_and_launches_chan_x_time_per_block(cuda, num_ants, fn):
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded

    blocks = 5
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=blocks, num_ants=num_ants)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_bank_auto")
    _, want = track_bank(config, codes, states, sre, sim)
    for chan, time_ in ((2, 2), (4, 1), (1, 4)):
        mesh = channel_time_mesh(chan, time_, devices=_mesh_devices(cuda))
        before = fn.launches
        final, got = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
        torch.cuda.synchronize()
        assert fn.launches - before == chan * time_ * blocks
        assert got.prompt_re.device == mesh.devices.flat[0] and got.prompt_re.shape == (blocks, 64)
        # Block 0 for every channel; the locked channels over every block. A
        # channel-only mesh is not bit-exact on the card: the bank kernels
        # group their tiles per CTA by the grid, so by K.
        torch.testing.assert_close(got.prompt_re[0], want.prompt_re[0], rtol=5e-3, atol=10.0)
        torch.testing.assert_close(got.prompt_re[:, :3], want.prompt_re[:, :3],
                                   rtol=5e-3, atol=10.0)


def _distinct_cards(count: int) -> list:
    """``count`` distinct cards, or a skip that names how many are visible."""
    visible = torch.cuda.device_count()
    if visible < count:
        pytest.skip(f"needs {count} distinct cards, {visible} visible")
    return [torch.device("cuda", i) for i in range(count)]


@pytest.mark.parametrize("cards,algorithm", [
    ("mesh devices", "pallas_bank_auto"), ("2 x 2 on distinct cards", "pallas_bank_auto"),
    ("1 x 2 on distinct cards", "pallas_bank_auto"), ("mesh devices", "pallas_fused"),
    ("2 x 2 on distinct cards", "pallas_fused")])
def test_sharded_block_loop_does_not_wait_on_the_card(cuda, cards, algorithm):
    from gpuacceleratedtracking_tpu_torch.parallel import (
        channel_time_mesh, make_mesh, track_bank_sharded)

    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=3)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm=algorithm)
    if cards == "mesh devices":
        mesh = channel_time_mesh(2, 2, devices=_mesh_devices(cuda))
    else:
        chan, time_ = (2, 2) if cards.startswith("2 x 2") else (1, 2)
        mesh = make_mesh({"chan": chan, "time": time_}, devices=_distinct_cards(chan * time_))
    track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)   # builds the caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


CARD_MESHES = [(2, 1), (1, 2), (2, 2), (4, 1)]
# A sharded bank's correlator -> the wrappers each card launches K_local
# times a block (a bank route: once).
MESH_CORRELATORS = {
    "pallas_bank_auto": (epl_kernels.correlate_pallas_bank_rows,),
    "pallas_fused": (channel_kernels.correlate_pallas_fused,),
    "pallas_taps": (channel_kernels.correlate_pallas_taps, replica_kernel.code_replica),
    "xla_bank": (),
}


@pytest.mark.parametrize("algorithm", sorted(MESH_CORRELATORS))
@pytest.mark.parametrize("axes", CARD_MESHES)
def test_every_card_mesh_graph_equals_eager_with_chan_x_time_launches(cuda, monkeypatch, axes,
                                                                     algorithm):
    # On distinct cards (`graphs.scan_mesh`): the captured call equals the
    # eager one bit for bit with chan x time bank launches a block (a
    # per-channel kernel: K_local launches per card and block), every time
    # shard's replica of the carry (the eager loop's final carries, the
    # entry's cards' carries after a captured call) equals its time-0
    # card's, and the results come back on the mesh's first card.
    from gpuacceleratedtracking_tpu_torch.parallel import make_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    tree_leaves = graphs._leaves
    chan, time_ = axes
    cards = _distinct_cards(chan * time_)
    blocks, k = 4, 64
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=blocks, k=k)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm=algorithm)
    mesh = make_mesh({"chan": chan, "time": time_}, devices=cards)
    graphs.clear()
    finals = []
    loop = graphs.loop

    def spy(*args, **kwargs):
        carries, outs = loop(*args, **kwargs)
        finals.append(carries)
        return carries, outs

    monkeypatch.setattr(graphs, "loop", spy)
    wrappers = MESH_CORRELATORS[algorithm] + (loop_kernel.loop_update_kernel,)
    before = [fn.launches for fn in wrappers]
    _graph_against_eager(lambda: track_bank_sharded(config, codes, states, sre, sim, mesh=mesh))
    # Three calls (eager, capture, replay): per card and block a bank
    # launch or K_local launches of each per-channel wrapper, and a loop
    # kernel.
    per_card = 1 if algorithm == "pallas_bank_auto" else k // chan
    assert [fn.launches - b for fn, b in zip(wrappers, before)] == (
        [3 * chan * time_ * blocks * per_card] * len(MESH_CORRELATORS[algorithm])
        + [3 * chan * time_ * blocks])
    assert len(finals) == 1
    (entry,) = graphs._ENTRIES[tuple(cards)].values()
    for carries in (finals[0], tuple(card.carry for card in entry.cards)):
        for c in range(chan):
            for t in range(1, time_):
                # Each replica on its own card, the same bits.
                _assert_bitwise(*(tuple(x.cpu() for x in tree_leaves(carries[c * time_ + s]))
                                  for s in (t, 0)))
    final, out = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    assert out.prompt_re.device == cards[0] and final.prn.device == cards[0]


@pytest.mark.parametrize("axes", CARD_MESHES)
def test_a_replayed_block_on_distinct_cards_is_each_cards_kernels(cuda, axes):
    # Per card and replayed block: its bank launch, its partials' copies to
    # the channel shard's other cards, one finish, one loop kernel and its
    # index's add, nothing else (torch.profiler, after spin kernels; it may
    # drop a session's first events: at most, and some).
    from torch.profiler import ProfilerActivity, profile

    from gpuacceleratedtracking_tpu_torch.parallel import make_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    chan, time_ = axes
    cards = _distinct_cards(chan * time_)
    fs, codes, states, sre, sim = _sharded_case(cuda, n=32768, blocks=2, k=1024)
    config = TrackConfig.for_system(SYSTEM, fs, 32768, algorithm="pallas_bank_auto")
    mesh = make_mesh({"chan": chan, "time": time_}, devices=cards)
    graphs.clear()
    track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    torch.cuda.synchronize()
    (entry,) = graphs._ENTRIES[tuple(cards)].values()
    assert [len(group) for group in entry.groups] == [time_] * chan
    # Every group's graph's nodes, counted at capture: per card at least its
    # bank launch, finish, loop kernel and index add, at most T - 1 copies more.
    assert 4 * chan * time_ <= entry.nodes <= (3 + time_) * chan * time_, entry.nodes
    replays = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _spin_first()
        for _ in range(replays):
            for replay, _ in entry.replays:
                replay()
        for card in cards:
            torch.cuda.synchronize(card)
    graphs.clear()
    per_card: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            per_card.setdefault(e.device_index, collections.Counter())[e.name] += 1
    assert set(per_card) <= {card.index for card in cards}, per_card
    for index, names in per_card.items():
        def count(*keys):
            return sum(n for name, n in names.items() if any(k in name for k in keys))

        copies = count("Memcpy", "memcpy", "copy")
        assert 1 <= count("bank_rows_kernel") <= replays, (index, names)
        assert count("bank_rows_finish") <= replays and count("loop_update") <= replays, names
        assert count("add") <= replays, (index, names)
        assert copies <= (time_ - 1) * replays, (index, names)
        assert sum(names.values()) <= (4 + time_ - 1) * replays, (index, names)
    assert sum(count for names in per_card.values() for name, count in names.items()
               if "bank_rows_finish" in name) >= 1


@pytest.mark.parametrize("algorithm", ["pallas_fused", "pallas_taps"])
@pytest.mark.parametrize("axes", CARD_MESHES)
def test_a_replayed_block_on_distinct_cards_launches_each_cards_channels(cuda, axes,
                                                                         algorithm):
    # A per-channel kernel on distinct cards: each channel shard's replayed
    # block launches K_local kernels (`pallas_taps`: K_local replica and
    # K_local taps launches) and one loop kernel per card, as its capture
    # counted them; torch.profiler finds them on each card, none elsewhere,
    # and at most T - 1 partials' copies per card (it may drop a session's
    # first events: at most, and some).
    from torch.profiler import ProfilerActivity, profile

    from gpuacceleratedtracking_tpu_torch.parallel import make_mesh, track_bank_sharded
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    chan, time_ = axes
    cards = _distinct_cards(chan * time_)
    k = 16
    fs, codes, states, sre, sim = _sharded_case(cuda, n=32768, blocks=2, k=k, num_ants=4)
    config = TrackConfig.for_system(SYSTEM, fs, 32768, algorithm=algorithm)
    mesh = make_mesh({"chan": chan, "time": time_}, devices=cards)
    graphs.clear()
    track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    torch.cuda.synchronize()
    (entry,) = graphs._ENTRIES[tuple(cards)].values()
    assert [len(group) for group in entry.groups] == [time_] * chan
    kernels = {"pallas_fused": ("fused_kernel",), "pallas_taps": ("taps_kernel", "replica_kernel")}
    expected = dict.fromkeys(MESH_CORRELATORS[algorithm], time_ * k // chan)
    expected[loop_kernel.loop_update_kernel] = time_
    for _, launched in entry.replays:
        assert {fn: n for fn, n in zip(graphs._counters(), launched) if n} == expected
    replays = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _spin_first()
        for _ in range(replays):
            for replay, _ in entry.replays:
                replay()
        for card in cards:
            torch.cuda.synchronize(card)
    graphs.clear()
    per_card: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            per_card.setdefault(e.device_index, collections.Counter())[e.name] += 1
    assert set(per_card) <= {card.index for card in cards}, per_card
    for index, names in per_card.items():
        def count(*keys):
            return sum(n for name, n in names.items() if any(key in name for key in keys))

        for name in kernels[algorithm]:
            assert count(name) <= k // chan * replays, (index, names)
        assert count("loop_update") <= replays, (index, names)
        assert count("Memcpy", "memcpy") <= (time_ - 1) * replays, (index, names)
    assert all(sum(count for name, count in names.items() if kernels[algorithm][0] in name) >= 1
               for names in per_card.values())


def test_a_per_channel_bank_on_mesh_devices_of_one_card_matches_track_bank(cuda):
    # `pallas_fused` through `track_bank_sharded` with every shard on
    # cuda:0 (the one-card branch): K x time launches a block; a
    # channel-only mesh equals `track_bank` bit for bit (each channel its
    # own launches), a time-sharded one within the main path's bound (each
    # shard from advanced phases).
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded

    blocks, k = 5, 16
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=blocks, k=k)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_fused")
    want_final, want = track_bank(config, codes, states, sre, sim)
    for chan, time_ in ((4, 1), (2, 2), (1, 4)):
        mesh = channel_time_mesh(chan, time_, devices=[cuda] * 4)
        before = channel_kernels.correlate_pallas_fused.launches
        final, got = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
        torch.cuda.synchronize()
        assert channel_kernels.correlate_pallas_fused.launches - before == k * time_ * blocks
        assert got.prompt_re.shape == (blocks, k) and bool(torch.isfinite(got.prompt_re).all())
        if time_ == 1:
            _assert_bitwise((final, got), (want_final, want))
            continue
        torch.testing.assert_close(got.prompt_re[0], want.prompt_re[0], rtol=5e-3, atol=10.0)
        torch.testing.assert_close(got.prompt_re[:, :3], want.prompt_re[:, :3],
                                   rtol=5e-3, atol=10.0)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
def test_correlate_sharded_on_the_per_channel_kernels(cuda, kernel):
    from gpuacceleratedtracking_tpu_torch.parallel import correlate_sharded, make_mesh

    n = 1 << 17
    sig, fs = gen_signal(SYSTEM, 3, 1200.0, n, start_code_phase=100.5, num_ants=4, device=cuda)
    sre, sim = soa(sig)
    shifts = tuple(int(s) for s in correlator_sample_shifts(SYSTEM, EPLCorrelator(7), fs))
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    args = (torch.as_tensor(SYSTEM.codes, device=cuda), 3, 1200.0, fs, 0.0,
            SYSTEM.code_frequency, 100.5, shifts, SYSTEM.code_length)
    want = fn(sre, sim, *args)
    before = fn.launches
    mesh = make_mesh({"ant": 2, "time": 2}, devices=_mesh_devices(cuda))
    got = correlate_sharded(sre, sim, *args, mesh=mesh, algorithm=f"pallas_{kernel}",
                            nominal_code_frequency=SYSTEM.code_frequency, ant_axis="ant")
    torch.cuda.synchronize()
    assert fn.launches - before == 4
    for g, w in zip(got, want):
        assert g.shape == (4, 7)
        torch.testing.assert_close(g, w, rtol=2e-3, atol=5.0)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
@pytest.mark.parametrize("n", [16384, 1 << 17])
def test_channel_kernels_launch_on_every_card(cuda, kernel, n):
    # A shard on cuda:i launches under torch.cuda.device(i). N=16384 is one
    # cluster of 16 CTAs, a size each card's kernel must be allowed; 2^17
    # takes clusters of 8 and the cached scratch of that card.
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    plain = getattr(channel_kernels, f"correlate_{kernel}_reference")
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        sig, fs = gen_signal(SYSTEM, 3, 1200.0, n, start_code_phase=100.5, device=dev)
        args = (*soa(sig), torch.as_tensor(SYSTEM.codes, device=dev), 3, 1200.0, fs, 0.0,
                SYSTEM.code_frequency, 100.5, (-16, 0, 16), SYSTEM.code_length)
        with torch.cuda.device(dev):
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.device == dev
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * n + 1e-3)


# The captured block loop (`tracking.graphs`): every entry point replays a
# CUDA graph of its block body on the card; `graphs.eager()` runs the loop.

def _launch_counts():
    """Each wrapper's launch count in `graphs._counters` order, but the rows
    kernel's build counts, which split the rows routes' launches."""
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    builds = _build_counters()
    return [fn.launches for fn in graphs._counters() if fn not in builds]


def _build_counters():
    return (epl_kernels.boundary_rows, epl_kernels.position_rows)


def _assert_bitwise(got, want):
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    got, want = graphs._leaves(got), graphs._leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w)


def _graph_against_eager(run):
    """``run()`` under `eager()`, then twice through the graph (the first call
    captures, the second replays): bit for bit the same, and each call moves
    every launch count by as much as the eager loop does."""
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    def counts():
        return _launch_counts() + [fn.launches for fn in _build_counters()]

    c0 = counts()
    with graphs.eager():
        want = run()
    torch.cuda.synchronize()
    c1 = counts()
    got = run()
    torch.cuda.synchronize()
    c2 = counts()
    again = run()
    torch.cuda.synchronize()
    c3 = counts()
    moves = [b - a for a, b in zip(c0, c1)]
    assert [b - a for a, b in zip(c1, c2)] == moves
    assert [b - a for a, b in zip(c2, c3)] == moves
    eager, builds = moves[:-2], moves[-2:]
    assert sum(builds) == sum(eager[:3])          # the rows routes' launches, split by build
    _assert_bitwise(got, want)
    _assert_bitwise(again, want)
    return eager


# name -> (algorithm, K, A, TrackConfig extras, steering weights)
GRAPH_CASES = {
    "rows": ("pallas_bank_auto", 64, None, {}, False),
    "comp_f32": ("pallas_bank_auto", 64, 4, {"num_correlators": 7}, True),
    "comp_bf16": ("pallas_bank_auto", 64, 4, {"num_correlators": 7, "z_dtype": "bf16"}, True),
    "transition": ("pallas_bank", 64, None, {}, False),
    "onehot": ("pallas_bank_onehot", 64, None, {}, False),
    "taps": ("pallas_taps", 8, None, {}, False),
    "fused": ("pallas_fused", 8, None, {}, False),
    "xla_bank": ("xla_bank", 64, None, {}, False),
    "fused_xla": ("fused_xla", 8, None, {}, False),
    "unfused_xla": ("unfused_xla", 8, None, {}, False),
}


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_track_bank_graph_equals_eager(cuda, name):
    algorithm, k, num_ants, extra, steered = GRAPH_CASES[name]
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=5, k=k, num_ants=num_ants)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm=algorithm, **extra)
    states = init_state(states.prn.cpu().numpy(), carrier_doppler=states.carrier_doppler.cpu(),
                        num_taps=len(config.sample_shifts), device=cuda)
    weights = None
    if steered:
        phase = torch.arange(num_ants, dtype=torch.float32, device=cuda) * 0.7
        weights = (torch.cos(phase), torch.sin(phase))
    launched = _graph_against_eager(
        lambda: track_bank(config, codes, states, sre, sim, ant_weights=weights))
    per_block = {"pallas_taps": k, "pallas_fused": k}.get(algorithm, 1)
    # `graphs._counters()`: the six correlators, the code tiles' packing, the
    # replica, the dual loop, the loop.
    *correlators, packs, replicas, duals, loops = launched
    assert sum(correlators) == (0 if algorithm.endswith("_xla") or algorithm == "xla_bank"
                                else per_block * 5)
    assert packs == (1 if algorithm.startswith("pallas_bank") else 0)    # once per call
    assert replicas == (k * 5 if algorithm == "pallas_taps" else 0)
    assert duals == 0 and loops == 5


def test_track_graph_equals_eager_over_chunks(cuda):
    # 70 blocks: more than one chunk of stacked outputs.
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    n, blocks = 8192, graphs.CHUNK + 6
    sig, fs = gen_signal(SYSTEM, 0, 700.0, n * blocks, duration=blocks * 1e-3, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    state = init_state(0, carrier_doppler=690.0, device=cuda)
    config = TrackConfig.for_system(SYSTEM, fs, n, algorithm="pallas_fused")
    # `graphs._counters()`: the five correlators, fused, the code tiles'
    # packing, the replica, the dual loop, the loop.
    assert _graph_against_eager(lambda: track(config, codes, state, sre, sim)) == \
        [0, 0, 0, 0, 0, blocks, 0, 0, 0, blocks]


@pytest.mark.parametrize("algorithm", ["pallas_bank_auto", "pallas_fused"])
def test_track_bank_dual_graph_equals_eager(cuda, algorithm):
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    n, blocks, k = 16384, 5, 4
    sig, _ = gen_signal(sys_i, 2, 700.0, n * blocks, duration=blocks * 1e-3,
                        secondary_code=sys_i.secondary_code, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    config = dual_config(TrackConfig.for_system(sys_i, n / 1e-3, n, algorithm=algorithm,
                                                use_secondary=False))
    states = init_state(np.arange(2, 2 + k), carrier_doppler=np.linspace(-600, 700, k),
                        ms_elapsed=np.arange(k) * 3, device=cuda)
    codes_i = torch.as_tensor(sys_i.codes, device=cuda)
    codes_q = torch.as_tensor(sys_q.codes, device=cuda)
    launched = _graph_against_eager(
        lambda: track_bank_dual(config, codes_i, codes_q, states, sre, sim))
    assert launched[-2:] == [blocks, 0]        # the dual loop kernel once per block


def _device_op_names(run) -> list:
    """The device ops of one call of ``run`` (after a warm-up call), by name."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("path", ["track_bank", "track", "track_bank_dual"])
def test_replayed_blocks_write_their_outputs_without_index_copy(cuda, path, monkeypatch):
    # The loop kernel writes the block's outputs and carry through the
    # entry's sink: the captured body issues no index_copy_ (counted on the
    # host while it is captured), and a replayed call's device ops hold none,
    # where the same body without the sink holds one per output leaf.
    from gpuacceleratedtracking_tpu_torch.tracking import graphs
    from gpuacceleratedtracking_tpu_torch.tracking.dual import dual_parts
    from gpuacceleratedtracking_tpu_torch.tracking.track import bank_correlator, bank_step

    blocks = 5
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=blocks)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_bank_auto")
    prepare = None
    if path == "track_bank":
        step, carry, consts = bank_step(config, *bank_correlator(config)), states, (
            codes, epl_kernels.prepare_bank_code_tiles_rows(codes, states.prn), None)
    elif path == "track":
        config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_fused")
        carry, consts = init_state(0, carrier_doppler=-900.0, device=cuda), (codes, None)

        def step(st, c, block, sink=None):
            from gpuacceleratedtracking_tpu_torch.tracking.track import track_step
            return track_step(config, c[0], st, *block, c[1], sink)
    else:
        sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
        sig, fs = gen_signal(sys_i, 2, 700.0, 16384 * blocks, duration=blocks * 1e-3,
                             secondary_code=sys_i.secondary_code, device=cuda)
        sre, sim = (x.reshape(blocks, 16384) for x in soa(sig))
        config = dual_config(TrackConfig.for_system(sys_i, fs, 16384, algorithm="pallas_bank_auto",
                                                    use_secondary=False))
        carry = init_state(np.arange(4), carrier_doppler=np.linspace(-600, 700, 4), device=cuda)
        step, consts, prepare = dual_parts(config, torch.as_tensor(sys_i.codes, device=cuda),
                                           torch.as_tensor(sys_q.codes, device=cuda), cuda)
    sunk = graphs.writes_outputs(step)
    plain = lambda st, c, block: step(st, c, block)          # the same body, no sink
    calls = []
    index_copy = torch.Tensor.index_copy_

    def counted(self, *args, **kwargs):
        calls.append(self.shape)
        return index_copy(self, *args, **kwargs)

    graphs.clear()
    monkeypatch.setattr(torch.Tensor, "index_copy_", counted)
    want = graphs.scan(plain, carry, (sre, sim), consts, key=(path, "plain"), prepare=prepare)
    leaves = len(calls)
    got = graphs.scan(sunk, carry, (sre, sim), consts, key=(path, "sink"), prepare=prepare)
    assert leaves in (11, 13) and len(calls) == leaves
    monkeypatch.undo()
    _assert_bitwise(got, want)
    sink_ops = _device_op_names(lambda: graphs.scan(
        sunk, carry, (sre, sim), consts, key=(path, "sink"), prepare=prepare))
    plain_ops = _device_op_names(lambda: graphs.scan(
        plain, carry, (sre, sim), consts, key=(path, "plain"), prepare=prepare))
    assert sum("index_copy" in name for name in plain_ops) == leaves * blocks
    assert not any("index_copy" in name for name in sink_ops)
    assert len(plain_ops) - len(sink_ops) >= leaves * blocks


def test_sharded_banks_graph_equal_eager(cuda):
    from gpuacceleratedtracking_tpu_torch.parallel import (
        channel_time_mesh, track_bank_dual_sharded, track_bank_sharded)

    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=5)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_bank_auto")
    for chan, time_ in ((2, 2), (4, 1)):
        mesh = channel_time_mesh(chan, time_, devices=_mesh_devices(cuda))
        _graph_against_eager(
            lambda: track_bank_sharded(config, codes, states, sre, sim, mesh=mesh))
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    n = 16384
    sig, _ = gen_signal(sys_i, 2, 700.0, n * 5, duration=5e-3,
                        secondary_code=sys_i.secondary_code, device=cuda)
    s5re, s5im = (x.reshape(5, n) for x in soa(sig))
    cfg5 = dual_config(TrackConfig.for_system(sys_i, n / 1e-3, n, algorithm="pallas_bank_auto",
                                              use_secondary=False))
    states5 = init_state(np.arange(4), carrier_doppler=np.linspace(-900, 900, 4), device=cuda)
    mesh = channel_time_mesh(2, 1, devices=_mesh_devices(cuda)[:2])
    _graph_against_eager(lambda: track_bank_dual_sharded(
        cfg5, torch.as_tensor(sys_i.codes, device=cuda), torch.as_tensor(sys_q.codes, device=cuda),
        states5, s5re, s5im, mesh=mesh))


@pytest.mark.parametrize("name", ["rows", "comp_f32", "dual", "track"])
def test_second_graph_call_does_not_wait_on_the_card(cuda, name):
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=4,
                                                num_ants=4 if name == "comp_f32" else None)
    if name == "dual":
        sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
        config = dual_config(TrackConfig.for_system(sys_i, 32.768e6, 32768,
                                                    algorithm="pallas_bank_auto",
                                                    use_secondary=False))
        sig, _ = gen_signal(sys_i, 2, 700.0, 32768 * 4, duration=4e-3, device=cuda)
        sre, sim = (x.reshape(4, 32768) for x in soa(sig))
        ci = torch.as_tensor(sys_i.codes, device=cuda)
        cq = torch.as_tensor(sys_q.codes, device=cuda)
        run = lambda: track_bank_dual(config, ci, cq, states, sre, sim)  # noqa: E731
    elif name == "track":
        config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_fused")
        state = init_state(0, carrier_doppler=-900.0, device=cuda)
        run = lambda: track(config, codes, state, sre, sim)  # noqa: E731
    else:
        config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_bank_auto")
        weights = None
        if name == "comp_f32":
            weights = (torch.ones(4, device=cuda), torch.zeros(4, device=cuda))
        run = lambda: track_bank(config, codes, states, sre, sim, ant_weights=weights)  # noqa
    first = run()                                       # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _assert_bitwise(second, first)


def _chained_run(cuda, name):
    """A path's call over blocks ``lo:hi`` from a state, and its first state."""
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=6,
                                                num_ants=4 if name == "comp_f32" else None)
    if name == "dual":
        sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
        config = dual_config(TrackConfig.for_system(sys_i, 32.768e6, 32768,
                                                    algorithm="pallas_bank_auto",
                                                    use_secondary=False))
        sig, _ = gen_signal(sys_i, 2, 700.0, 32768 * 6, duration=6e-3, device=cuda)
        sre, sim = (x.reshape(6, 32768) for x in soa(sig))
        ci = torch.as_tensor(sys_i.codes, device=cuda)
        cq = torch.as_tensor(sys_q.codes, device=cuda)
        return lambda st, lo, hi: track_bank_dual(config, ci, cq, st, sre[lo:hi], sim[lo:hi]), \
            states
    if name == "track":
        config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_fused")
        return lambda st, lo, hi: track(config, codes, st, sre[lo:hi], sim[lo:hi]), \
            init_state(0, carrier_doppler=-900.0, device=cuda)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_bank_auto")
    weights = None
    if name == "comp_f32":
        weights = (torch.ones(4, device=cuda), torch.zeros(4, device=cuda))
    return lambda st, lo, hi: track_bank(config, codes, st, sre[lo:hi], sim[lo:hi],
                                         ant_weights=weights), states


@pytest.mark.parametrize("name", ["rows", "comp_f32", "dual", "track"])
def test_chained_graph_calls_equal_eager(cuda, name):
    # Each call's final state passed to the next (a load of one copy per
    # dtype), the code tiles derived in the captured prologue: bit for bit
    # two eager calls, over two rounds of two chained calls.
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    call, state = _chained_run(cuda, name)
    with graphs.eager():
        first = call(state, 0, 3)
        want = (first, call(first[0], 3, 6))
    for _ in range(2):
        first = call(state, 0, 3)
        got = (first, call(first[0], 3, 6))
        torch.cuda.synchronize()
        _assert_bitwise(got, want)


@pytest.mark.parametrize("name", ["rows", "dual"])
def test_steady_call_allocates_no_segment_and_does_not_wait(cuda, name):
    # A chained second call (its input the first call's results) and a third
    # ask the device for no memory and never wait on the card.
    call, state = _chained_run(cuda, name)
    st = call(state, 0, 3)[0]                         # captures
    torch.cuda.synchronize()
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for lo in (3, 0, 3):
            st, out = call(st, lo, lo + 3)
            del out
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["segment.all.allocated"] == segments


def test_outputs_kept_across_calls_are_not_overwritten(cuda):
    # As StreamTracker keeps every chunk's outputs: one call's results never
    # alias a graph buffer, and the caller's inputs are never written.
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=6)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_bank_auto")
    inputs = [x.clone() for x in (sre, sim, states.carrier_phase, states.code_phase)]
    outs, st = [], states
    for c in range(3):
        st, out = track_bank(config, codes, st, sre[2 * c:2 * c + 2], sim[2 * c:2 * c + 2])
        outs.append(out)
    torch.cuda.synchronize()
    _, whole = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    for field in ("prompt_re", "carrier_doppler", "code_phase"):
        kept = torch.cat([getattr(o, field) for o in outs])
        assert torch.equal(kept, getattr(whole, field)), field
    for x, y in zip(inputs, (sre, sim, states.carrier_phase, states.code_phase)):
        assert torch.equal(x, y)


def test_flooded_constant_caches_leave_the_replay_unchanged(cuda):
    # A graph bakes the addresses of the cached tile base, tap offsets and
    # overlay table; those caches never evict, so flooding them (and reusing
    # the memory freed around them) does not reach the replay.
    import importlib

    track_mod = importlib.import_module("gpuacceleratedtracking_tpu_torch.tracking.track")

    system = BeiDouB1I()
    n, blocks = 8192, 4
    config = TrackConfig.for_system(system, n / 1e-3, n, algorithm="pallas_bank_auto")
    assert len(config.secondary_code) == 20
    sig, fs = gen_signal_mixed(system, [0, 1], [800.0, -1400.0], n * blocks,
                               duration=blocks * 1e-3, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    codes = torch.as_tensor(system.codes, device=cuda)
    states = init_state(np.arange(16), carrier_doppler=np.linspace(-3000, 3000, 16),
                        ms_elapsed=5, device=cuda)
    _, first = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    for i in range(100):
        epl_kernels._tile_base(3, epl_kernels.TILE, 0.0, 1e-3 * i, 1023, cuda)
        epl_kernels._deltas((0, i, 2 * i), cuda)
        track_mod._overlay_table((1.0, -1.0) * (i + 1), cuda)
    junk = [torch.full((1 << 16,), float("nan"), device=cuda) for _ in range(64)]
    torch.cuda.synchronize()
    _, again = track_bank(config, codes, states, sre, sim)
    torch.cuda.synchronize()
    del junk
    _assert_bitwise(again, first)


def test_a_capture_that_fails_raises(cuda):
    # A host read of a device value cannot be captured: the call raises,
    # caches nothing and leaves the launch counts as they were; it never
    # falls back to the eager loop.
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    def step(carry, consts, block):
        float(block[0].sum())
        return carry + block[0], carry

    device = torch.device("cuda", torch.cuda.current_device())
    counts = _launch_counts()
    entries = dict(graphs._ENTRIES.get(device, {}))
    with pytest.raises(RuntimeError):
        graphs.scan(step, torch.zeros(4, device=device), (torch.ones(3, 4, device=device),),
                    key=("refused",))
    torch.cuda.synchronize()
    assert dict(graphs._ENTRIES.get(device, {})) == entries
    assert _launch_counts() == counts


# Outside the correlator kernels' instantiations (A <= 4, L in {3, 5, 7}):
# the wrappers launch the groups of `epl_kernels.launch_groups`, each with the
# call's phase origin, and gather their columns. Shapes: name -> (A, taps or
# explicit shifts).
AL_SHAPES = {"a5_l3": (5, 3), "a6_l3": (6, 3), "a8_l3": (8, 3),
             "a1_l4": (1, (-24, -8, 0, 16)), "a1_l9": (1, 9), "a1_l11": (1, 11),
             "a8_l9": (8, 9)}
AL_ROUTES = ("pallas_bank_rows", "comp_f32", "comp_bf16", "pallas_bank", "pallas_bank_onehot",
             "pallas_taps", "pallas_fused")


def _al_case(device, route, shape):
    """A cell each route's envelope admits: GPS L1 at 8.192 MHz (K=5 for the
    banks), GPS L5 at 32.768 MHz for the transition route (span 20 samples at
    L=11, under its 128)."""
    num_ants, taps = AL_SHAPES[shape]
    shifts = taps if isinstance(taps, tuple) else None
    taps = taps if shifts is None else 3
    if route == "pallas_bank":
        return _case(device, 32768, 5, num_ants=num_ants, taps=taps, shifts=shifts,
                     system=GPSL5(), seed=12)
    case = _case(device, 8192, 5, num_ants=num_ants, taps=taps, shifts=shifts, seed=11)
    if route == "pallas_bank_onehot":
        del case["nominal_code_frequency"]
    return case


@pytest.mark.parametrize("shape", sorted(AL_SHAPES))
@pytest.mark.parametrize("route", AL_ROUTES)
def test_kernels_take_every_antenna_and_tap_count(cuda, route, shape):
    case = _al_case(cuda, route, shape)
    num_ants, num_taps = case["signal_re"].shape[0] if case["signal_re"].ndim == 2 else 1, \
        len(case["sample_shifts"])
    groups = len(epl_kernels.launch_groups(num_ants, num_taps))
    if route in ("pallas_taps", "pallas_fused"):
        kind = route[len("pallas_"):]
        args = tuple(case[k] if k != "prn" else case["prn"][0] for k in (
            "signal_re", "signal_im", "codes", "prn")) + (
            case["carrier_frequency"][0], case["sampling_frequency"], case["carrier_phase"][0],
            case["code_frequency"][0], case["code_phase"][0], case["sample_shifts"],
            case["code_length"])
        fn = getattr(channel_kernels, f"correlate_pallas_{kind}")
        before = fn.launches, replica_kernel.code_replica.launches
        got = fn(*args)
        torch.cuda.synchronize()
        # taps: one replica launch per tap group, shared by its antenna groups.
        tap_groups = len(epl_kernels.launch_groups(1, num_taps)) if kind == "taps" else 0
        assert (fn.launches, replica_kernel.code_replica.launches) == \
            (before[0] + groups, before[1] + tap_groups)
        want = getattr(channel_kernels, f"correlate_{kind}_reference")(*args)
        _assert_channel_close(got, want, 8192)
        if kind == "taps":
            call = channel_kernels.ChannelCall(*args, "taps")
            channel_kernels.launch_taps(call)
            assert len(call.tap_tables) == tap_groups
            for taps, rows in call.tap_tables.items():
                assert torch.equal(rows, channel_kernels._tap_rows_plain(call, taps))
        return
    if route.startswith("comp"):
        z_dtype = route[len("comp_"):]
        counter = bank_comp.correlate_pallas_bank_comp
        before = counter.launches
        got = bank_comp.correlate_pallas_bank_comp(**case, z_dtype=z_dtype)
        torch.cuda.synchronize()
        want = bank_comp.correlate_bank_comp_reference(**case, z_dtype=z_dtype)
        scale = float(want[0].abs().max())
        tol = dict(rtol=0, atol=3e-5 * scale + 1e-3)
    else:
        counter = registry.get(route)
        before = counter.launches
        got = counter(**case)
        torch.cuda.synchronize()
        want = epl_kernels.correlate_bank_rows_reference(**case, route=route)
        tol = dict(rtol=2e-3, atol=4.5)
    assert counter.launches == before + groups
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((5, num_taps) if num_ants == 1 else (5, num_ants, num_taps))
        torch.testing.assert_close(g, w, **tol)


def test_track_bank_with_eight_antennas_on_the_auto_route(cuda):
    # A=8 resolves to the composite route, two launches (4 + 4 antennas) per
    # block, through the captured block loop; against the plain xla_bank.
    n, blocks, k, num_ants = 8192, 4, 8, 8
    sig, fs = gen_signal_mixed(SYSTEM, [0, 1, 2], [-900.0, 100.0, 1500.0], n * blocks,
                               duration=blocks * 1e-3, num_ants=num_ants, device=cuda)
    sre, sim = (x.reshape(num_ants, blocks, n).transpose(0, 1).contiguous() for x in soa(sig))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    dops = np.linspace(-4000.0, 4000.0, k)
    dops[:3] = [-900.0, 100.0, 1500.0]
    states = init_state(np.arange(k) % 32, carrier_doppler=dops, device=cuda)
    outs = {}
    for algo in ("pallas_bank_auto", "xla_bank"):
        config = TrackConfig.for_system(SYSTEM, fs, n, algorithm=algo)
        before = bank_comp.correlate_pallas_bank_comp.launches
        _, outs[algo] = track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        launched = bank_comp.correlate_pallas_bank_comp.launches - before
        assert launched == (2 * blocks if algo == "pallas_bank_auto" else 0)
    got, want = outs["pallas_bank_auto"], outs["xla_bank"]
    # test_track_bank_launches_once_per_block's bound, per antenna of the
    # antenna sum: block 0 for every channel, the satellites' channels always.
    torch.testing.assert_close(got.prompt_re[0], want.prompt_re[0], rtol=5e-3,
                               atol=10.0 * num_ants)
    torch.testing.assert_close(got.prompt_re[:, :3], want.prompt_re[:, :3], rtol=5e-3,
                               atol=10.0 * num_ants)


# The replica kernel (csrc/replica.cu): the taps wrapper's tap matrix, each
# launch group's rows (a padded group repeats its last tap: equal offsets)
# and the replica benchmark's row, bit for bit against the plain replica ops.
# N=10240 (the replica experiment's) and N=4093 are not multiples of 4 or of
# a tile; at N=2^18 L=11 the taps span 1280 samples, two launches. From
# 3 x 2^17 elements in two rows or more the kernel writes through shared
# tiles (N=2^18, and N=200003 with its rows off 16-byte boundaries), below
# that one element per thread.
REPLICA_CASES = {
    "l1_n2048_l3": (SYSTEM, 2048, 3, 0, 0.0),
    "l1_n32768_l7": (SYSTEM, 32768, 7, 5, 517.3),
    "l1_n262144_l7": (SYSTEM, 262144, 7, 31, 1022.9),
    "l5_n32768_l3": (GPSL5(), 32768, 3, 3, 10229.25),
    "l5_n262144_l7": (GPSL5(), 262144, 7, 17, 4711.5),
    "l1_n10240_l9": (SYSTEM, 10240, 9, 11, 1000.1),
    "l1_n4093_l11": (SYSTEM, 4093, 11, 21, 3.7),
    "l5_n10240_l11": (GPSL5(), 10240, 11, 7, 10229.9),
    "l1_n262144_l11": (SYSTEM, 262144, 11, 2, 1022.5),
    "l1_n200003_l9": (SYSTEM, 200003, 9, 9, 77.7),
}


@pytest.mark.parametrize("mode", ["exact", "quantized"])
@pytest.mark.parametrize("name", sorted(REPLICA_CASES))
def test_replica_kernel_equals_plain_bit_for_bit(cuda, name, mode):
    system, n, taps, prn, phase = REPLICA_CASES[name]
    fs = n / 1e-3
    shifts = tuple(int(s) for s in correlator_sample_shifts(system, EPLCorrelator(taps), fs))
    codes = torch.as_tensor(system.codes, device=cuda)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=cuda)  # noqa: E731
    for args in ((prn, system.code_frequency, phase),
                 (t(prn, torch.int64), t(system.code_frequency + 2.5), t(phase))):
        before = replica_kernel.code_replica.launches
        row = replica_kernel.code_replica(codes, args[0], args[1], fs, args[2], n, min(shifts),
                                          max(shifts), system.code_length, mode)
        taps_m = replica_kernel.code_tap_matrix(codes, args[0], args[1], fs, args[2], n,
                                                shifts, system.code_length, mode)
        groups = {g for _, _, g in epl_kernels.launch_groups(1, taps)} if taps > 7 else set()
        group_rows = {g: replica_kernel.launch_replica(
            codes, args[0], args[1], fs, args[2], [shifts[i] for i in g], n, min(shifts),
            system.code_length, mode) for g in groups}
        torch.cuda.synchronize()
        assert replica_kernel.code_replica.launches == (
            before + 1 + len(replica_kernel.launch_plan(shifts)) + len(groups))
        want_row = replica_kernel.replica_plain(codes, *args[:1], args[1], fs, args[2], n,
                                                min(shifts), max(shifts), system.code_length,
                                                mode)
        want_taps = replica_kernel.tap_matrix_plain(codes, args[0], args[1], fs, args[2], n,
                                                    shifts, system.code_length, mode)
        assert torch.equal(row, want_row) and torch.equal(taps_m, want_taps)
        for g, rows in group_rows.items():
            assert torch.equal(rows, want_taps[list(g)]), g


@pytest.mark.parametrize("name", sorted(CHANNEL_CASES))
def test_pallas_taps_unchanged_by_the_replica_kernel(cuda, monkeypatch, name):
    # The replica kernel writes each launch group's tap matrix as the plain
    # replica ops do, and the taps kernel's result from it equals, bit for
    # bit, its result from the plain ops' rows.
    args = _channel_args(cuda, name)
    call = channel_kernels.ChannelCall(*args, "taps")
    got = channel_kernels.launch_taps(call)
    assert call.tap_tables
    for taps, rows in call.tap_tables.items():
        assert torch.equal(rows, channel_kernels._tap_rows_plain(call, taps))
    monkeypatch.setattr(channel_kernels, "_tap_rows", channel_kernels._tap_rows_plain)
    want = channel_kernels.launch_taps(channel_kernels.ChannelCall(*args, "taps"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pallas_taps_call_is_the_replica_and_taps_kernels(cuda):
    from torch.profiler import ProfilerActivity, profile

    args = _channel_args(cuda, "n32768_l3")
    channel_kernels.correlate_pallas_taps(*args)
    torch.cuda.synchronize()
    calls = 10
    before = (replica_kernel.code_replica.launches, channel_kernels.correlate_pallas_taps.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _spin_first()
        for _ in range(calls):
            channel_kernels.correlate_pallas_taps(*args)
        torch.cuda.synchronize()
    # Launches first, from the wrappers' counts: a missing launch and an
    # event the profiler dropped fail with different messages.
    launched = (replica_kernel.code_replica.launches - before[0],
                channel_kernels.correlate_pallas_taps.launches - before[1])
    assert launched == (calls, calls), f"(replica, taps) launches {launched}, want {calls} each"
    device_ops = _counted_ops(prof)
    traced = (sum("replica_kernel" in name for name in device_ops),
              sum("taps_kernel" in name for name in device_ops))
    assert traced[0] == calls, (f"the profiler recorded {traced[0]} replica_kernel events for "
                                f"{launched[0]} counted launches: {device_ops}")
    assert traced[1] == calls, (f"the profiler recorded {traced[1]} taps_kernel events for "
                                f"{launched[1]} counted launches: {device_ops}")
    assert len(device_ops) <= 3 * calls, device_ops


# The harness's reps (`bench.harness.reps_program`): a timed call on the card
# replays captured graphs and calls no wrapper.

@pytest.mark.parametrize("mode,replays", [("unroll", 1), ("scan", 2)])
@pytest.mark.parametrize("algorithm", ["pallas_fused", "pallas_taps"])
def test_timed_call_replays_graphs_and_calls_no_wrapper(cuda, monkeypatch, algorithm, mode,
                                                        replays):
    from gpuacceleratedtracking_tpu_torch.bench import harness

    count = {"replays": 0}
    replay = torch.cuda.CUDAGraph.replay

    def counted(self):
        count["replays"] += 1
        return replay(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)
    reps = 6                              # scan: one graph of 4 reps, one of 2
    config = {"GNSS": "GPSL1", "num_samples": 8192, "num_ants": 1, "num_correlators": 3,
              "algorithm": algorithm, "processor": "GPU", "reps_mode": mode}
    run = harness.kernel_program(config, reps)
    eager = dict(config, reps_mode="calls")
    want = harness.kernel_program(eager, reps)()

    def refuse(*_args, **_kwargs):
        raise AssertionError("a replayed rep called a wrapper")

    monkeypatch.setattr(channel_kernels, "_launch", refuse)
    monkeypatch.setattr(replica_kernel, "launch_replica", refuse)
    fused, taps = channel_kernels.correlate_pallas_fused, channel_kernels.correlate_pallas_taps
    before = (fused.launches, taps.launches, replica_kernel.code_replica.launches)
    count["replays"] = 0
    total = run()
    torch.cuda.synchronize()
    assert count["replays"] == replays
    after = (fused.launches, taps.launches, replica_kernel.code_replica.launches)
    kind = algorithm[len("pallas_"):]
    assert [a - b for a, b in zip(after, before)] == \
        [reps if kind == "fused" else 0, reps if kind == "taps" else 0,
         reps if kind == "taps" else 0]
    torch.testing.assert_close(total, want, rtol=1e-6, atol=0)


def test_replica_benchmark_launches_the_replica_kernel_per_rep(cuda):
    from gpuacceleratedtracking_tpu_torch.bench import run_replica_benchmark

    before = replica_kernel.code_replica.launches
    res = run_replica_benchmark({"GNSS": "GPSL1", "num_samples": 4096, "algorithm": "exact",
                                 "processor": "GPU", "reps": 40, "trials": 2})
    # Warm-up and every trial run reps + 2 reps calls (32 per graph, then 8).
    assert replica_kernel.code_replica.launches - before == 3 * 40 * (2 + 1)
    assert res["reps_mode"] == "scan" and res["Median"] >= 0


def test_profile_of_a_bank_call_lists_the_bank_kernel(cuda):
    from gpuacceleratedtracking_tpu_torch.bench.profile import profile_calls

    case = _case(cuda, 32768, 64)
    got = profile_calls(lambda: epl_kernels.correlate_pallas_bank_rows(**case), reps=3,
                        label="bank_rows")
    line = got["device_timeline"]
    assert any("bank_rows" in name for name in line["rows"]), list(line["rows"])
    assert 0.0 < line["busy_share"] <= 1.0
    assert line["device_per_call_ms"] > 0 and line["window_per_call_ms"] > 0


def test_gpsl1_analog_cell_writes_a_gpu_record(cuda, tmp_path):
    import json

    from gpuacceleratedtracking_tpu_torch.bench import run_kernel_benchmark, run_sweep
    from gpuacceleratedtracking_tpu_torch.scripts import run_benchmarks_gpsl1

    cell = dict(run_benchmarks_gpsl1.params, num_samples=4096, num_ants=1, num_correlators=3,
                algorithm="pallas_fused", trials=2)
    (path,) = run_sweep(cell, run_kernel_benchmark, tmp_path, progress=False, skip_errors=False)
    record = json.loads(path.read_text())
    assert record["backend"] == "cuda" and record["processor"] == "GPU"
    assert record["gpu_name"] and record["power_limit"]
    assert "processor=GPU" in path.name and record["Median"] >= 0


def test_track_benchmarks_record_peak_memory_in_a_fresh_process(cuda):
    # The first CUDA call of the process: the peak is read after the
    # allocator exists (resetting it before raises "Invalid device argument").
    code = textwrap.dedent("""
        from gpuacceleratedtracking_tpu_torch.bench import (
            run_dual_track_benchmark, run_track_benchmark)
        for run, gnss in ((run_track_benchmark, "GPSL1"), (run_dual_track_benchmark, "GPSL5")):
            r = run({"GNSS": gnss, "num_samples": 32768, "num_channels": 8,
                     "algorithm": "pallas_bank_auto", "processor": "GPU", "blocks": 2,
                     "trials": 1})
            assert r["peak_memory_bytes"] > 0, r
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=pathlib.Path(__file__).resolve().parents[1])


# The state form and the device index (the block bodies of the bank kernels):
# name -> (wrapper, N, fs, K0, A, sample shifts or None for EPL 3, extras)
STATE_ROUTES = {
    "rows": ("pallas_bank_rows", 32768, 32.768e6, 1024, None, None, {}),
    "rows_d_min": ("pallas_bank_rows", 8192, 8.192e6, 64, None, (-7, -2, 3), {}),
    "transition_l1": ("pallas_bank", 8192, 4.096e6, 64, None, None, {}),
    "onehot": ("pallas_bank_onehot", 8192, 8.192e6, 64, None, (-160, 0, 170), {}),
    "comp_a4_l7": ("pallas_bank_comp", 32768, 32.768e6, 1024, 4,
                   (-21, -14, -7, 0, 7, 14, 21), {}),
    "comp_bf16": ("pallas_bank_comp", 8192, 8.192e6, 64, 2, None, {"z_dtype": "bf16"}),
    "auto_a8_l3": ("pallas_bank_auto", 8192, 8.192e6, 64, 8, None, {}),
}


def _state_route_case(cuda, name, modulus, blocks=3, seed=0):
    from gpuacceleratedtracking_tpu_torch.ops.epl_kernels import BankChannels

    wrapper, n, fs, k0, num_ants, shifts, extra = STATE_ROUTES[name]
    shifts = shifts or tuple(int(s) for s in correlator_sample_shifts(
        SYSTEM, EPLCorrelator(3), fs))
    rng = np.random.default_rng(seed)
    shape = (blocks, n) if num_ants is None else (blocks, num_ants, n)
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=cuda)  # noqa: E731
    chunk_re = t(rng.standard_normal(shape).astype(np.float32))
    chunk_im = t(rng.standard_normal(shape).astype(np.float32))
    codes = t(SYSTEM.codes)
    pilot = torch.roll(-codes, 11, 0).contiguous()
    prn = t(rng.integers(0, 32, k0), torch.int32)
    cd, cp = t(rng.uniform(-4000.0, 4000.0, k0)), t(rng.uniform(0.0, 2 * np.pi, k0))
    kd, kp = t(rng.uniform(-2.0, 2.0, k0)), t(rng.uniform(0.0, SYSTEM.code_length, k0))
    if modulus == 2:
        tiles = epl_kernels.pack_code_tiles(codes, prn, pilot)
        joined, prn_all = torch.cat([codes, pilot], 1), torch.cat([prn, prn + 32])
    else:
        tiles, joined, prn_all = epl_kernels.pack_code_tiles(codes, prn), codes, prn
    kwargs = dict(extra, code_tiles=tiles)
    if wrapper != "pallas_bank_onehot":
        kwargs.update(nominal_code_frequency=SYSTEM.code_frequency,
                      nominal_carrier_frequency=1500.0)
    dup = lambda x: torch.cat([x] * modulus)  # noqa: E731
    registry_args = (joined, prn_all, dup(1500.0 + cd), fs, dup(cp),
                     dup(SYSTEM.code_frequency + kd), dup(kp), shifts, SYSTEM.code_length)
    channels = BankChannels(1500.0, cd, cp, SYSTEM.code_frequency, kd, kp)
    state_args = (codes, prn, None, fs, None, None, None, shifts, SYSTEM.code_length)
    return (registry.get(wrapper), chunk_re, chunk_im, registry_args, state_args, channels,
            kwargs)


@pytest.mark.parametrize("modulus", [1, 2])
@pytest.mark.parametrize("name", sorted(STATE_ROUTES))
def test_kernels_in_the_state_form_at_the_device_index_equal_the_registry_call(cuda, name,
                                                                                 modulus):
    # The kernels derive the channels' parameters from the state leaves with
    # the roundings torch gives the plain expressions on the card, and read
    # the block at the index on the device: every accumulator bit for bit.
    corr, chunk_re, chunk_im, registry_args, state_args, channels, kwargs = \
        _state_route_case(cuda, name, modulus)
    for b in range(chunk_re.shape[0]):
        want = corr(chunk_re[b], chunk_im[b], *registry_args, **kwargs)
        state = corr(chunk_re[b], chunk_im[b], *state_args, **kwargs, channels=channels)
        index = torch.tensor(b, dtype=torch.int64, device=cuda)
        chunk = corr(chunk_re, chunk_im, *state_args, **kwargs, channels=channels,
                     block_index=index)
        torch.cuda.synchronize()
        _assert_bitwise(state, want)
        _assert_bitwise(chunk, want)


def _registry_bank_step(config, corr, kwargs):
    """`track_bank`'s block body with the registry signature's expressions."""
    from gpuacceleratedtracking_tpu_torch.tracking import loop_update

    def step(states, consts, block):
        codes, code_tiles, ant_weights = consts
        accum_re, accum_im = corr(
            block[0], block[1], codes, states.prn,
            config.intermediate_frequency + states.carrier_doppler,
            config.sampling_frequency, states.carrier_phase,
            config.code_frequency + states.code_doppler, states.code_phase,
            config.sample_shifts, config.code_length, **kwargs, code_tiles=code_tiles)
        return loop_update(config, states, accum_re, accum_im, ant_weights)

    return step


@pytest.mark.parametrize("name", ["rows", "comp_f32", "comp_bf16", "transition", "onehot"])
def test_closed_loop_at_the_device_index_equals_the_registry_expressions(cuda, name,
                                                                         monkeypatch):
    # 10 blocks in chunks of 4: the index is zeroed per chunk. The graph
    # (state form, block at the index), the eager loop (state form) and the
    # registry signature's expressions closed by the same loop kernel give
    # one trajectory, bit for bit.
    from gpuacceleratedtracking_tpu_torch.tracking import graphs
    from gpuacceleratedtracking_tpu_torch.tracking.track import bank_correlator

    algorithm, k, num_ants, extra, steered = GRAPH_CASES[name]
    monkeypatch.setattr(graphs, "CHUNK", 4)
    graphs.clear()
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=10, k=k, num_ants=num_ants)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm=algorithm, **extra)
    states = init_state(states.prn.cpu().numpy(), carrier_doppler=states.carrier_doppler.cpu(),
                        num_taps=len(config.sample_shifts), device=cuda)
    weights = None
    if steered:
        phase = torch.arange(num_ants, dtype=torch.float32, device=cuda) * 0.7
        weights = (torch.cos(phase), torch.sin(phase))
    corr, kwargs = bank_correlator(config)
    tiles = epl_kernels.pack_code_tiles(codes, states.prn)
    w = None if weights is None else tuple(x.expand(k, num_ants) for x in weights)
    with graphs.eager():
        want = graphs.loop(_registry_bank_step(config, corr, kwargs), states, (sre, sim),
                           (codes, tiles, w))
        eager = track_bank(config, codes, states, sre, sim, ant_weights=weights)
    got = track_bank(config, codes, states, sre, sim, ant_weights=weights)
    torch.cuda.synchronize()
    assert [e.chunk for e in graphs._ENTRIES[states.prn.device].values()] == [4]
    _assert_bitwise(eager, want)
    _assert_bitwise(got, want)
    graphs.clear()


def test_closed_dual_loop_at_the_device_index_equals_the_joined_expressions(cuda, monkeypatch):
    from gpuacceleratedtracking_tpu_torch.tracking import graphs
    from gpuacceleratedtracking_tpu_torch.tracking.dual import _overlay, dual_update
    from gpuacceleratedtracking_tpu_torch.tracking.track import bank_correlator
    from gpuacceleratedtracking_tpu_torch.models import gpsl5

    monkeypatch.setattr(graphs, "CHUNK", 4)
    graphs.clear()
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    n, blocks, k = 16384, 10, 64
    sig, _ = gen_signal(sys_i, 2, 700.0, n * blocks, duration=blocks * 1e-3,
                        secondary_code=sys_i.secondary_code, device=cuda)
    sre, sim = (x.reshape(blocks, n) for x in soa(sig))
    config = dual_config(TrackConfig.for_system(sys_i, n / 1e-3, n, algorithm="pallas_bank_auto",
                                                use_secondary=False))
    states = init_state(np.arange(k) % 32, carrier_doppler=np.linspace(-600, 700, k),
                        ms_elapsed=np.arange(k) * 3, device=cuda)
    codes_i = torch.as_tensor(sys_i.codes, device=cuda)
    codes_q = torch.as_tensor(sys_q.codes, device=cuda)
    corr, kwargs = bank_correlator(config)
    sd = _overlay(None, gpsl5.neuman_hofman(False), cuda)
    sp = _overlay(None, gpsl5.neuman_hofman(True), cuda)
    codes = torch.cat([codes_i, codes_q], 1)

    def joined(st, consts, block):
        prn2 = torch.cat([st.prn, st.prn + codes_i.shape[1]])
        dup = lambda x: torch.cat([x, x])  # noqa: E731
        are, aim = corr(block[0], block[1], codes, prn2,
                        dup(config.intermediate_frequency + st.carrier_doppler),
                        config.sampling_frequency, dup(st.carrier_phase),
                        dup(config.code_frequency + st.code_doppler), dup(st.code_phase),
                        config.sample_shifts, config.code_length, **kwargs,
                        code_tiles=epl_kernels.prepare_bank_code_tiles_rows(codes, prn2))
        return dual_update(config, st, are, aim, sd, sp)

    with graphs.eager():
        want = graphs.loop(joined, states, (sre, sim))
        eager = track_bank_dual(config, codes_i, codes_q, states, sre, sim)
    got = track_bank_dual(config, codes_i, codes_q, states, sre, sim)
    torch.cuda.synchronize()
    _assert_bitwise(eager, want)
    _assert_bitwise(got, want)
    graphs.clear()


# family -> its code table or tables (the GPS L5 dual bank's data and pilot)
PACK_FAMILIES = {
    "gpsl1": lambda: (GPSL1(),), "gpsl5": lambda: (GPSL5(),),
    "gpsl5_dual": lambda: (GPSL5(), GPSL5(quadrature=True)),
    "galileo_e1": lambda: (GalileoE1(),), "beidou_b1i": lambda: (BeiDouB1I(),),
    "glonass_l1of": lambda: (GLONASSL1(),),
}


@pytest.mark.parametrize("into", [False, True])
@pytest.mark.parametrize("prn_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("family", sorted(PACK_FAMILIES))
def test_pack_code_tiles_kernel_equals_the_plain_words(cuda, family, prn_dtype, into):
    # K = 1, 5, one below the table's P and 1024, PRNs with repeats; with
    # `into`, the words go into a given buffer and the index reads 0 after.
    rng = np.random.default_rng(4)
    tables = [torch.as_tensor(system.codes, device=cuda) for system in PACK_FAMILIES[family]()]
    num_prns, words = tables[0].shape[1], -(-tables[0].shape[0] // 32)
    for k in (1, 5, num_prns - 1, 1024):
        prn = torch.as_tensor(rng.integers(0, num_prns, k), dtype=prn_dtype, device=cuda)
        kwargs = {}
        if into:
            kwargs = dict(out=torch.full((k * len(tables), words), -1, dtype=torch.int32,
                                         device=cuda),
                          index=torch.tensor(9, dtype=torch.int64, device=cuda))
        before = epl_kernels.pack_code_tiles.launches
        got = epl_kernels.pack_code_tiles(tables[0], prn, *tables[1:], **kwargs)
        torch.cuda.synchronize()
        assert epl_kernels.pack_code_tiles.launches == before + 1
        assert got.dtype == torch.int32 and got.shape == (k * len(tables), words)
        assert torch.equal(got, epl_kernels.pack_code_tiles_plain(tables[0], prn, *tables[1:]))
        joined = torch.cat([prn.long() + sum(t.shape[1] for t in tables[:i])
                            for i in range(len(tables))])
        assert torch.equal(got, epl_kernels.prepare_bank_code_tiles_rows(torch.cat(tables, 1),
                                                                         joined))
        if into:
            assert got is kwargs["out"] and int(kwargs["index"]) == 0


def _replay_op_names(run, replays=3):
    """One call of ``run`` (capturing its entry), then the device ops, by
    name and count, of the entry's prologue replayed ``replays`` times and
    of as many blocks replayed after it (torch.profiler, one session each,
    after spin kernels that are left out: the first events of a session
    sometimes go missing)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    graphs.clear()
    run()
    torch.cuda.synchronize()
    (entry,) = next(iter(graphs._ENTRIES.values())).values()
    names = []
    for part in (entry.prologue, entry.replay):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(100_000)
            for _ in range(replays):
                part()
            torch.cuda.synchronize()
        names.append(collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name))
    graphs.clear()
    return names


@pytest.mark.parametrize("path", ["rows_k1024", "comp_a4_l7_k1024", "dual_k64"])
def test_a_replayed_block_is_its_kernels_alone(cuda, path):
    # The bank kernel (and its finish), the loop kernel and the index's add:
    # no parameter op, no block select, no join. The prologue: the code
    # tiles packed into the entry by one kernel, which zeroes the index.
    if path == "dual_k64":
        sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
        sig, fs = gen_signal(sys_i, 2, 700.0, 16384 * 2, duration=2e-3, device=cuda)
        sre, sim = (x.reshape(2, 16384) for x in soa(sig))
        config = dual_config(TrackConfig.for_system(sys_i, fs, 16384,
                                                    algorithm="pallas_bank_auto",
                                                    use_secondary=False))
        states = init_state(np.arange(64) % 32, device=cuda)
        codes_i = torch.as_tensor(sys_i.codes, device=cuda)
        codes_q = torch.as_tensor(sys_q.codes, device=cuda)
        run = lambda: track_bank_dual(config, codes_i, codes_q, states, sre, sim)  # noqa: E731
        kernels = ("bank_rows_kernel", "bank_rows_finish", "loop_update")
    else:
        num_ants = 4 if path.startswith("comp") else None
        fs, codes, states, sre, sim = _sharded_case(cuda, n=32768, blocks=2, k=1024,
                                                    num_ants=num_ants)
        extra = {"num_correlators": 7} if num_ants else {}
        config = TrackConfig.for_system(SYSTEM, fs, 32768, algorithm="pallas_bank_auto", **extra)
        states = init_state(states.prn.cpu().numpy(), num_taps=len(config.sample_shifts),
                            device=cuda)
        run = lambda: track_bank(config, codes, states, sre, sim)  # noqa: E731
        kernels = (("bank_comp_kernel", "bank_comp_finish") if num_ants
                   else ("bank_rows_kernel", "bank_rows_finish")) + ("loop_update",)
    replays = 3
    prologue, block = _replay_op_names(run, replays)
    assert sum(block.values()) <= 4 * replays, block
    for kernel in kernels:
        assert 1 <= sum(n for name, n in block.items() if kernel in name) <= replays, \
            (kernel, block)
    glue = ("indexselect", "index_select", "catarray", "div", "mul", "stack", "copy")
    assert not any(op in name.lower() for name in block for op in glue), block
    assert 1 <= sum(prologue.values()) <= replays, prologue
    assert all("code_tiles_kernel" in name for name in prologue), prologue


# path -> (algorithm, A, taps, kernels of a replayed block), K=1024 GPS L1
# at N=32768 on a one-card 2 x 2 mesh
SHARDED_BLOCK_PATHS = {
    "rows_2x2": ("pallas_bank_auto", None, 3, ("bank_rows_kernel", "bank_rows_finish")),
    "comp_a4_l7_2x2": ("pallas_bank_auto", 4, 7, ("bank_comp_kernel", "bank_comp_finish")),
    "onehot_2x2": ("pallas_bank_onehot", None, 3, ("bank_rows_kernel", "bank_rows_finish")),
}


@pytest.mark.parametrize("path", sorted(SHARDED_BLOCK_PATHS))
def test_a_replayed_sharded_block_is_its_kernels_alone(cuda, path):
    # The JAX shard_map body's counterpart: per (chan, time) shard one bank
    # launch, per channel shard one finish and one loop kernel (writing
    # through the sink), and the index's add: chan (T + 2) + 1 device ops, no
    # index_copy_, parameter op, piece copy or add of partials.
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded

    algorithm, num_ants, taps, kernels = SHARDED_BLOCK_PATHS[path]
    fs, codes, states, sre, sim = _sharded_case(cuda, n=32768, blocks=2, k=1024,
                                                num_ants=num_ants)
    config = TrackConfig.for_system(SYSTEM, fs, 32768, algorithm=algorithm,
                                    num_correlators=taps)
    states = init_state(states.prn.cpu().numpy(), num_taps=taps, device=cuda)
    mesh = channel_time_mesh(2, 2, devices=[cuda] * 4)
    replays = 3
    _, block = _replay_op_names(
        lambda: track_bank_sharded(config, codes, states, sre, sim, mesh=mesh), replays)
    assert sum(block.values()) <= (2 * (2 + 2) + 1) * replays, block
    bank, finish = kernels
    # (torch.profiler may drop a session's first events: at most, and some.)
    for kernel, per_block in ((bank, 4), (finish, 2), ("loop_update", 2)):
        assert 1 <= sum(n for name, n in block.items() if kernel in name) <= per_block * replays, \
            (kernel, block)
    glue = ("indexselect", "index_select", "index_copy", "catarray", "div", "mul", "stack",
            "copy", "remainder", "floor", "sub")
    assert not any(op in name.lower() for name in block for op in glue), block
    assert sum(n for name, n in block.items() if "add" in name.lower()) <= replays, block


@pytest.mark.parametrize("route", ["transition", "onehot", "comp_f32", "comp_bf16"])
def test_sharded_bank_routes_graph_equal_eager_with_chan_x_time_launches(cuda, route):
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded

    algorithm, k, num_ants, extra, _ = GRAPH_CASES[route]
    blocks = 4
    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=blocks, k=k, num_ants=num_ants)
    if route == "transition":
        fs, codes, states, sre, sim = _sharded_case(cuda, n=4096, blocks=blocks, k=k)
    config = TrackConfig.for_system(SYSTEM, fs, sre.shape[-1], algorithm=algorithm, **extra)
    states = init_state(states.prn.cpu().numpy(), num_taps=len(config.sample_shifts),
                        device=cuda)
    fn = {"transition": epl_kernels.correlate_pallas_bank,
          "onehot": epl_kernels.correlate_pallas_bank_onehot}.get(
        route, bank_comp.correlate_pallas_bank_comp)
    for chan, time_ in ((2, 2), (1, 2), (2, 1)):
        mesh = channel_time_mesh(chan, time_, devices=_mesh_devices(cuda)[:chan * time_])
        before = fn.launches
        _graph_against_eager(lambda: track_bank_sharded(config, codes, states, sre, sim,
                                                        mesh=mesh))
        assert fn.launches - before == 3 * chan * time_ * blocks


# route -> (wrapper, plain version's route, N, fs, A, taps, extra keyword arguments)
SHARD_ROUTES = {
    "rows": ("correlate_pallas_bank_rows", "pallas_bank_rows", 32768, 32.768e6, 1, 3, {}),
    "transition": ("correlate_pallas_bank", "pallas_bank", 8192, 4.096e6, 1, 3, {}),
    "onehot": ("correlate_pallas_bank_onehot", "pallas_bank_onehot", 8192, 8.192e6, 2, 3, {}),
    "comp_f32": ("comp", None, 16384, 16.384e6, 4, 7, {}),
    "comp_bf16": ("comp", None, 16384, 16.384e6, 2, 5, {"z_dtype": torch.bfloat16}),
}


@pytest.mark.parametrize("route", sorted(SHARD_ROUTES))
def test_shard_form_kernels_match_their_plain_versions(cuda, route):
    # Each time shard of 4 reads its piece of a [chunk, A, N] buffer's row at
    # the device index (the last piece ends the row: the halo case) and
    # advances the state's phases to it: the parameters bit for bit against
    # the torch expressions on the card, each shard's accumulators and the
    # shards' in-order sum (one joint finish) against the plain version.
    from gpuacceleratedtracking_tpu_torch.parallel import nominal_advance_tables, time_shard
    from gpuacceleratedtracking_tpu_torch.parallel.correlate import sum_in_order

    name, plain_route, n, fs, num_ants, taps, extra = SHARD_ROUTES[route]
    rng = np.random.default_rng(11)
    chunk, k, num_time = 3, 70, 4
    shape = (chunk, num_ants, n)
    sre, sim = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda)
                for _ in range(2))
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    prn = torch.as_tensor(np.arange(k) % 32, device=cuda)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)  # noqa: E731
    phi_car = rng.uniform(0, 2 * np.pi, k)
    phi_car[:3] = [0.0, 1e-7, np.nextafter(np.float32(2 * np.pi), 0)]
    phi_code = rng.uniform(0, 1023, k)
    phi_code[3:6] = [0.0, 1e-6, np.nextafter(np.float32(1023), 0)]
    channels = dict(intermediate_frequency=0.0,
                    carrier_doppler=t(rng.uniform(-4000, 4000, k)), carrier_phase=t(phi_car),
                    code_frequency=SYSTEM.code_frequency,
                    code_doppler=t(rng.uniform(-3, 3, k)), code_phase=t(phi_code))
    shifts = tuple(int(s) for s in correlator_sample_shifts(SYSTEM, EPLCorrelator(taps), fs))
    tables = nominal_advance_tables(0.0, SYSTEM.code_frequency, fs, n // num_time, num_time,
                                    1023)
    tiles = epl_kernels.pack_code_tiles(codes, prn)
    index = torch.tensor(1, dtype=torch.int64, device=cuda)
    args = (codes, prn, None, fs, None, None, None, shifts, 1023)
    kw = dict(nominal_code_frequency=SYSTEM.code_frequency, code_tiles=tiles, **extra)
    if name == "comp":
        fn, plain = bank_comp.correlate_pallas_bank_comp, bank_comp.correlate_bank_comp_reference
        call = bank_comp.BankCompCall
    else:
        fn = getattr(epl_kernels, name)
        plain = lambda *a, **w: epl_kernels.correlate_bank_rows_reference(  # noqa: E731
            *a, **w, route=plain_route)
        call = lambda *a, **w: epl_kernels.BankRowsCall(*a, **w, route=plain_route)  # noqa: E731
        if route == "onehot":
            del kw["nominal_code_frequency"]
    total = epl_kernels.ShardSum(num_time, cuda)
    got, want = [], []
    for i in range(num_time):
        ch = epl_kernels.BankChannels(**channels, shard=time_shard(i, tables, fs, n // num_time,
                                                                   1023))
        bank = call(sre, sim, *args, **kw, channels=ch, block_index=index)
        assert torch.equal(epl_kernels.launch_channel_params(bank), bank.params), i
        got.append(fn(sre, sim, *args, **kw, channels=ch, block_index=index))
        want.append(plain(sre, sim, *args, **kw, channels=ch, block_index=index))
        assert fn(sre, sim, *args, **kw, channels=ch, block_index=index, shard_sum=total) is None
    summed = total.finish()
    torch.cuda.synchronize()
    ref = [sum_in_order([w[j] for w in want], cuda) for j in range(2)]
    scale = float(max(w[0].abs().max() for w in want))
    # test_comp_kernel_matches_plain_version's and J0's rows tolerances.
    atol, rtol = (3e-5 * scale + 1e-3, 0.0) if name == "comp" else (4.5, 2e-3)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            torch.testing.assert_close(x, y, atol=atol, rtol=rtol)
    for x, y, z in zip(summed, ref, (sum_in_order([g[j] for g in got], cuda) for j in range(2))):
        torch.testing.assert_close(x, y, atol=2 * atol, rtol=rtol)
        assert torch.equal(x, z)         # the joint finish is the in-order sum, bit for bit


# path -> (algorithm, K, A, TrackConfig extras), on 8192-sample GPS L1 blocks
# but "dual" (GPS L5 data and pilot)
PROLOGUE_PATHS = {
    "rows": ("pallas_bank_auto", 64, None, {}),
    "comp": ("pallas_bank_auto", 64, 4, {"num_correlators": 7}),
    "transition": ("pallas_bank", 64, None, {}),
    "onehot": ("pallas_bank_onehot", 64, None, {}),
    "dual": ("pallas_bank_auto", 16, None, {}),
    "fused": ("pallas_fused", 4, None, {}),
}


@pytest.mark.parametrize("path", sorted(PROLOGUE_PATHS))
def test_a_bank_prologue_is_one_launch_of_the_packing_kernel(cuda, path):
    # Three prologues replayed after spin kernels: one device op each, the
    # packing kernel, on every bank path; a path without a prepare
    # (`pallas_fused`) keeps its one op, the index's fill.
    algorithm, k, num_ants, extra = PROLOGUE_PATHS[path]
    if path == "dual":
        sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
        sig, fs = gen_signal(sys_i, 2, 700.0, 16384 * 2, duration=2e-3, device=cuda)
        sre, sim = (x.reshape(2, 16384) for x in soa(sig))
        config = dual_config(TrackConfig.for_system(sys_i, fs, 16384, algorithm=algorithm,
                                                    use_secondary=False))
        states = init_state(np.arange(k) % 32, device=cuda)
        codes_i = torch.as_tensor(sys_i.codes, device=cuda)
        codes_q = torch.as_tensor(sys_q.codes, device=cuda)
        run = lambda: track_bank_dual(config, codes_i, codes_q, states, sre, sim)  # noqa: E731
    else:
        fs, codes, states, sre, sim = _sharded_case(cuda, blocks=2, k=k, num_ants=num_ants)
        config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm=algorithm, **extra)
        states = init_state(states.prn.cpu().numpy(), num_taps=len(config.sample_shifts),
                            device=cuda)
        run = lambda: track_bank(config, codes, states, sre, sim)  # noqa: E731
    replays = 3
    prologue, _ = _replay_op_names(run, replays)
    assert 1 <= sum(prologue.values()) <= replays, prologue
    ops = ("fill", "memset") if path == "fused" else ("code_tiles_kernel",)
    assert all(any(op in name.lower() for op in ops) for name in prologue), prologue


# fault -> (the edit before the third call, whether that call fails)
CHIP_FAULTS = {
    "bad_chip_in_a_tracked_column": ("codes[5, 3] = 0.5", True),
    "prn_outside_the_table": ("states = states._replace(prn=states.prn.clone()); "
                              "states.prn[3] = 40", True),
    "bad_chip_in_an_untracked_column": ("codes[5, 20] = 0.5", False),
}


@pytest.mark.parametrize("fault", sorted(CHIP_FAULTS))
def test_a_captured_call_checks_the_chips_of_its_table(cuda, fault):
    # The code tiles are packed inside the captured prologue, whose checks
    # are device-side asserts: a call after an in-place edit of a tracked
    # PRN's chips, or with a PRN outside the table, traps (in a process of
    # its own, as the trap ends the CUDA context), where the call before it
    # ran; a bad chip in a column no channel tracks is not checked. Last in
    # the file: on the H100 the first torch.profiler trace taken after this
    # trap, in the test process, held no device event.
    edit, fails = CHIP_FAULTS[fault]
    code = textwrap.dedent("""
        import numpy as np
        import torch
        from gpuacceleratedtracking_tpu_torch.models import GPSL1, gen_signal, soa
        from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, init_state, track_bank
        system = GPSL1()
        sig, fs = gen_signal(system, 0, 700.0, 8192 * 2, duration=2e-3, device="cuda")
        sre, sim = (x.reshape(2, 8192) for x in soa(sig))
        codes = torch.as_tensor(system.codes, device="cuda")
        config = TrackConfig.for_system(system, fs, 8192, algorithm="pallas_bank_auto")
        states = init_state(np.arange(8), device="cuda")
        track_bank(config, codes, states, sre, sim)
        track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        print("steady call ran", flush=True)
        EDIT
        track_bank(config, codes, states, sre, sim)
        torch.cuda.synchronize()
        print("third call ran", flush=True)
    """).replace("EDIT", edit)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=pathlib.Path(__file__).resolve().parents[1])
    assert "steady call ran" in proc.stdout, proc.stderr[-2000:]
    if fails:
        assert proc.returncode != 0 and "Error" in proc.stderr, proc.stderr[-2000:]
        assert "third call ran" not in proc.stdout
    else:
        assert proc.returncode == 0 and "third call ran" in proc.stdout, proc.stderr[-2000:]


@pytest.mark.parametrize("num_ants", [1, 4])
def test_block_graph_nodes_are_a_replayed_blocks_device_ops(cuda, num_ants):
    # `graphs.scan` reads its body graph's node count once, at capture, and
    # counts one replay a block; torch.profiler finds as many device ops in
    # each replayed block (after spin kernels: it may drop a session's first
    # events). The benchmark's `block_graph_nodes` reads the counters' ratio.
    from torch.profiler import ProfilerActivity, profile

    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    n, blocks, k = 32768, 5, 1024
    sig, fs = gen_signal(SYSTEM, 0, 1500.0, n * blocks, duration=blocks * 1e-3,
                         num_ants=None if num_ants == 1 else num_ants, device=cuda)
    sre, sim = soa(sig)
    if num_ants > 1:
        sre, sim = (x.reshape(num_ants, blocks, n).transpose(0, 1).contiguous()
                    for x in (sre, sim))
    else:
        sre, sim = sre.reshape(blocks, n), sim.reshape(blocks, n)
    codes = torch.as_tensor(SYSTEM.codes, device=cuda)
    taps = 3 if num_ants == 1 else 7
    config = TrackConfig.for_system(SYSTEM, fs, n, num_correlators=taps,
                                    algorithm="pallas_bank_auto")
    states = init_state(np.arange(k) % 32, device=cuda, num_taps=taps)
    weights = None if num_ants == 1 else (torch.ones(num_ants), torch.zeros(num_ants))
    graphs.clear()
    captures = graphs.scan.captures
    state, _ = track_bank(config, codes, states, sre, sim, ant_weights=weights)
    (entry,) = graphs._ENTRIES[torch.device("cuda", torch.cuda.current_device())].values()
    replays, nodes = graphs.scan.replays, graphs.scan.replayed_nodes
    track_bank(config, codes, state, sre, sim, ant_weights=weights)
    torch.cuda.synchronize()
    assert graphs.scan.captures == captures + 1
    assert graphs.scan.replays - replays == blocks
    assert graphs.scan.replayed_nodes - nodes == blocks * entry.nodes
    assert 3 <= entry.nodes <= 8, entry.nodes
    counted = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _spin_first()
            for _ in range(blocks):
                entry.replay()
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        counted.append(len(_counted_ops(prof)))
        if counted[-1] == blocks * entry.nodes:
            break
    graphs.clear()
    assert counted[-1] == blocks * entry.nodes, (counted, entry.nodes)
