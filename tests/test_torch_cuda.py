"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

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
    bank_comp, channel_kernels, epl_kernels, registry, replica_kernel)
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


def test_pallas_fused_call_is_one_device_op(cuda):
    # The kernel derives its parameters and reads the PRN's column itself:
    # a wrapper call issues the kernel and nothing else on the card.
    from torch.profiler import ProfilerActivity, profile

    args = _channel_args(cuda, "n32768_l3")
    channel_kernels.correlate_pallas_fused(*args)
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            channel_kernels.correlate_pallas_fused(*args)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
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


def test_sharded_block_loop_does_not_wait_on_the_card(cuda):
    from gpuacceleratedtracking_tpu_torch.parallel import channel_time_mesh, track_bank_sharded

    fs, codes, states, sre, sim = _sharded_case(cuda, blocks=3)
    config = TrackConfig.for_system(SYSTEM, fs, 8192, algorithm="pallas_bank_auto")
    mesh = channel_time_mesh(2, 2, devices=_mesh_devices(cuda))
    track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)   # builds the caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


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
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    return [fn.launches for fn in graphs._counters()]


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

    c0 = _launch_counts()
    with graphs.eager():
        want = run()
    torch.cuda.synchronize()
    c1 = _launch_counts()
    got = run()
    torch.cuda.synchronize()
    c2 = _launch_counts()
    again = run()
    torch.cuda.synchronize()
    c3 = _launch_counts()
    eager = [b - a for a, b in zip(c0, c1)]
    assert [b - a for a, b in zip(c1, c2)] == eager
    assert [b - a for a, b in zip(c2, c3)] == eager
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
    # `graphs._counters()`: the six correlators, the replica, the dual loop, the loop.
    *correlators, replicas, duals, loops = launched
    assert sum(correlators) == (0 if algorithm.endswith("_xla") or algorithm == "xla_bank"
                                else per_block * 5)
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
    # `graphs._counters()`: the five correlators, fused, the replica, the
    # dual loop, the loop.
    assert _graph_against_eager(lambda: track(config, codes, state, sre, sim)) == \
        [0, 0, 0, 0, 0, blocks, 0, 0, blocks]


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
        step, consts = dual_parts(config, torch.as_tensor(sys_i.codes, device=cuda),
                                  torch.as_tensor(sys_q.codes, device=cuda), carry.prn, cuda)
    sunk = graphs.writes_outputs(step)
    plain = lambda st, c, block: step(st, c, block)          # the same body, no sink
    calls = []
    index_copy = torch.Tensor.index_copy_

    def counted(self, *args, **kwargs):
        calls.append(self.shape)
        return index_copy(self, *args, **kwargs)

    graphs.clear()
    monkeypatch.setattr(torch.Tensor, "index_copy_", counted)
    want = graphs.scan(plain, carry, (sre, sim), consts, key=(path, "plain"))
    leaves = len(calls)
    got = graphs.scan(sunk, carry, (sre, sim), consts, key=(path, "sink"))
    assert leaves in (11, 13) and len(calls) == leaves
    monkeypatch.undo()
    _assert_bitwise(got, want)
    sink_ops = _device_op_names(lambda: graphs.scan(sunk, carry, (sre, sim), consts,
                                                    key=(path, "sink")))
    plain_ops = _device_op_names(lambda: graphs.scan(plain, carry, (sre, sim), consts,
                                                     key=(path, "plain")))
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


# The replica kernel (csrc/replica.cu): the taps wrapper's tap matrix and the
# replica benchmark's row, bit for bit against the plain replica ops.
REPLICA_CASES = {
    "l1_n2048_l3": (SYSTEM, 2048, 3, 0, 0.0),
    "l1_n32768_l7": (SYSTEM, 32768, 7, 5, 517.3),
    "l1_n262144_l7": (SYSTEM, 262144, 7, 31, 1022.9),
    "l5_n32768_l3": (GPSL5(), 32768, 3, 3, 10229.25),
    "l5_n262144_l7": (GPSL5(), 262144, 7, 17, 4711.5),
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
        torch.cuda.synchronize()
        assert replica_kernel.code_replica.launches == before + 2
        want_row = replica_kernel.replica_plain(codes, *args[:1], args[1], fs, args[2], n,
                                                min(shifts), max(shifts), system.code_length,
                                                mode)
        want_taps = replica_kernel.tap_matrix_plain(codes, args[0], args[1], fs, args[2], n,
                                                    shifts, system.code_length, mode)
        assert torch.equal(row, want_row) and torch.equal(taps_m, want_taps)


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            channel_kernels.correlate_pallas_taps(*args)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("replica_kernel" in name for name in device_ops) == calls
    assert sum("taps_kernel" in name for name in device_ops) == calls
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
