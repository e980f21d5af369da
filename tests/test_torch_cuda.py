"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu_torch.models import (
    GPSL1, GPSL5, EPLCorrelator, correlator_sample_shifts, gen_signal, gen_signal_mixed,
    soa)
from gpuacceleratedtracking_tpu_torch.ops import bank_comp, channel_kernels, epl_kernels, registry
from gpuacceleratedtracking_tpu_torch.tracking import (
    TrackConfig, dual_config, init_state, track, track_bank, track_bank_dual)

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
    case = _case(cuda, 8192, 2, num_ants=5)
    before = epl_kernels.correlate_pallas_bank_rows.launches
    with pytest.raises(ValueError, match="A in"):
        epl_kernels.correlate_pallas_bank_rows(**case)
    case = _case(cuda, 8192, 2)
    case["signal_re"] = case["signal_re"].double()
    with pytest.raises(TypeError, match="float32"):
        epl_kernels.correlate_pallas_bank_rows(**case)
    assert epl_kernels.correlate_pallas_bank_rows.launches == before


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
}


@pytest.mark.parametrize("z_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(COMP_CASES))
def test_comp_kernel_matches_plain_version(cuda, name, z_dtype):
    # Same Z phase arithmetic as the plain version; the sums differ in order
    # only (4 real products per sample, reduced per warp, then per tile).
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
}


def _channel_args(device, name):
    system, n, a, taps, prn, fcar, phicar, phicode = CHANNEL_CASES[name]
    signal, fs = gen_signal(system, prn, fcar, n, num_ants=None if a == 1 else a,
                            start_code_phase=phicode, start_carrier_phase=phicar,
                            device=device)
    if isinstance(taps, int):
        taps = correlator_sample_shifts(system, EPLCorrelator(taps), fs)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=device)  # noqa: E731
    return (*soa(signal), torch.as_tensor(system.codes, device=device),
            t(prn, torch.int32), t(fcar), fs, t(phicar), t(system.code_frequency),
            t(phicode), tuple(int(s) for s in taps), system.code_length)


@pytest.mark.parametrize("kernel", ["taps", "fused"])
@pytest.mark.parametrize("name", sorted(CHANNEL_CASES))
def test_channel_kernel_matches_plain_version(cuda, name, kernel):
    # Same phase and chip arithmetic as the plain version: the sums differ
    # in order only (relative 1e-6 of the block length).
    fn = getattr(channel_kernels, f"correlate_pallas_{kernel}")
    plain = getattr(channel_kernels, f"correlate_{kernel}_reference")
    args = _channel_args(cuda, name)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    n = args[0].shape[-1]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * n + 1e-3)
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


ONEHOT_CASES = {
    "wide_span_k2": dict(n=4096, k=2, shifts=(-160, 0, 170)),
    "k1024": dict(n=32768, k=1024, seed=7),
    "low_rate_k5": dict(n=2500, k=5, seed=8),
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
