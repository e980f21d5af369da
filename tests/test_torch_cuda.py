"""The CUDA bank kernel on the card, against its plain PyTorch version.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu_torch.models import (
    GPSL1, EPLCorrelator, correlator_sample_shifts, gen_signal, gen_signal_mixed, soa)
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, init_state, track_bank

pytestmark = pytest.mark.cuda

SYSTEM = GPSL1()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(device, n, k, num_ants=1, taps=3, shifts=None, seed=0):
    rng = np.random.default_rng(seed)
    fs = n / 1e-3
    signal, _ = gen_signal(SYSTEM, 0, 1500.0, n,
                           num_ants=None if num_ants == 1 else num_ants, device=device)
    sre, sim = soa(signal)
    if shifts is None:
        shifts = correlator_sample_shifts(SYSTEM, EPLCorrelator(taps), fs)
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    return dict(
        signal_re=sre, signal_im=sim, codes=t(SYSTEM.codes),
        prn=t(np.arange(k) % 32, torch.int32),
        carrier_frequency=t(1500.0 + rng.uniform(-4000.0, 4000.0, k)),
        sampling_frequency=fs,
        carrier_phase=t(rng.uniform(0, 2 * np.pi, k)),
        code_frequency=t(SYSTEM.code_frequency + rng.uniform(-3, 3, k)),
        code_phase=t(rng.uniform(0, SYSTEM.code_length, k)),
        sample_shifts=tuple(int(s) for s in shifts),
        code_length=SYSTEM.code_length,
        nominal_code_frequency=SYSTEM.code_frequency,
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
