"""PyTorch port, models: code tables, tap geometry and signal synthesis vs JAX."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu_torch import models as tmodels

torch.set_num_threads(1)


def test_gpsl1_code_table_bit_equal():
    want = jmodels.GPSL1().codes
    got = tmodels.GPSL1().codes
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_registry_and_constants():
    for name in ("GPSL1", "GPSL5"):
        j, t = jmodels.get_system(name), tmodels.get_system(name)
        assert (t.code_frequency, t.center_frequency, t.code_length) == (
            j.code_frequency, j.center_frequency, j.code_length)
    # Families the port has not registered yet.
    with pytest.raises(KeyError, match="Unknown GNSS system"):
        tmodels.get_system("GLONASSL1")


@pytest.mark.parametrize("quadrature", [False, True])
def test_gpsl5_code_tables_and_overlays_bit_equal(quadrature):
    j = jmodels.GPSL5(quadrature=quadrature)
    t = tmodels.GPSL5(quadrature=quadrature)
    assert t.codes.dtype == j.codes.dtype == np.float32
    assert t.codes.shape == j.codes.shape == (10230, 37)
    np.testing.assert_array_equal(t.codes, j.codes)
    np.testing.assert_array_equal(t.secondary_code, j.secondary_code)
    np.testing.assert_array_equal(
        tmodels.gpsl5.neuman_hofman(quadrature),
        jmodels.gpsl5.neuman_hofman(quadrature))
    assert tmodels.GPSL5(quadrature, with_secondary=False).secondary_code is None


@pytest.mark.parametrize("fs", [2.5e6, 32.768e6, 262.144e6])
@pytest.mark.parametrize("num_correlators", [3, 7])
def test_correlator_sample_shifts_equal(fs, num_correlators):
    want = jmodels.correlator_sample_shifts(
        jmodels.GPSL1(), jmodels.EPLCorrelator(num_correlators), fs)
    got = tmodels.correlator_sample_shifts(
        tmodels.GPSL1(), tmodels.EPLCorrelator(num_correlators), fs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,phi_code,phi_car,fcar", [
    (2500, 0.0, 0.0, 1500.0),
    (4096, 123.4, 0.7, -3000.0),
])
def test_gen_signal_matches_jax(N, phi_code, phi_car, fcar):
    # The tolerance of tests/test_signal.py's float64 check.
    want, fs_j = jmodels.gen_signal(
        jmodels.GPSL1(), 0, fcar, N,
        start_code_phase=phi_code, start_carrier_phase=phi_car)
    got, fs_t = tmodels.gen_signal(
        tmodels.GPSL1(), 0, fcar, N,
        start_code_phase=phi_code, start_carrier_phase=phi_car, device="cpu")
    assert fs_t == fs_j
    assert got.dtype == torch.complex64 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_gen_signal_bank_and_antennas_match_jax():
    want, _ = jmodels.gen_signal(jmodels.GPSL1(), np.arange(4), 700.0, 2048,
                                 num_ants=2)
    got, _ = tmodels.gen_signal(tmodels.GPSL1(), np.arange(4), 700.0, 2048,
                                num_ants=2, device="cpu")
    assert got.shape == (4, 2, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_gen_signal_mixed_matches_jax():
    prns, dops, phases = [0, 3, 9], [-900.0, 100.0, 1500.0], [0.0, 12.5, 700.0]
    want, fs_j = jmodels.gen_signal_mixed(
        jmodels.GPSL1(), prns, dops, 8192, start_code_phases=phases)
    got, fs_t = tmodels.gen_signal_mixed(
        tmodels.GPSL1(), prns, dops, 8192, start_code_phases=phases, device="cpu")
    assert fs_t == fs_j
    # Three summed unit signals: a chip flip at a floor boundary is +/-2.
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.mean(diff > 1e-3) < 1e-3
    np.testing.assert_allclose(diff, 0.0, atol=2.0 + 1e-3)


def test_gen_signal_secondary_overlay_matches_jax():
    overlay = np.array([1, 1, -1, 1, -1], np.float32)
    kw = dict(start_code_phase=700.0, secondary_code=overlay, secondary_phase=2)
    want, _ = jmodels.gen_signal(jmodels.GPSL1(), 3, 250.0, 4 * 4096,
                                 duration=4e-3, **kw)
    got, _ = tmodels.gen_signal(tmodels.GPSL1(), 3, 250.0, 4 * 4096,
                                duration=4e-3, **kw, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_gen_signal_noise_uses_generator():
    sys_t = tmodels.GPSL1()
    a, _ = tmodels.gen_signal(sys_t, 0, 1500.0, 2500, noise_std=0.5,
                              generator=torch.Generator().manual_seed(3), device="cpu")
    b, _ = tmodels.gen_signal(sys_t, 0, 1500.0, 2500, noise_std=0.5,
                              generator=torch.Generator().manual_seed(3), device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    power = float((a.abs() ** 2).mean())
    assert power == pytest.approx(1.0 + 2 * 0.25, rel=0.1)
    with pytest.raises(ValueError, match="Generator"):
        tmodels.gen_signal(sys_t, 0, 1500.0, 2500, noise_std=0.5, device="cpu")


def test_soa_planes():
    sig, _ = tmodels.gen_signal(tmodels.GPSL1(), 0, 1500.0, 2048, num_ants=2, device="cpu")
    re, im = tmodels.soa(sig)
    assert re.dtype == im.dtype == torch.float32
    assert re.is_contiguous() and im.is_contiguous()
    torch.testing.assert_close(torch.complex(re, im), sig, rtol=0, atol=0)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import gpuacceleratedtracking_tpu_torch\n"
        "import gpuacceleratedtracking_tpu_torch.ops.epl_kernels\n"
        "import gpuacceleratedtracking_tpu_torch.ops._build\n"
        "import gpuacceleratedtracking_tpu_torch.ops.bank_comp\n"
        "import gpuacceleratedtracking_tpu_torch.tracking.track\n"
        "import gpuacceleratedtracking_tpu_torch.tracking.dual\n"
        "import gpuacceleratedtracking_tpu_torch.tracking.secondary\n"
        "import gpuacceleratedtracking_tpu_torch.tracking.lock\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('gpuacceleratedtracking_tpu.')"
        " or m == 'gpuacceleratedtracking_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
