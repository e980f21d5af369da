"""PyTorch port, the slice end to end: closed-loop `track_bank` against the
JAX `track_bank` on the rows kernel, and single-channel convergence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu.ops.pallas_epl import bank_algorithm_for
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

torch.set_num_threads(1)

N, NUM_MS, K = 8192, 20, 3
FS = N / 1e-3
DOPS = np.array([-900.0, 100.0, 1500.0])


@pytest.fixture(scope="module")
def scenario():
    """tests/test_tracking.py's rows-kernel bank scenario, run once in JAX."""
    system = jmodels.GPSL1()
    sigs = []
    for prn, d in enumerate(DOPS):
        scale = 1.0 + d / system.center_frequency
        s, _ = jmodels.gen_signal(system, prn, d, N * NUM_MS,
                                  duration=NUM_MS * 1e-3,
                                  code_frequency=system.code_frequency * scale)
        sigs.append(s)
    mixed = sum(sigs[1:], sigs[0])
    sre = np.array(mixed.real).reshape(NUM_MS, N)
    sim = np.array(mixed.imag).reshape(NUM_MS, N)
    assert bank_algorithm_for(N, FS, system.code_length,
                              system.code_frequency) == "pallas_bank_rows"
    config = jtracking.TrackConfig.for_system(system, FS, N,
                                              algorithm="pallas_bank_rows")
    states = jtracking.init_state(np.arange(K), carrier_doppler=DOPS)
    _, out = jtracking.track_bank(config, jnp.asarray(system.codes), states,
                                  jnp.asarray(sre), jnp.asarray(sim))
    return sre, sim, {f: np.asarray(v) for f, v in out._asdict().items()}


def _port_track_bank(sre, sim, algorithm):
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, FS, N, algorithm=algorithm)
    states = ttracking.init_state(np.arange(K), carrier_doppler=DOPS, device="cpu")
    return ttracking.track_bank(config, torch.as_tensor(system.codes), states,
                                torch.as_tensor(sre), torch.as_tensor(sim))


@pytest.mark.parametrize("algorithm", ["pallas_bank_rows", "pallas_bank_auto"])
def test_track_bank_matches_jax_rows_kernel(scenario, algorithm):
    sre, sim, want = scenario
    final, out = _port_track_bank(sre, sim, algorithm)
    assert out.prompt_re.shape == (NUM_MS, K)
    assert out.accum_re.shape == (NUM_MS, K, 3)
    assert final.ms_elapsed.tolist() == [NUM_MS] * K
    # tests/test_tracking.py:236-242.
    np.testing.assert_allclose(out.prompt_re.numpy(), want["prompt_re"],
                               rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(out.carrier_doppler.numpy(),
                               want["carrier_doppler"], rtol=1e-3, atol=1.0)
    assert epl_kernels.correlate_pallas_bank_rows.launches == 0


@pytest.mark.parametrize("algorithm", ["xla_bank", "fused_xla"])
def test_track_bank_plain_correlators_match_jax_rows_kernel(scenario, algorithm):
    sre, sim, want = scenario
    _, out = _port_track_bank(sre, sim, algorithm)
    np.testing.assert_allclose(out.prompt_re.numpy(), want["prompt_re"],
                               rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(out.carrier_doppler.numpy(),
                               want["carrier_doppler"], rtol=1e-3, atol=1.0)


def test_single_channel_track_converges():
    # tests/test_tracking.py:107-131 on the port.
    system = tmodels.GPSL1()
    true_doppler, num_ms, n = 800.0, 1000, 2500
    fs = n / 1e-3
    code_freq_true = system.code_frequency * (1.0 + true_doppler / system.center_frequency)
    signal, _ = tmodels.gen_signal(system, 0, true_doppler, n * num_ms,
                                   duration=num_ms * 1e-3,
                                   code_frequency=code_freq_true,
                                   start_carrier_phase=0.3, device="cpu")
    sre, sim = (x.reshape(num_ms, n) for x in tmodels.soa(signal))
    config = ttracking.TrackConfig.for_system(system, fs, n, dll_bandwidth=3.0)
    state = ttracking.init_state(0, carrier_doppler=true_doppler + 30.0,
                                 code_phase=(-0.3) % system.code_length, device="cpu")
    _, out = ttracking.track(config, torch.as_tensor(system.codes), state, sre, sim)

    dop = out.carrier_doppler.numpy()
    assert abs(dop[-1] - true_doppler) < 2.0, dop[-50:]
    b = np.arange(num_ms)
    true_phase = (code_freq_true * 1e-3 * (b + 1)) % system.code_length
    half = system.code_length / 2
    err = (out.code_phase.numpy() - true_phase + half) % system.code_length - half
    assert abs(err[-1]) < 0.02, err[-10:]
    assert out.prompt_re.numpy()[-1] > 2300
    assert abs(out.prompt_im.numpy()[-1]) < 150
    assert out.cn0_dbhz.numpy()[-1] > 50
