"""PyTorch port, multi-antenna path: closed-loop `track_bank` through
`pallas_bank_auto`, which resolves antenna arrays and bf16 z-planes to the
composite route, against the JAX `track_bank` on the JAX composite kernel
(Pallas interpret mode); steering, the bf16 mode, and the config's warnings.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu.tracking.track import _bank_kernel_kwargs as j_kwargs
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import bank_comp, epl_kernels
from gpuacceleratedtracking_tpu_torch.tracking.track import _bank_kernel_kwargs as t_kwargs

torch.set_num_threads(1)

N, NUM_MS, K, A = 8192, 10, 3, 2
FS = N / 1e-3
DOPS = np.array([-900.0, 100.0, 1500.0])
THETA = 2 * np.pi / 3          # antenna 1's phase offset


def _array_signal(num_ms=NUM_MS, n=N):
    """Three satellites on a two-antenna array, antenna 1 rotated by THETA:
    ``[B, A, N]`` numpy planes."""
    system = jmodels.GPSL1()
    mixed = 0
    for prn, d in enumerate(DOPS):
        s, _ = jmodels.gen_signal(system, prn, d, n * num_ms, duration=num_ms * 1e-3,
                                  code_frequency=system.code_frequency
                                  * (1.0 + d / system.center_frequency))
        mixed = mixed + np.asarray(s)
    ants = np.stack([mixed, mixed * np.complex64(np.exp(1j * THETA))])    # [A, B*N]
    ants = ants.reshape(A, num_ms, n).swapaxes(0, 1)
    return (np.ascontiguousarray(ants.real, np.float32),
            np.ascontiguousarray(ants.imag, np.float32))


@pytest.fixture(scope="module")
def jax_array_run():
    sre, sim = _array_signal()
    system = jmodels.GPSL1()
    config = jtracking.TrackConfig.for_system(system, FS, N, algorithm="pallas_bank_auto")
    states = jtracking.init_state(np.arange(K), carrier_doppler=DOPS)
    _, out = jtracking.track_bank(config, jnp.asarray(system.codes), states,
                                  jnp.asarray(sre), jnp.asarray(sim))
    return sre, sim, {f: np.asarray(v) for f, v in out._asdict().items()}


def _port_run(sre, sim, ant_weights=None, **config_kw):
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, FS, N, algorithm="pallas_bank_auto",
                                              **config_kw)
    states = ttracking.init_state(np.arange(K), carrier_doppler=DOPS)
    return ttracking.track_bank(config, torch.as_tensor(system.codes), states,
                                torch.as_tensor(sre), torch.as_tensor(sim),
                                ant_weights=ant_weights)


def test_track_bank_array_matches_jax_comp(jax_array_run):
    sre, sim, want = jax_array_run
    assert epl_kernels.bank_algorithm_for(N, FS, 1023, 1.023e6, num_ants=A) == "pallas_bank_comp"
    final, out = _port_run(sre, sim)
    assert out.accum_re.shape == (NUM_MS, K, A, 3)
    assert final.ms_elapsed.tolist() == [NUM_MS] * K
    # tests/test_tracking.py:170-175.
    np.testing.assert_allclose(out.prompt_re.numpy(), want["prompt_re"], rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(out.carrier_doppler.numpy(), want["carrier_doppler"],
                               rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(out.accum_re.numpy(), want["accum_re"], rtol=5e-3, atol=10.0)
    assert bank_comp.correlate_pallas_bank_comp.launches == 0


def test_steered_weights_recover_array_gain():
    # tests/test_tracking.py:377-409 through pallas_bank_auto: a uniform sum of
    # the two antennas loses half the coherent gain (|1 + e^{i 120}| = 1);
    # steering weights conj(w) x recover the full 2x.
    sre, sim = _array_signal(num_ms=4)
    _, uniform = _port_run(sre, sim)
    w = (np.array([1.0, np.cos(THETA)]), np.array([0.0, np.sin(THETA)]))
    _, steered = _port_run(sre, sim, ant_weights=w)
    # Channel 1 (100 Hz): its neighbours' cross-correlation is small.
    assert abs(float(uniform.prompt_re[0, 1])) < 1.2 * N
    assert float(steered.prompt_re[0, 1]) > 1.9 * N
    assert float(steered.prompt_re[-1, 1]) > 1.9 * N


def test_bf16_z_tracks_like_f32():
    # tests/test_tracking.py:282-291's tolerances, bf16 planes against f32.
    sre, sim = _array_signal(num_ms=20)
    _, f32 = _port_run(sre, sim)
    _, bf16 = _port_run(sre, sim, z_dtype="bf16")
    scale = float(f32.prompt_re.abs().max())
    np.testing.assert_allclose(bf16.prompt_re.numpy(), f32.prompt_re.numpy(),
                               atol=5e-3 * scale)
    np.testing.assert_allclose(bf16.carrier_doppler.numpy(), f32.carrier_doppler.numpy(),
                               rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(bf16.code_phase.numpy(), f32.code_phase.numpy(),
                               rtol=1e-4, atol=5e-3)
    assert not torch.equal(bf16.accum_re, f32.accum_re)


@pytest.mark.parametrize("algorithm,warns", [
    ("pallas_bank_rows", True), ("pallas_bank", True), ("xla_bank", True),
    ("pallas_bank_comp", False), ("pallas_bank_auto", False),
])
def test_bank_kernel_kwargs_warnings_match_jax(algorithm, warns):
    # tests/test_tracking.py:293-331: bf16 z must not degrade to f32 silently.
    j_cfg = jtracking.TrackConfig.for_system(jmodels.GPSL1(), 2.5e6, 2500,
                                             algorithm=algorithm, z_dtype="bf16")
    t_cfg = ttracking.TrackConfig.for_system(tmodels.GPSL1(), 2.5e6, 2500,
                                             algorithm=algorithm, z_dtype="bf16")
    with warnings.catch_warnings(record=True) as j_rec:
        warnings.simplefilter("always")
        j_kwargs(j_cfg)
    with warnings.catch_warnings(record=True) as t_rec:
        warnings.simplefilter("always")
        kw = t_kwargs(t_cfg)
    assert [str(w.message) for w in t_rec] == [str(w.message) for w in j_rec]
    assert bool(t_rec) == warns
    if warns:
        assert "ignored by algorithm" in str(t_rec[0].message)
    assert ("z_dtype" in kw) == (not warns and algorithm != "xla_bank")
