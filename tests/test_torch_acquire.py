"""PyTorch port, PCPS acquisition (`acquire`) against the JAX package.

The cases of tests/test_acquire.py (less the two matmul-DFT ones, an engine
the port does not have), tests/test_galileo.py:179 and tests/test_beidou.py:207.
The same seeded inputs go through the JAX `acquire` with ``fft_mode="fft"``
and the port's: both must pick the same Doppler bin and the same sample
index, and ``peak_metric`` and ``power`` agree to rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import acquire as jacquire
from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu_torch import acquire as tacquire
from gpuacceleratedtracking_tpu_torch import bench as tbench
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking

torch.set_num_threads(1)

PRNS = np.array([2, 9, 17])
DOPS = np.array([1250.0, -2400.0, 300.0])
PHASES = np.array([100.25, 511.0, 900.5])


def _scenario(n=4096, key=None, noise_std=0.0):
    """tests/test_acquire.py's three GPS L1 satellites, as numpy planes."""
    sig, fs = jmodels.gen_signal_mixed(jmodels.GPSL1(), PRNS, DOPS, n,
                                       start_code_phases=PHASES, noise_std=noise_std, key=key)
    return np.array(sig.real, np.float32), np.array(sig.imag, np.float32), fs


def _both(gnss, sre, sim, prns, fs, **kw):
    """The JAX result (numpy) and the port's, on the same planes."""
    want = jacquire.acquire(jmodels.get_system(gnss), jnp.asarray(sre), jnp.asarray(sim),
                            prns, fs, fft_mode="fft", **kw)
    got = tacquire.acquire(tmodels.get_system(gnss), torch.from_numpy(sre),
                           torch.from_numpy(sim), prns, fs, **kw)
    return jax.tree.map(np.asarray, want), got


def _assert_same_decisions(got, want, num_samples, fs, code_frequency, max_doppler, step):
    assert isinstance(got, tacquire.AcquisitionResult)
    np.testing.assert_array_equal(got.prn.numpy(), want.prn)
    # Same Doppler bin (the grids differ by at most an f32 ulp of a bin).
    bins = lambda d: np.rint((np.asarray(d, np.float64) + max_doppler) / step)  # noqa: E731
    np.testing.assert_array_equal(bins(got.carrier_doppler.numpy()), bins(want.carrier_doppler))
    np.testing.assert_allclose(got.carrier_doppler.numpy(), want.carrier_doppler, atol=1e-2)
    # Same sample index: the code phase is index * chips per sample.
    idx = lambda cp: np.rint(np.asarray(cp, np.float64) * fs / code_frequency) % num_samples  # noqa: E731
    np.testing.assert_array_equal(idx(got.code_phase.numpy()), idx(want.code_phase))
    np.testing.assert_allclose(got.code_phase.numpy(), want.code_phase, atol=1e-4)
    np.testing.assert_allclose(got.peak_metric.numpy(), want.peak_metric, rtol=1e-3)
    np.testing.assert_allclose(got.power.numpy(), want.power, rtol=1e-3)


def _step(n, fs):
    return 2.0 / (3.0 * (n / fs))


def test_finds_planted_satellites():
    sre, sim, fs = _scenario()
    want, got = _both("GPSL1", sre, sim, PRNS, fs, max_doppler=4000.0)
    _assert_same_decisions(got, want, 4096, fs, 1.023e6, 4000.0, _step(4096, fs))
    assert (np.abs(got.carrier_doppler.numpy() - DOPS) < 400.0).all()
    err = np.abs(got.code_phase.numpy() - PHASES)
    err = np.minimum(err, 1023 - err)
    assert (err < 0.3).all(), got.code_phase
    assert (got.peak_metric.numpy() > 10.0).all()


def test_rejects_absent_prn():
    sre, sim, fs = _scenario()
    want, got = _both("GPSL1", sre, sim, np.array([2, 30]), fs, max_doppler=4000.0)
    metric = got.peak_metric.numpy()
    np.testing.assert_allclose(metric, want.peak_metric, rtol=1e-3)
    assert metric[0] > 10.0
    assert metric[1] < 0.5 * metric[0]


def test_with_noise():
    sre, sim, fs = _scenario(key=jax.random.key(3), noise_std=2.0)
    want, got = _both("GPSL1", sre, sim, PRNS, fs, max_doppler=4000.0)
    _assert_same_decisions(got, want, 4096, fs, 1.023e6, 4000.0, _step(4096, fs))
    assert (np.abs(got.carrier_doppler.numpy() - DOPS) < 400.0).all()
    assert (got.peak_metric.numpy() > 2.5).all()


def test_noncoherent_integration_beats_one_round():
    n, r = 2046, 8
    sig, fs = jmodels.gen_signal_mixed(jmodels.GPSL1(), np.array([5]), np.array([950.0]),
                                       n * r, duration=r * 1e-3,
                                       start_code_phases=np.array([300.0]), noise_std=6.0,
                                       key=jax.random.key(11))
    sre, sim = np.array(sig.real, np.float32), np.array(sig.imag, np.float32)
    want1, one = _both("GPSL1", sre[:n].copy(), sim[:n].copy(), np.array([5]), fs,
                       max_doppler=2000.0)
    wantr, multi = _both("GPSL1", sre.reshape(r, n), sim.reshape(r, n), np.array([5]), fs,
                         max_doppler=2000.0)
    for got, want in ((one, want1), (multi, wantr)):
        _assert_same_decisions(got, want, n, fs, 1.023e6, 2000.0, _step(n, fs))
    assert float(multi.peak_metric[0]) > float(one.peak_metric[0])
    assert abs(float(multi.carrier_doppler[0]) - 950.0) < 400.0


def test_noncoherent_rounds_with_noise():
    # tests/test_acquire.py:64's rounds cell, through the FFT engine only.
    n, r = 2048, 4
    prns = np.array([5, 22])
    sig, fs = jmodels.gen_signal_mixed(jmodels.GPSL1(), prns, np.array([950.0, -1800.0]),
                                       n * r, duration=r * 1e-3,
                                       start_code_phases=np.array([300.0, 77.0]),
                                       noise_std=2.0, key=jax.random.key(11))
    sre = np.array(sig.real, np.float32).reshape(r, n)
    sim = np.array(sig.imag, np.float32).reshape(r, n)
    want, got = _both("GPSL1", sre, sim, prns, fs, max_doppler=2000.0, bin_batch=3)
    _assert_same_decisions(got, want, n, fs, 1.023e6, 2000.0, _step(n, fs))


def test_handoff_to_tracking_converges():
    sre0, sim0, fs = _scenario()
    want, res = _both("GPSL1", sre0, sim0, PRNS, fs, max_doppler=4000.0, doppler_step=250.0)
    _assert_same_decisions(res, want, 4096, fs, 1.023e6, 4000.0, 250.0)
    states = tacquire.to_track_states(res, device="cpu")
    n, b = 4096, 400
    sig, _ = jmodels.gen_signal_mixed(jmodels.GPSL1(), PRNS, DOPS, n * b, duration=b * 1e-3,
                                      start_code_phases=PHASES)
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm="xla_bank")
    _, out = ttracking.track_bank(
        config, torch.as_tensor(system.codes), states,
        torch.as_tensor(np.array(sig.real, np.float32).reshape(b, n)),
        torch.as_tensor(np.array(sig.imag, np.float32).reshape(b, n)))
    assert (np.abs(out.carrier_doppler[-1].numpy() - DOPS) < 20.0).all()
    assert (out.cn0_dbhz[-1].numpy() > 50.0).all()


def test_to_track_states_of_a_jax_result_gives_the_port_state():
    sre, sim, fs = _scenario()
    want, got = _both("GPSL1", sre, sim, PRNS, fs, max_doppler=4000.0)
    from_jax = ttracking.state_to_numpy(tacquire.to_track_states(want, device="cpu"))
    jax_state = jax.tree.map(np.asarray, jacquire.to_track_states(want))
    for a, b in zip(jax.tree.leaves(from_jax), jax.tree.leaves(jax_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    from_port = ttracking.state_to_numpy(tacquire.to_track_states(got, device="cpu"))
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(from_jax)):
        np.testing.assert_allclose(a, b, atol=1e-2)


def test_pcps_finds_e1_satellites():
    # tests/test_galileo.py:179: one full 4 ms primary period at 4.092 MHz.
    prns = np.array([3, 17])
    dops = np.array([900.0, -2100.0])
    phases = np.array([1200.5, 5000.25])
    n = 16368
    sig, fs = jmodels.gen_signal_mixed(jmodels.GalileoE1(), prns, dops, n, duration=4e-3,
                                       start_code_phases=phases)
    sre, sim = np.array(sig.real, np.float32), np.array(sig.imag, np.float32)
    want, got = _both("GALILEOE1B", sre, sim, prns, fs, max_doppler=3000.0)
    _assert_same_decisions(got, want, n, fs, 2.046e6, 3000.0, _step(n, fs))
    assert (np.abs(got.carrier_doppler.numpy() - dops) < 100.0).all()
    err = np.abs(got.code_phase.numpy() - phases)
    err = np.minimum(err, 8184 - err)
    assert (err < 0.6).all()
    assert (got.peak_metric.numpy() > 10.0).all()


def test_pcps_finds_b1i_satellites():
    # tests/test_beidou.py:207: one 1 ms primary period at 8.192 MHz.
    prns = np.array([4, 21])
    dops = np.array([1250.0, -2400.0])
    phases = np.array([300.25, 1700.5])
    n = 8192
    sig, fs = jmodels.gen_signal_mixed(jmodels.BeiDouB1I(with_secondary=False), prns, dops, n,
                                       start_code_phases=phases)
    sre, sim = np.array(sig.real, np.float32), np.array(sig.imag, np.float32)
    want, got = _both("BEIDOUB1I", sre, sim, prns, fs, max_doppler=4000.0)
    _assert_same_decisions(got, want, n, fs, 2.046e6, 4000.0, _step(n, fs))
    assert (np.abs(got.carrier_doppler.numpy() - dops) < 400.0).all()
    err = np.abs(got.code_phase.numpy() - phases)
    err = np.minimum(err, 2046 - err)
    assert (err < 0.3).all()
    assert (got.peak_metric.numpy() > 10.0).all()


def test_pcps_matches_the_handed_over_port_signal():
    # The port's own synthesis (the smoke run's capture path) acquires the
    # same as the JAX synthesis: the planted satellites' bins and phases.
    system = tmodels.GPSL1()
    sig, fs = tmodels.gen_signal_mixed(system, PRNS, DOPS, 4096, start_code_phases=PHASES,
                                       device="cpu")
    got = tacquire.acquire(system, *tmodels.soa(sig), PRNS, fs, max_doppler=4000.0)
    sre, sim, _ = _scenario()
    want = tacquire.acquire(system, torch.from_numpy(sre), torch.from_numpy(sim), PRNS, fs,
                            max_doppler=4000.0)
    np.testing.assert_array_equal(got.carrier_doppler.numpy(), want.carrier_doppler.numpy())
    np.testing.assert_array_equal(got.code_phase.numpy(), want.code_phase.numpy())


@pytest.mark.parametrize("mode,match", [("matmul", "TPU"), ("dft", "'auto' or 'fft'")])
def test_fft_mode_other_than_fft_raises(mode, match):
    sre, sim, fs = _scenario(n=2048)
    with pytest.raises(ValueError, match=match):
        tacquire.acquire(tmodels.GPSL1(), torch.from_numpy(sre), torch.from_numpy(sim),
                         PRNS, fs, fft_mode=mode)


def test_run_acquire_benchmark_on_the_cpu():
    r = tbench.run_acquire_benchmark({"GNSS": "GPSL1", "num_samples": 2048, "num_prns": 4,
                                      "rounds": 2, "processor": "CPU", "trials": 2})
    assert r["num_bins"] == 16 and r["rounds"] == 2 and r["num_prns"] == 4
    assert r["fft_mode"] == "fft" and r["algorithm"] == "pcps" and r["backend"] == "cpu"
    assert 0 < r["Minimum"] <= r["Median"] <= r["Maximum"]
    with pytest.raises(ValueError, match="processor"):
        tbench.run_acquire_benchmark({"GNSS": "GPSL1", "num_samples": 2048, "processor": "TPU"})
