"""PyTorch port, GPS L5 path: overlay sync (`secondary`), lock detection
(`lock`) and the dual-component bank (`dual`) against the JAX package.

The detector inputs are those of tests/test_secondary.py and
tests/test_lock.py; the dual bank runs through `pallas_bank_auto`, which
resolves GPS L5 at 16.384 MHz to the transition route, against the JAX
`track_bank_dual` on the JAX transition kernel (Pallas interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels

torch.set_num_threads(1)

NH10 = tmodels.gpsl5.neuman_hofman(False)
NH20 = tmodels.gpsl5.neuman_hofman(True)


def _secondary_inputs(name):
    """Prompt windows of tests/test_secondary.py's `TestDetector`."""
    if name == "recovers_offset":
        return 100.0 * NH20[(np.arange(30) + 7) % 20], NH20
    if name == "sign_ambiguity_and_noise":
        rng = np.random.default_rng(0)
        return -80.0 * NH20[(np.arange(40) + 13) % 20] + rng.normal(0, 8.0, 40), NH20
    if name == "batched_channels":
        offsets = np.array([0, 4, 9])
        return 50.0 * NH10[(np.arange(25)[:, None] + offsets[None, :]) % 10], NH10
    rng = np.random.default_rng(3)           # "windowed_data_robust"
    offsets = np.array([5, 12, 19])
    b = np.arange(60)[:, None]
    bits = rng.choice([-1.0, 1.0], (60 // 20 + 2, len(offsets)))
    nav = np.take_along_axis(bits, (b + offsets[None, :]) // 20, axis=0)
    prompts = 90.0 * NH20[(b + offsets[None, :]) % 20] * nav
    return prompts + rng.normal(0, 9.0, prompts.shape), NH20


@pytest.mark.parametrize("name,windowed", [
    ("recovers_offset", False), ("sign_ambiguity_and_noise", False),
    ("batched_channels", False), ("windowed_data_robust", False),
    # The windowed detector needs >= 2S-1 blocks (30 < 39 for the first case).
    ("sign_ambiguity_and_noise", True), ("batched_channels", True),
    ("windowed_data_robust", True),
])
def test_secondary_offset_matches_jax(name, windowed):
    prompts, code = _secondary_inputs(name)
    jfn = (jtracking.detect_secondary_offset_windowed if windowed
           else jtracking.detect_secondary_offset)
    tfn = (ttracking.detect_secondary_offset_windowed if windowed
           else ttracking.detect_secondary_offset)
    want_off, want_conf = jfn(jnp.asarray(prompts, jnp.float32), code)
    got_off, got_conf = tfn(torch.as_tensor(prompts, dtype=torch.float32), code)
    assert got_off.dtype == torch.int32
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))
    np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), rtol=1e-6)


def test_windowed_needs_enough_blocks():
    with pytest.raises(ValueError, match="need >= 39 blocks"):
        ttracking.detect_secondary_offset_windowed(torch.ones(30), NH20)


def _bits(num_blocks, bit_length, offset, rng):
    """tests/test_lock.py's bit stream: edges where (b + offset) % bit_length == 0."""
    first = bit_length - offset if offset else bit_length
    n_bits = 2 + num_blocks // bit_length
    bits = rng.choice([-1.0, 1.0], n_bits)
    reps = [min(first, num_blocks)] + [bit_length] * (n_bits - 1)
    return np.concatenate([np.full(r, b) for b, r in zip(bits, reps)])[:num_blocks]


def test_phase_lock_metric_matches_jax():
    rng = np.random.default_rng(0)
    b = 200
    bits = _bits(b, 20, 7, rng)
    theta = np.cumsum(rng.uniform(0.5, 1.5, b))
    p_re = np.stack([1000.0 * bits + 50.0 * rng.standard_normal(b),
                     1000.0 * np.cos(theta)], 1).astype(np.float32)
    p_im = np.stack([50.0 * rng.standard_normal(b),
                     1000.0 * np.sin(theta)], 1).astype(np.float32)
    want = np.asarray(jtracking.phase_lock_metric(jnp.asarray(p_re), jnp.asarray(p_im)))
    got = ttracking.phase_lock_metric(torch.as_tensor(p_re), torch.as_tensor(p_im)).numpy()
    assert got.shape == want.shape == (10, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[:, 0] > 0.9).all() and (np.abs(got[:, 1]) < 0.6).all()
    flips = 500.0 * _bits(100, 20, 3, np.random.default_rng(1))
    np.testing.assert_allclose(
        ttracking.phase_lock_metric(torch.as_tensor(flips), torch.zeros(100)).numpy(), 1.0)


@pytest.mark.parametrize("structured", [True, False])
def test_detect_bit_boundary_matches_jax(structured):
    if structured:
        rng = np.random.default_rng(2)
        prompts = np.stack([1000.0 * _bits(600, 20, o, rng) + 30.0 * rng.standard_normal(600)
                            for o in (0, 7, 19)], axis=1)
    else:
        prompts = np.random.default_rng(3).choice([-1.0, 1.0], 600) * 1000.0
    want_off, want_conf = jtracking.detect_bit_boundary(jnp.asarray(prompts, jnp.float32))
    got_off, got_conf = ttracking.detect_bit_boundary(torch.as_tensor(prompts, dtype=torch.float32))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))
    np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), rtol=1e-6)
    if structured:
        np.testing.assert_array_equal(got_off.numpy(), [0, 7, 19])


def _dual_signal(num_blocks, num_samples, dops, prns, nav_seed=5):
    """Noiseless I5 (data x NH10 x nav) + j Q5 (pilot x NH20) per satellite,
    summed, as ``[B, N]`` numpy planes (tests/test_dual.py's `_dual_signal`)."""
    sys_i, sys_q = jmodels.GPSL5(), jmodels.GPSL5(quadrature=True)
    rng = np.random.default_rng(nav_seed)
    total = 0
    navs = []
    for prn, dop in zip(prns, dops):
        nav = np.repeat(rng.choice([-1.0, 1.0], num_blocks // 10 + 1), 10)[:num_blocks]
        common = dict(duration=num_blocks * 1e-3,
                      code_frequency=sys_i.code_frequency * (1 + dop / sys_i.center_frequency))
        sig_i, _ = jmodels.gen_signal(sys_i, prn, dop, num_samples * num_blocks,
                                      secondary_code=sys_i.secondary_code, **common)
        sig_q, _ = jmodels.gen_signal(sys_q, prn, dop, num_samples * num_blocks,
                                      secondary_code=sys_q.secondary_code,
                                      start_carrier_phase=np.pi / 2, **common)
        total = total + (np.asarray(sig_i).reshape(num_blocks, num_samples) * nav[:, None]
                         + np.asarray(sig_q).reshape(num_blocks, num_samples))
        navs.append(nav.astype(np.float32))
    return (np.ascontiguousarray(total.real, np.float32),
            np.ascontiguousarray(total.imag, np.float32), np.stack(navs, 1))


N_DUAL, B_DUAL = 16384, 12
DUAL_PRNS, DUAL_DOPS = [3, 8, 20], [900.0, -1500.0, 2300.0]


@pytest.fixture(scope="module")
def jax_dual():
    """tests/test_dual.py's dual bank, three satellites, on the JAX transition kernel."""
    sre, sim, nav = _dual_signal(B_DUAL, N_DUAL, DUAL_DOPS, DUAL_PRNS)
    sys_i, sys_q = jmodels.GPSL5(), jmodels.GPSL5(quadrature=True)
    cfg = jtracking.dual_config(jtracking.TrackConfig.for_system(
        sys_i, N_DUAL / 1e-3, N_DUAL, algorithm="pallas_bank_auto", use_secondary=False))
    st = jtracking.init_state(np.array(DUAL_PRNS), carrier_doppler=np.array(DUAL_DOPS) + 5.0)
    _, out = jtracking.track_bank_dual(cfg, jnp.asarray(sys_i.codes), jnp.asarray(sys_q.codes),
                                       st, jnp.asarray(sre), jnp.asarray(sim))
    return sre, sim, nav, out


def test_track_bank_dual_matches_jax(jax_dual):
    sre, sim, _, want = jax_dual
    sys_i, sys_q = tmodels.GPSL5(), tmodels.GPSL5(quadrature=True)
    fs = N_DUAL / 1e-3
    assert epl_kernels.bank_algorithm_for(N_DUAL, fs, sys_i.code_length,
                                          sys_i.code_frequency) == "pallas_bank"
    cfg = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, fs, N_DUAL, algorithm="pallas_bank_auto", use_secondary=False))
    st = ttracking.init_state(np.array(DUAL_PRNS), carrier_doppler=np.array(DUAL_DOPS) + 5.0)
    final, got = ttracking.track_bank_dual(
        cfg, torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes), st,
        torch.as_tensor(sre), torch.as_tensor(sim))
    assert isinstance(got, ttracking.DualTrackOutput)
    assert got.pilot.prompt_re.shape == got.data_prompt_re.shape == (B_DUAL, 3)
    assert final.ms_elapsed.tolist() == [B_DUAL] * 3
    # tests/test_tracking.py:170-175's closed-loop tolerances.
    for field in ("prompt_re", "prompt_im"):
        np.testing.assert_allclose(getattr(got.pilot, field).numpy(),
                                   np.asarray(getattr(want.pilot, field)), rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(got.pilot.carrier_doppler.numpy(),
                               np.asarray(want.pilot.carrier_doppler), rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(got.data_prompt_re.numpy(), np.asarray(want.data_prompt_re),
                               rtol=5e-3, atol=10.0)
    assert epl_kernels.correlate_pallas_bank.launches == 0


def test_track_bank_dual_refuses_overlay_in_config():
    sys_i = tmodels.GPSL5()
    cfg = ttracking.TrackConfig.for_system(sys_i, 16.384e6, 16384)   # NH10 filled in
    with pytest.raises(ValueError, match="dual_config"):
        ttracking.track_bank_dual(cfg, torch.as_tensor(sys_i.codes),
                                  torch.as_tensor(tmodels.GPSL5(True).codes),
                                  ttracking.init_state(np.array([0])),
                                  torch.zeros(1, 16384), torch.zeros(1, 16384))


def test_noiseless_symbol_recovery_exact():
    # tests/test_dual.py:91 through the port's bank route.
    n, b, dop, prn = 16384, 150, -400.0, 7
    sre, sim, nav = _dual_signal(b, n, [dop], [prn])
    sys_i, sys_q = tmodels.GPSL5(), tmodels.GPSL5(quadrature=True)
    cfg = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, n / 1e-3, n, algorithm="pallas_bank_auto", use_secondary=False))
    st = ttracking.init_state(np.array([prn]), carrier_doppler=np.array([dop + 10.0]))
    _, out = ttracking.track_bank_dual(cfg, torch.as_tensor(sys_i.codes),
                                       torch.as_tensor(sys_q.codes), st,
                                       torch.as_tensor(sre), torch.as_tensor(sim))
    dsign = np.sign(out.data_prompt_re[:, 0].numpy())
    np.testing.assert_array_equal(dsign[-50:], nav[-50:, 0])
    assert out.pilot.prompt_re[-1, 0] > 0.5 * n
    # Lock holds over the last 60 blocks (three 20-block windows).
    lock = ttracking.phase_lock_metric(out.pilot.prompt_re[-60:], out.pilot.prompt_im[-60:])
    assert (lock > 0.8).all(), lock
