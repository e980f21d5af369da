"""PyTorch port, closed loops on the per-channel kernels and the one-hot bank
route: `track` and `track_bank` against the JAX package on the same
algorithms, and the per-channel bank loop against the batched plain path.

Tolerances as tests/test_tracking.py:236-242 (prompt rtol 5e-3 atol 10,
Doppler rtol 1e-3 atol 1 Hz); the channels compared are locked.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import channel_kernels, epl_kernels

torch.set_num_threads(1)

N, NUM_MS = 4096, 20
FS = N / 1e-3
DOPPLER = 800.0
DOPS = np.array([-900.0, 100.0, 1500.0])


def _satellite_blocks(prns, dopplers, code_phases):
    system = jmodels.GPSL1()
    total = None
    for prn, d, phi in zip(prns, dopplers, code_phases):
        scale = 1.0 + d / system.center_frequency
        s, _ = jmodels.gen_signal(system, prn, d, N * NUM_MS, duration=NUM_MS * 1e-3,
                                  code_frequency=system.code_frequency * scale,
                                  start_code_phase=phi, start_carrier_phase=0.3)
        total = s if total is None else total + s
    return (np.array(total.real).reshape(NUM_MS, N),
            np.array(total.imag).reshape(NUM_MS, N))


@pytest.fixture(scope="module")
def single():
    """One GPS L1 satellite, tracked by the JAX `track` on `pallas_fused`
    (interpret mode) from a 5 Hz / 0.1 chip start."""
    sre, sim = _satellite_blocks([0], [DOPPLER], [40.0])
    system = jmodels.GPSL1()
    config = jtracking.TrackConfig.for_system(system, FS, N, algorithm="pallas_fused")
    state = jtracking.init_state(0, carrier_doppler=DOPPLER + 5.0, code_phase=39.9)
    _, out = jtracking.track(config, jnp.asarray(system.codes), state,
                             jnp.asarray(sre), jnp.asarray(sim))
    return sre, sim, {f: np.asarray(v) for f, v in out._asdict().items()}


@pytest.mark.parametrize("algorithm", ["pallas_fused", "pallas_taps"])
def test_track_matches_jax_track_on_pallas_fused(single, algorithm):
    sre, sim, want = single
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, FS, N, algorithm=algorithm)
    state = ttracking.init_state(0, carrier_doppler=DOPPLER + 5.0, code_phase=39.9)
    final, out = ttracking.track(config, torch.as_tensor(system.codes), state,
                                 torch.as_tensor(sre), torch.as_tensor(sim))
    assert out.accum_re.shape == (NUM_MS, 3) and int(final.ms_elapsed) == NUM_MS
    np.testing.assert_allclose(out.prompt_re.numpy(), want["prompt_re"], rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(out.carrier_doppler.numpy(), want["carrier_doppler"],
                               rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(out.code_phase.numpy(), want["code_phase"], rtol=1e-4,
                               atol=5e-3)
    assert float(torch.hypot(out.prompt_re[-1], out.prompt_im[-1])) > 0.9 * N
    assert channel_kernels.correlate_pallas_fused.launches == 0
    assert channel_kernels.correlate_pallas_taps.launches == 0


@pytest.mark.parametrize("algorithm", ["pallas_fused", "pallas_taps", "unfused_xla"])
def test_track_bank_per_channel_matches_fused_xla(algorithm):
    # K=2 on two satellites: the per-channel kernels loop over channels, the
    # plain paths batch them; all agree with the batched fused_xla.
    sre, sim = _satellite_blocks([0, 1], DOPS[:2], [0.0, 300.0])
    system = tmodels.GPSL1()
    codes = torch.as_tensor(system.codes)
    states = ttracking.init_state(np.arange(2), carrier_doppler=DOPS[:2],
                                  code_phase=np.array([0.0, 300.0]))
    outs = {}
    for algo in (algorithm, "fused_xla"):
        config = ttracking.TrackConfig.for_system(system, FS, N, algorithm=algo)
        _, outs[algo] = ttracking.track_bank(config, codes, states,
                                             torch.as_tensor(sre), torch.as_tensor(sim))
    got, want = outs[algorithm], outs["fused_xla"]
    assert got.accum_re.shape == (NUM_MS, 2, 3)
    np.testing.assert_allclose(got.prompt_re.numpy(), want.prompt_re.numpy(),
                               rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(got.carrier_doppler.numpy(), want.carrier_doppler.numpy(),
                               rtol=1e-3, atol=1.0)


def test_track_bank_onehot_matches_jax_track_bank():
    # tests/test_tracking.py's bank scenario, K=3, on the one-hot route of
    # both packages (hoisted code tables, no nominal rates).
    sre, sim = _satellite_blocks([0, 1, 2], DOPS, [0.0, 0.0, 0.0])
    jsys, tsys = jmodels.GPSL1(), tmodels.GPSL1()
    jcfg = jtracking.TrackConfig.for_system(jsys, FS, N, algorithm="pallas_bank_onehot",
                                            tile_rows=8)
    jstates = jtracking.init_state(np.arange(3), carrier_doppler=DOPS)
    _, want = jtracking.track_bank(jcfg, jnp.asarray(jsys.codes), jstates,
                                   jnp.asarray(sre), jnp.asarray(sim))
    tcfg = ttracking.TrackConfig.for_system(tsys, FS, N, algorithm="pallas_bank_onehot")
    tstates = ttracking.init_state(np.arange(3), carrier_doppler=DOPS)
    _, got = ttracking.track_bank(tcfg, torch.as_tensor(tsys.codes), tstates,
                                  torch.as_tensor(sre), torch.as_tensor(sim))
    np.testing.assert_allclose(got.prompt_re.numpy(), np.asarray(want.prompt_re),
                               rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(got.carrier_doppler.numpy(), np.asarray(want.carrier_doppler),
                               rtol=1e-3, atol=1.0)
    assert epl_kernels.correlate_pallas_bank_onehot.launches == 0


def test_onehot_gets_code_tables_but_no_nominal_rates():
    ttrack = importlib.import_module("gpuacceleratedtracking_tpu_torch.tracking.track")
    cfg = ttracking.TrackConfig.for_system(tmodels.GPSL1(), FS, N,
                                           algorithm="pallas_bank_onehot")
    codes = torch.as_tensor(tmodels.GPSL1().codes)
    assert ttrack._bank_kernel_kwargs(cfg) == {}
    tiles = ttrack._bank_code_tile_kwargs(cfg, codes, torch.arange(3))["code_tiles"]
    assert tiles.shape == (3, 1023)
    for algo in ("pallas_fused", "pallas_taps", "unfused_xla"):
        cfg = ttracking.TrackConfig.for_system(tmodels.GPSL1(), FS, N, algorithm=algo)
        assert ttrack._bank_kernel_kwargs(cfg) == {}
        assert ttrack._bank_code_tile_kwargs(cfg, codes, torch.arange(3)) == {}
