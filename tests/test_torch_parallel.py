"""PyTorch port, the distributed layer (`parallel/`) against the JAX package.

The JAX functions run on the 8-device virtual CPU mesh of `conftest.py`; the
port's run on meshes of repeated CPU devices (``["cpu"] * 8``), one process
driving every shard as on the card. Inputs come from numpy seeds and the JAX
`gen_signal` / `init_state`, carried into the port with `state_from_numpy`.
The advance tables and phases are held bit for bit; sharded correlation and
tracking to the tolerances of tests/test_parallel.py, since XLA's ``psum``
adds the time shards' partials in another order than the port's shard order.
"""

import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import parallel as jparallel
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import parallel as tparallel
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import bank_comp, epl_kernels

torch.set_num_threads(1)

CPUS = ["cpu"] * 8


def _tmesh(axis_sizes):
    return tparallel.make_mesh(axis_sizes, devices=CPUS)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# --- The advance tables and phases, bit for bit.

ADVANCE_CASES = {
    # name -> (nominal carrier Hz, nominal code Hz, fs, code length)
    "gpsl1": (0.0, 1.023e6, 32.768e6, 1023),
    "gpsl5_if": (1.25e6, 10.23e6, 32.768e6, 10230),
    "glonass": (0.0, 0.511e6, 2.048e6, 511),
}


@pytest.mark.parametrize("n", [4096, 1 << 15, 1 << 18])
@pytest.mark.parametrize("case", sorted(ADVANCE_CASES))
def test_nominal_advance_tables_match_jax(case, n):
    fcar, fcode, fs, lc = ADVANCE_CASES[case]
    want = jparallel.nominal_advance_tables(fcar, fcode, fs, n // 8, 8, lc)
    got = tparallel.nominal_advance_tables(fcar, fcode, fs, n // 8, 8, lc)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and g.shape == (8,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [4096, 1 << 15, 1 << 18])
@pytest.mark.parametrize("case", sorted(ADVANCE_CASES))
def test_advance_phases_match_jax_bit_for_bit(case, n):
    fcar, fcode, fs, lc = ADVANCE_CASES[case]
    rng = np.random.default_rng(n + lc)
    size = 2048
    f_car = (fcar + rng.uniform(-5000.0, 5000.0, size)).astype(np.float32)
    f_code = (fcode + rng.uniform(-10.0, 10.0, size)).astype(np.float32)
    phi_car = rng.uniform(0.0, 2 * np.pi, size).astype(np.float32)
    phi_code = rng.uniform(0.0, lc, size).astype(np.float32)
    local_n = n // 8
    jtab = jparallel.nominal_advance_tables(fcar, fcode, fs, local_n, 8, lc)
    ttab = tparallel.nominal_advance_tables(fcar, fcode, fs, local_n, 8, lc)
    for t in range(8):
        want = jparallel.advance_phases(
            jnp.asarray(phi_car), jnp.asarray(phi_code), jnp.asarray(f_car),
            jnp.asarray(f_code), jnp.int32(t), jtab, fcar, fcode, fs, local_n, lc)
        got = tparallel.advance_phases(
            _t(phi_car), _t(phi_code), _t(f_car), _t(f_code), t, ttab, fcar, fcode,
            fs, local_n, lc)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _shard_form_case(case, n, size=512):
    """Channel values of ``case``'s family as a tracking state holds them
    (Dopplers, phases in [0, 2 pi) and [0, Lc), the ends included), and a
    zero ``[n]`` block with its code tiles."""
    fcar, fcode, fs, lc = ADVANCE_CASES[case]
    rng = np.random.default_rng(n + lc + 7)
    car_dop = rng.uniform(-5000.0, 5000.0, size).astype(np.float32)
    code_dop = (car_dop * fcode / 1.57542e9 + rng.uniform(-2.0, 2.0, size)).astype(np.float32)
    two_pi = np.float32(2 * np.pi)
    phi_car = rng.uniform(0.0, 2 * np.pi, size).astype(np.float32)
    phi_code = rng.uniform(0.0, lc, size).astype(np.float32)
    edges = np.array([0.0, 1e-7, 1e-3, two_pi - 1e-6, np.nextafter(two_pi, 0)], np.float32)
    phi_car[:len(edges)] = edges
    phi_code[:6] = np.array([0.0, 1e-6, 0.5, lc - 1e-3, lc - 0.5, np.nextafter(np.float32(lc), 0)],
                            np.float32)
    codes = torch.ones((lc, 4), dtype=torch.float32)
    tiles = epl_kernels.prepare_bank_code_tiles_rows(codes, torch.zeros(size, dtype=torch.long))
    zeros = torch.zeros(n)
    return (fcar, fcode, fs, lc), tuple(_t(x) for x in (car_dop, phi_car, code_dop, phi_code)), \
        (zeros, zeros, codes, tiles)


@pytest.mark.parametrize("n", [4096, 1 << 15, 1 << 18])
@pytest.mark.parametrize("case", sorted(ADVANCE_CASES))
def test_shard_form_equals_advance_phases_then_channel_params(case, n):
    # A bank call in the state form with a time shard (what the bank kernels
    # derive on the card) against the torch ops the sharded bank ran before:
    # `advance_phases` on IF + Doppler, then `_channel_params`, bit for bit,
    # for every shard of 8, shard 0 included.
    (fcar, fcode, fs, lc), (car_dop, phi_car, code_dop, phi_code), (sre, sim, codes, tiles) = \
        _shard_form_case(case, n)
    local_n = n // 8
    tables = tparallel.nominal_advance_tables(fcar, fcode, fs, local_n, 8, lc)
    shifts = (-3, 0, 3)
    f_car, f_code = fcar + car_dop, fcode + code_dop
    for t in range(8):
        shard = tparallel.time_shard(t, tables, fs, local_n, lc)
        assert (shard.index, shard.num_samples, shard.offset) == (t, local_n, t * local_n)
        call = epl_kernels.BankRowsCall(
            sre, sim, codes, torch.zeros(512), None, fs, None, None, None, shifts, lc,
            code_tiles=tiles,
            route="pallas_bank_onehot",
            channels=epl_kernels.BankChannels(fcar, car_dop, phi_car, fcode, code_dop, phi_code,
                                              shard))
        assert call.num_samples == local_n and call.offset == t * local_n
        phases = tparallel.advance_phases(phi_car, phi_code, f_car, f_code, t, tables, fcar,
                                          fcode, fs, local_n, lc)
        want = epl_kernels._channel_params(f_car, fs, phases[0], f_code, phases[1], -3, "cpu")
        assert torch.equal(call.params, want), t
        assert bool((phases[0] >= 0).all() and (phases[0] < np.float32(2 * np.pi)).all())
        assert bool((phases[1] >= 0).all() and (phases[1] < lc).all())


# --- correlate_sharded against the JAX correlate_sharded.

SYSTEM = jmodels.GPSL1()
TSYSTEM = tmodels.GPSL1()


def _correlate_case(n, prn, fcar, phicar, phicode, num_ants=None):
    signal, fs = jmodels.gen_signal(SYSTEM, prn, fcar, n, start_code_phase=phicode,
                                    start_carrier_phase=phicar, num_ants=num_ants)
    shifts = tuple(int(s) for s in jmodels.correlator_sample_shifts(
        SYSTEM, jmodels.EPLCorrelator(3), fs))
    sre, sim = (np.array(x) for x in jmodels.soa(signal))
    return sre, sim, fs, shifts


def _both_correlate(sre, sim, fs, shifts, prn, fcar, phicar, phicode, axes,
                    algorithm="fused_xla", jax_algorithm="fused_xla", **kw):
    args = (prn, fcar, fs, phicar, SYSTEM.code_frequency, phicode, shifts,
            SYSTEM.code_length)
    common = dict(nominal_code_frequency=SYSTEM.code_frequency, **kw)
    jre, jim = jax.jit(functools.partial(
        jparallel.correlate_sharded, sampling_frequency=fs, sample_shifts=shifts,
        code_length=SYSTEM.code_length, mesh=jparallel.make_mesh(axes),
        algorithm=jax_algorithm, **common,
    ))(jnp.asarray(sre), jnp.asarray(sim), jnp.asarray(SYSTEM.codes), prn, fcar,
       carrier_phase=phicar, code_frequency=SYSTEM.code_frequency, code_phase=phicode)
    tre, tim = tparallel.correlate_sharded(
        _t(sre), _t(sim), torch.as_tensor(TSYSTEM.codes), prn, fcar, fs, phicar,
        SYSTEM.code_frequency, phicode, shifts, SYSTEM.code_length, mesh=_tmesh(axes),
        algorithm=algorithm, **common)
    return (np.asarray(jre) + 1j * np.asarray(jim)), tre.numpy() + 1j * tim.numpy()


@pytest.mark.parametrize("num_time", [2, 4, 8])
def test_time_sharded_correlation_matches_jax(num_time):
    kw = dict(prn=5, fcar=-2345.0, phicar=0.9, phicode=517.3)
    sre, sim, fs, shifts = _correlate_case(4096, **kw)
    want, got = _both_correlate(sre, sim, fs, shifts, axes={"time": num_time}, **kw)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)


def test_antenna_sharded_beamform_matches_jax():
    kw = dict(prn=0, fcar=1500.0, phicar=0.0, phicode=0.0)
    sre, sim, fs, shifts = _correlate_case(2048, num_ants=4, **kw)
    want, got = _both_correlate(sre, sim, fs, shifts, axes={"ant": 4, "time": 2},
                                ant_axis="ant", beamform=True, **kw)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.1)


def test_antenna_sharded_without_beamform_keeps_the_antenna_axis():
    kw = dict(prn=0, fcar=1500.0, phicar=0.0, phicode=0.0)
    sre, sim, fs, shifts = _correlate_case(2048, num_ants=4, **kw)
    want, got = _both_correlate(sre, sim, fs, shifts, axes={"ant": 2, "time": 2},
                                ant_axis="ant", **kw)
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.1)


def test_large_block_phase_advance_matches_jax():
    # N = 2^17 over 8 time shards: the f64 nominal tables keep the sharded
    # result on the unsharded one.
    kw = dict(prn=2, fcar=3210.0, phicar=0.0, phicode=3.25)
    sre, sim, fs, shifts = _correlate_case(1 << 17, **kw)
    want, got = _both_correlate(sre, sim, fs, shifts, axes={"time": 8}, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5.0)


@pytest.mark.parametrize("algorithm", ["pallas_fused", "pallas_taps"])
def test_per_channel_kernels_time_sharded_match_jax(algorithm):
    # On the CPU the port's wrappers run their plain versions. The JAX
    # reference is its fused_xla on the same mesh (tests/test_parallel.py's
    # oracle); the per-channel kernels' chip arithmetic may flip a chip
    # boundary against it, which moves a tap by at most 2 samples' worth.
    kw = dict(prn=5, fcar=-2345.0, phicar=0.9, phicode=517.3)
    sre, sim, fs, shifts = _correlate_case(4096, **kw)
    want, got = _both_correlate(sre, sim, fs, shifts, axes={"time": 2},
                                algorithm=algorithm, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.05)


def test_correlate_sharded_needs_the_nominal_code_frequency():
    sre, sim, fs, shifts = _correlate_case(1024, 0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="nominal_code_frequency"):
        tparallel.correlate_sharded(
            _t(sre), _t(sim), torch.as_tensor(TSYSTEM.codes), 0, 0.0, fs, 0.0,
            SYSTEM.code_frequency, 0.0, shifts, SYSTEM.code_length,
            mesh=_tmesh({"time": 2}))
    with pytest.raises(ValueError, match="not divisible"):
        tparallel.correlate_sharded(
            _t(sre), _t(sim), torch.as_tensor(TSYSTEM.codes), 0, 0.0, fs, 0.0,
            SYSTEM.code_frequency, 0.0, shifts, SYSTEM.code_length,
            mesh=_tmesh({"time": 3}), nominal_code_frequency=SYSTEM.code_frequency)


# --- track_bank_sharded against the JAX track_bank_sharded.

def _bank_scenario(system, num_k, num_ms, n, num_ants=None, use_secondary=True,
                   algorithm="fused_xla"):
    """tests/test_parallel.py's `_scenario`: ``num_k`` satellites at Dopplers
    -2000..2000 Hz and code phases 37 k chips, mixed into one front end."""
    fs = n / 1e-3
    dops = np.linspace(-2000.0, 2000.0, num_k)
    sigs = []
    for prn, d in enumerate(dops):
        scale = 1.0 + d / system.center_frequency
        s, _ = jmodels.gen_signal(system, prn, d, n * num_ms, duration=num_ms * 1e-3,
                                  code_frequency=system.code_frequency * scale,
                                  start_code_phase=37.0 * prn, num_ants=num_ants)
        sigs.append(s)
    mixed = sum(sigs[1:], sigs[0])
    sre, sim = (np.array(x) for x in jmodels.soa(mixed))
    if num_ants:
        sre, sim = (x.reshape(num_ants, num_ms, n).transpose(1, 0, 2).copy()
                    for x in (sre, sim))
    else:
        sre, sim = sre.reshape(num_ms, n), sim.reshape(num_ms, n)
    config = jtracking.TrackConfig.for_system(system, fs, n, algorithm=algorithm,
                                              use_secondary=use_secondary)
    states = jtracking.init_state(np.arange(num_k), carrier_doppler=dops,
                                  code_phase=37.0 * np.arange(num_k) % system.code_length)
    return config, states, sre, sim


def _port_config(config):
    return ttracking.config_from_jax_fields(dataclasses.asdict(config))


def _port_states(states):
    return ttracking.state_from_numpy(jax.tree.map(np.asarray, states), device="cpu")


def _run_jax(system, config, states, sre, sim, axes):
    mesh = jparallel.channel_time_mesh(axes[0], axes[1])
    final, out = jparallel.track_bank_sharded(config, jnp.asarray(system.codes), states,
                                              jnp.asarray(sre), jnp.asarray(sim), mesh=mesh)
    return jax.tree.map(np.asarray, final), {f: np.asarray(v) for f, v in out._asdict().items()}


def _run_port(system, config, states, sre, sim, axes):
    mesh = tparallel.channel_time_mesh(axes[0], axes[1], devices=CPUS)
    return tparallel.track_bank_sharded(
        _port_config(config), torch.as_tensor(np.asarray(system.codes)), _port_states(states),
        _t(sre), _t(sim), mesh=mesh)


def _assert_tracks_match(final, out, want_final, want, blocks=None):
    """tests/test_parallel.py:158-171's tolerances, over every block or the
    first ``blocks`` (then on the code phase of the last one compared)."""
    got = {f: getattr(out, f)[:blocks].numpy() for f in ("carrier_doppler", "prompt_re")}
    np.testing.assert_allclose(got["carrier_doppler"], want["carrier_doppler"][:blocks],
                               rtol=1e-4, atol=0.5)
    np.testing.assert_allclose(got["prompt_re"], want["prompt_re"][:blocks],
                               rtol=5e-3, atol=10.0)
    if blocks is None:
        got_phase, want_phase = final.code_phase.numpy(), np.asarray(want_final.code_phase)
    else:
        got_phase, want_phase = out.code_phase[blocks - 1].numpy(), want["code_phase"][blocks - 1]
    np.testing.assert_allclose(got_phase, want_phase, rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def k4_scenario():
    """The K=4, 40-block scenario and the JAX run on mesh 4 x 2, once."""
    config, states, sre, sim = _bank_scenario(SYSTEM, 4, 40, 2048)
    return (config, states, sre, sim), _run_jax(SYSTEM, config, states, sre, sim, (4, 2))


def test_track_bank_sharded_matches_jax(k4_scenario):
    (config, states, sre, sim), (want_final, want) = k4_scenario
    final, out = _run_port(SYSTEM, config, states, sre, sim, (4, 2))
    assert out.prompt_re.shape == (40, 4) and out.accum_re.shape == (40, 4, 3)
    assert final.ms_elapsed.tolist() == [40] * 4
    _assert_tracks_match(final, out, want_final, want)


@pytest.mark.parametrize("gnss,n", [
    ("GLONASSL1", 2048),       # 511-chip m-sequence, FDMA family
    ("GALILEOE1C", 8192),      # BOC(1,1) half-chip meander
    ("BEIDOUB1I", 8192),       # 2046-chip codes
])
def test_every_family_shards_as_in_jax(gnss, n):
    system = jmodels.get_system(gnss)
    config, states, sre, sim = _bank_scenario(system, 4, 30, n, use_secondary=False)
    want_final, want = _run_jax(system, config, states, sre, sim, (4, 2))
    final, out = _run_port(system, config, states, sre, sim, (4, 2))
    # The JAX test's property, sharded against unsharded, on the port over
    # all 30 blocks.
    unsharded = _run_port(system, config, states, sre, sim, (1, 1))
    _assert_tracks_match(final, out, unsharded[0],
                         {f: x.numpy() for f, x in unsharded[1]._asdict().items()})
    # Against the JAX sharded run over the first 10 blocks: the port's
    # unsharded E1-C loop itself leaves the JAX one (rate rounding moves a
    # BOC sub-chip edge by a sample now and then), by up to ~75 in prompt and
    # 0.004 chips over 30 blocks.
    _assert_tracks_match(final, out, want_final, want, blocks=10)


@pytest.mark.parametrize("algorithm,n,num_ms", [
    ("pallas_bank", 2048, 20),        # tests/test_parallel.py:200-217
    ("pallas_bank_rows", 8192, 10),   # tests/test_parallel.py:219-238
])
def test_bank_kernels_shard_as_in_jax(algorithm, n, num_ms):
    # The JAX kernels in Pallas interpret mode; the port's plain versions.
    config, states, sre, sim = _bank_scenario(SYSTEM, 4, num_ms, n, algorithm=algorithm)
    want_final, want = _run_jax(SYSTEM, config, states, sre, sim, (2, 2))
    final, out = _run_port(SYSTEM, config, states, sre, sim, (2, 2))
    _assert_tracks_match(final, out, want_final, want)


def test_four_antennas_through_pallas_bank_auto_shard_as_in_jax():
    # A=4 resolves to the composite route on both sides; the sharded bank
    # sums the antennas uniformly, as the JAX function does.
    config, states, sre, sim = _bank_scenario(SYSTEM, 4, 2, 8192, num_ants=4,
                                              algorithm="pallas_bank_auto")
    want_final, want = _run_jax(SYSTEM, config, states, sre, sim, (2, 2))
    before = bank_comp.correlate_pallas_bank_comp.launches
    final, out = _run_port(SYSTEM, config, states, sre, sim, (2, 2))
    assert bank_comp.correlate_pallas_bank_comp.launches == before   # plain on the CPU
    assert out.accum_re.shape == (2, 4, 4, 3)
    _assert_tracks_match(final, out, want_final, want)


# --- Against the port itself.

def _port_bank_case(algorithm, n=8192, num_ms=5, num_k=8):
    fs = n / 1e-3
    dops = np.linspace(-2000.0, 2000.0, num_k)
    signal, _ = tmodels.gen_signal_mixed(TSYSTEM, np.arange(4), dops[:4], n * num_ms,
                                         duration=num_ms * 1e-3, device="cpu")
    sre, sim = (x.reshape(num_ms, n) for x in tmodels.soa(signal))
    config = ttracking.TrackConfig.for_system(TSYSTEM, fs, n, algorithm=algorithm)
    states = ttracking.init_state(np.arange(num_k) % 32, carrier_doppler=dops, device="cpu")
    return config, states, sre, sim


PORT_ALGORITHMS = ["fused_xla", "xla_bank", "pallas_bank_rows", "pallas_bank",
                   "pallas_bank_onehot", "pallas_fused"]


@pytest.mark.parametrize("algorithm", PORT_ALGORITHMS)
@pytest.mark.parametrize("num_chan", [1, 4])
def test_channel_mesh_reproduces_track_bank_exactly(algorithm, num_chan):
    # With one time shard, each channel shard runs track_bank's arithmetic on
    # its channels: the advance to shard 0 is the identity, and every
    # correlator and the loop closure act on each channel alone.
    config, states, sre, sim = _port_bank_case(algorithm)
    codes = torch.as_tensor(TSYSTEM.codes)
    want_final, want = ttracking.track_bank(config, codes, states, sre, sim)
    mesh = tparallel.channel_time_mesh(num_chan, 1, devices=CPUS)
    final, out = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    for name, g, w in zip(out._fields, out, want):
        assert torch.equal(g, w), name
    for g, w in zip(jax.tree.leaves(tuple(final)), jax.tree.leaves(tuple(want_final))):
        assert torch.equal(g, w)


def test_time_sharded_rows_bank_matches_track_bank():
    # 2 x 2: the time shards' partials summed in shard order differ from the
    # one-shard sum at f32 rounding, and chip boundaries may land one sample
    # apart; the dry run's tolerance (__graft_entry__.py:136-143).
    config, states, sre, sim = _port_bank_case("pallas_bank_rows", num_ms=2)
    codes = torch.as_tensor(TSYSTEM.codes)
    _, want = ttracking.track_bank(config, codes, states, sre, sim)
    mesh = tparallel.channel_time_mesh(2, 2, devices=CPUS)
    _, out = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    torch.testing.assert_close(out.prompt_re, want.prompt_re, rtol=2e-3, atol=1e-2 * 8192)
    torch.testing.assert_close(out.carrier_doppler, want.carrier_doppler, rtol=2e-3, atol=1e-2)


# name -> (algorithm, N, fs, blocks, antennas)
ROUTES = {
    "rows": ("pallas_bank_rows", 8192, 8.192e6, 4, None),
    "transition": ("pallas_bank", 2048, 2.048e6, 8, None),
    "onehot": ("pallas_bank_onehot", 4096, 4.096e6, 4, None),
    "comp_a4": ("pallas_bank_auto", 8192, 8.192e6, 2, 4),
}


@pytest.mark.parametrize("axes", [(2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_bank_route_shards_as_in_jax_on_every_mesh(route, axes):
    # The bank kernels' body (each shard's advance and piece inside the bank
    # call, the shards summed in order by one finish) against the JAX
    # `track_bank_sharded` (its kernels in Pallas interpret mode) on the
    # same mesh, at tests/test_parallel.py's tolerances.
    algorithm, n, fs, blocks, num_ants = ROUTES[route]
    config, states, sre, sim = _bank_scenario(SYSTEM, 4, blocks, n, num_ants=num_ants,
                                              algorithm=algorithm)
    assert config.sampling_frequency == fs
    want_final, want = _run_jax(SYSTEM, config, states, sre, sim, axes)
    final, out = _run_port(SYSTEM, config, states, sre, sim, axes)
    assert out.accum_re.shape == (blocks, 4) + ((num_ants,) if num_ants else ()) + (3,)
    _assert_tracks_match(final, out, want_final, want)


DISTINCT = [torch.device("cpu", i) for i in range(4)]


def _distinct_mesh(axes):
    return tparallel.make_mesh({"chan": axes[0], "time": axes[1]}, devices=DISTINCT)


@pytest.mark.parametrize("algorithm", ["pallas_bank_rows", "pallas_bank_comp", "pallas_bank",
                                       "pallas_bank_onehot", "xla_bank", "pallas_fused",
                                       "pallas_taps", "fused_xla", "unfused_xla"])
@pytest.mark.parametrize("axes", [(2, 2), (4, 1), (1, 2), (2, 1)])
def test_distinct_device_branches_equal_the_one_device_branch(algorithm, axes):
    # Mesh devices named apart ("cpu:0".."cpu:3", whose tensors all lie on
    # the CPU) take the distinct-card branch, `graphs.scan_mesh`, for every
    # correlator: each card reads its own piece of the block and closes the
    # loop on its own replica of its channel shard's carry (a bank route
    # advances the phases and reads the piece inside its kernel, another
    # correlator advances them with torch ops, and each card adds its
    # channel shard's partials in shard order). All give the one-device
    # branch's results bit for bit.
    config, states, sre, sim = _port_bank_case(algorithm, num_ms=3)
    if algorithm == "pallas_bank_comp":
        sre, sim = (torch.stack([x, 0.5 * x], dim=1) for x in (sre, sim))
    codes = torch.as_tensor(TSYSTEM.codes)
    distinct = _distinct_mesh(axes)
    assert len({str(d) for d in distinct.devices.flat}) == axes[0] * axes[1]
    got = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=distinct)
    want = tparallel.track_bank_sharded(config, codes, states, sre, sim,
                                        mesh=tparallel.channel_time_mesh(*axes, devices=CPUS))
    for g, w in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))):
        assert torch.equal(g, w)


@pytest.fixture(scope="session")
def jax_sharded_runs():
    """``run(algorithm, axes)``: the K=4, 3-block, N=4096 scenario and the
    JAX `track_bank_sharded` of ``algorithm`` on mesh ``axes`` (its kernels
    in Pallas interpret mode), each made once per session."""
    runs = {}

    def run(algorithm, axes):
        if (algorithm, axes) not in runs:
            scenario = _bank_scenario(SYSTEM, 4, 3, 4096, algorithm=algorithm)
            runs[algorithm, axes] = scenario, _run_jax(SYSTEM, *scenario, axes)
        return runs[algorithm, axes]

    return run


@pytest.mark.parametrize("axes", [(2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("algorithm", ["fused_xla", "pallas_fused"])
def test_distinct_devices_without_tiles_shard_as_in_jax(jax_sharded_runs, algorithm, axes):
    # A correlator that takes no code tiles on devices named apart (a card
    # entry per shard, each card advancing and correlating its own piece
    # and closing the loop on its own replica) against the JAX
    # `track_bank_sharded` on the same axes, at tests/test_parallel.py's
    # tolerances.
    (config, states, sre, sim), (want_final, want) = jax_sharded_runs(algorithm, axes)
    final, out = tparallel.track_bank_sharded(
        _port_config(config), torch.as_tensor(np.asarray(SYSTEM.codes)), _port_states(states),
        _t(sre), _t(sim), mesh=_distinct_mesh(axes))
    assert out.accum_re.shape == (3, 4, 3) and final.ms_elapsed.tolist() == [3] * 4
    _assert_tracks_match(final, out, want_final, want)


def _piece_case(num_time=4, chunk=3, n=4096, num_ants=2):
    rng = np.random.default_rng(5)
    shape = (chunk, num_ants, n)
    sre, sim = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                for _ in range(2))
    codes = torch.as_tensor(TSYSTEM.codes)
    prn = torch.arange(6) % 32
    channels = dict(
        intermediate_frequency=0.0,
        carrier_doppler=torch.tensor(rng.uniform(-3000, 3000, 6), dtype=torch.float32),
        carrier_phase=torch.tensor(rng.uniform(0, 2 * np.pi, 6), dtype=torch.float32),
        code_frequency=TSYSTEM.code_frequency,
        code_doppler=torch.tensor(rng.uniform(-3, 3, 6), dtype=torch.float32),
        code_phase=torch.tensor(rng.uniform(0, 1023, 6), dtype=torch.float32))
    fs = 4 * n / 1e-3                         # 0.06 chips per sample: the rows envelope
    tables = tparallel.nominal_advance_tables(0.0, TSYSTEM.code_frequency, fs, n // num_time,
                                              num_time, 1023)
    shifts = (-4, 0, 4)
    tiles = epl_kernels.prepare_bank_code_tiles_rows(codes, prn)
    return sre, sim, codes, prn, channels, fs, tables, shifts, tiles


@pytest.mark.parametrize("route", ["pallas_bank_rows", "pallas_bank_comp"])
def test_a_piece_read_at_the_device_index_equals_time_piece_of_the_block(route):
    # A time shard's call on a [chunk, A, N] buffer at a block index reads the
    # piece `time_piece` cuts from that block, and computes bit for bit what
    # the call on the cut piece (offset 0) computes; the shards' results meet
    # in a ShardSum as `sum_in_order` adds them.
    num_time, n = 4, 4096
    sre, sim, codes, prn, channels, fs, tables, shifts, tiles = _piece_case(num_time, n=n)
    index = torch.tensor(2)
    fn = (bank_comp.correlate_pallas_bank_comp if route == "pallas_bank_comp"
          else epl_kernels.correlate_pallas_bank_rows)
    total = epl_kernels.ShardSum(num_time, torch.device("cpu"))
    parts = []
    for t in range(num_time):
        args = (codes, prn, None, fs, None, None, None, shifts, 1023)
        kw = dict(nominal_code_frequency=TSYSTEM.code_frequency, code_tiles=tiles)
        shard = tparallel.time_shard(t, tables, fs, n // num_time, 1023)
        at_index = epl_kernels.BankChannels(**channels, shard=shard)
        call = epl_kernels.BankRowsCall(sre, sim, *args, **kw, route=route, channels=at_index,
                                        block_index=index)
        cut = [tparallel.correlate.time_piece(x[2], t, num_time, torch.device("cpu"))
               for x in (sre, sim)]
        assert all(torch.equal(got, want) for got, want in zip(call.planes(), cut))
        piece = epl_kernels.BankChannels(**channels, shard=shard._replace(offset=0))
        want = fn(*cut, *args, **kw, channels=piece)
        got = fn(sre, sim, *args, **kw, channels=at_index, block_index=index)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert fn(sre, sim, *args, **kw, channels=at_index, block_index=index,
                  shard_sum=total) is None
        parts.append(want)
    summed = total.finish()
    for i in range(2):
        assert torch.equal(summed[i],
                           tparallel.correlate.sum_in_order([p[i] for p in parts],
                                                            torch.device("cpu")))


def test_a_shard_sum_refuses_a_call_without_a_shard_and_a_missing_shard():
    sre, sim, codes, prn, channels, fs, tables, shifts, tiles = _piece_case()
    args = (codes, prn, None, fs, None, None, None, shifts, 1023)
    kw = dict(nominal_code_frequency=TSYSTEM.code_frequency, code_tiles=tiles)
    total = epl_kernels.ShardSum(4, torch.device("cpu"))
    with pytest.raises(ValueError, match="time shard's"):
        epl_kernels.correlate_pallas_bank_rows(
            sre[0], sim[0], *args, **kw, channels=epl_kernels.BankChannels(**channels),
            shard_sum=total)
    epl_kernels.correlate_pallas_bank_rows(
        sre[0], sim[0], *args, **kw, shard_sum=total, channels=epl_kernels.BankChannels(
            **channels, shard=tparallel.time_shard(1, tables, fs, 1024, 1023)))
    with pytest.raises(ValueError, match="1 of 4 time shards"):
        total.finish()
    with pytest.raises(ValueError, match="not inside"):
        epl_kernels.BankRowsCall(sre[0], sim[0], *args, **kw, channels=epl_kernels.BankChannels(
            **channels, shard=tparallel.time_shard(3, tables, fs, 1024, 1023, offset=3500)))


# --- The dual bank.

@pytest.mark.parametrize("devices", ["repeated", "distinct"])
def test_dual_bank_sharded_matches_jax(devices):
    # "distinct": the channel shards on devices named apart, each its own
    # `track_bank_dual` call, cut and joined one copy per dtype.
    sys_i, sys_q = jmodels.GPSL5(), jmodels.GPSL5(quadrature=True)
    n, num_ms, k = 16384, 6, 4
    fs = n / 1e-3
    sig, _ = jmodels.gen_signal(sys_i, 0, 700.0, n * num_ms, duration=num_ms * 1e-3,
                                secondary_code=sys_i.secondary_code)
    sre, sim = (np.array(x).reshape(num_ms, n) for x in jmodels.soa(sig))
    cfg = jtracking.dual_config(jtracking.TrackConfig.for_system(
        sys_i, fs, n, algorithm="xla_bank", use_secondary=False))
    states = jtracking.init_state(np.arange(k), carrier_doppler=np.linspace(-900.0, 900.0, k))
    want_final, want = jparallel.track_bank_dual_sharded(
        cfg, jnp.asarray(sys_i.codes), jnp.asarray(sys_q.codes), states,
        jnp.asarray(sre), jnp.asarray(sim), mesh=jparallel.channel_time_mesh(4, 1))
    tcfg, tstates = _port_config(cfg), _port_states(states)
    codes_i, codes_q = torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes)
    mesh_devices = CPUS if devices == "repeated" else [torch.device("cpu", i) for i in range(4)]
    final, out = tparallel.track_bank_dual_sharded(
        tcfg, codes_i, codes_q, tstates, _t(sre), _t(sim),
        mesh=tparallel.channel_time_mesh(4, 1, devices=mesh_devices))
    assert out.pilot.prompt_re.shape == (num_ms, k) and out.data_prompt_re.shape == (num_ms, k)
    # tests/test_parallel.py:352-363, over the first 3 blocks. No channel
    # starts on its signal (channel 0 is 1600 Hz off it), so the loops are
    # chaotic: port and JAX part at f32 rounding from block 3 on.
    for got, w in ((out.pilot.prompt_re, want.pilot.prompt_re),
                   (out.data_prompt_re, want.data_prompt_re),
                   (out.pilot.code_phase, want.pilot.code_phase)):
        np.testing.assert_allclose(got[:3].numpy(), np.asarray(w)[:3], rtol=1e-5,
                                   atol=1e-4 if got is out.pilot.code_phase else 1e-2)
    # And the port's own unsharded dual bank, exactly, over every block:
    # channels are independent.
    ufinal, uout = ttracking.track_bank_dual(tcfg, codes_i, codes_q, tstates, _t(sre), _t(sim))
    assert torch.equal(out.pilot.prompt_re, uout.pilot.prompt_re)
    assert torch.equal(out.data_prompt_re, uout.data_prompt_re)
    assert torch.equal(final.code_phase, ufinal.code_phase)


# --- Meshes, shapes and checks.

def test_make_mesh_validates_the_device_count():
    with pytest.raises(ValueError):
        tparallel.make_mesh({"chan": 64}, devices=CPUS)


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tparallel.make_mesh({"chan": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        tparallel.channel_time_mesh(num_time_shards=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tparallel.make_mesh({"chan": 1}, devices=["cuda:0"])


def test_mesh_layout():
    mesh = tparallel.channel_time_mesh(num_time_shards=2, devices=CPUS)
    assert mesh.shape == {"chan": 4, "time": 2} and mesh.axis_names == ("chan", "time")
    assert mesh.devices.shape == (4, 2) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    mesh = tparallel.make_mesh({"ant": 2, "time": 3},
                               devices=[torch.device("cpu", i) for i in range(6)])
    assert [d.index for d in mesh.grid("time", "ant").flat] == [0, 3, 1, 4, 2, 5]
    assert [d.index for d in mesh.grid(None, "time").flat] == [0, 1, 2]
    assert mesh.grid(None, "time").shape == (1, 3)
    with pytest.raises(KeyError):
        mesh.grid("chan")


def test_output_shapes_and_checks():
    # tests/test_parallel.py:365-372, and the JAX function's input checks.
    config, states, sre, sim = _bank_scenario(SYSTEM, 8, 4, 2048)
    final, out = _run_port(SYSTEM, config, states, sre, sim, (4, 2))
    assert out.prompt_re.shape == (4, 8)
    assert final.code_phase.shape == (8,)
    with pytest.raises(ValueError, match="K=8 not divisible"):
        _run_port(SYSTEM, config, states, sre, sim, (3, 1))
    with pytest.raises(ValueError, match="not divisible by 3 time"):
        _run_port(SYSTEM, config, states, sre[:, :2047], sim[:, :2047], (1, 3))
    with pytest.raises(ValueError, match="num_samples"):
        _run_port(SYSTEM, config, states, sre[:, :1024], sim[:, :1024], (1, 2))


def test_parallel_plots_and_chip_smoke_import_without_jax():
    # Neither the new modules nor chip_smoke.py load jax, the JAX package or,
    # until a figure is drawn, matplotlib.
    code = (
        "import sys\n"
        "import gpuacceleratedtracking_tpu_torch.parallel\n"
        "import gpuacceleratedtracking_tpu_torch.bench.plots\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'gpuacceleratedtracking_tpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
