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
from gpuacceleratedtracking_tpu_torch.ops import bank_comp

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


# --- The dual bank.

def test_dual_bank_sharded_matches_jax():
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
    final, out = tparallel.track_bank_dual_sharded(
        tcfg, codes_i, codes_q, tstates, _t(sre), _t(sim),
        mesh=tparallel.channel_time_mesh(4, 1, devices=CPUS))
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
