"""PyTorch port, the GLONASS L1OF, Galileo E1 and BeiDou B1I families against
the JAX package: code tables, overlays and registry, the bank correlators on
each family's cells, routing, and closed loops.

Bank cells and tolerances are tests/test_glonass.py:104-180,
tests/test_galileo.py:126-175 and tests/test_beidou.py:157-203. The JAX
kernels run in Pallas interpret mode at N <= 8192 and K <= 4; at N = 32768
the port is held against the JAX `xla_bank` and a float64 numpy oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu.ops import registry as jregistry
from gpuacceleratedtracking_tpu.ops.pallas_epl import bank_algorithm_for as jax_route
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels, registry as tregistry

torch.set_num_threads(1)

FAMILIES = ("GLONASSL1", "GALILEOE1B", "GALILEOE1C", "BEIDOUB1I")


# --- code tables, overlays, registry -------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_code_table_is_bit_equal_to_jax(name):
    got, want = tmodels.get_system(name), jmodels.get_system(name)
    assert got.codes.dtype == want.codes.dtype == np.float32
    assert np.array_equal(got.codes, want.codes)
    assert set(np.unique(got.codes)) == {-1.0, 1.0}


def test_module_tables_and_overlays_are_bit_equal_to_jax():
    assert np.array_equal(tmodels.glonass_l1.code_table(), jmodels.glonass_l1.code_table())
    for pilot in (False, True):
        assert np.array_equal(tmodels.galileo_e1.code_table(pilot),
                              jmodels.galileo_e1.code_table(pilot))
    assert np.array_equal(tmodels.beidou_b1i.code_table(), jmodels.beidou_b1i.code_table())
    cs25, nh20 = tmodels.galileo_e1.secondary_code(), tmodels.beidou_b1i.secondary_code()
    assert cs25.dtype == nh20.dtype == np.float32
    assert np.array_equal(cs25, jmodels.galileo_e1.secondary_code())
    assert np.array_equal(nh20, jmodels.beidou_b1i.secondary_code())
    assert np.array_equal(nh20, tmodels.gpsl5.neuman_hofman(True))


def test_glonass_carrier_frequencies_are_bit_equal_to_jax():
    assert tmodels.glonass_l1.FREQUENCY_CHANNELS == jmodels.glonass_l1.FREQUENCY_CHANNELS
    for k in tmodels.glonass_l1.FREQUENCY_CHANNELS:
        assert tmodels.glonass_l1.carrier_frequency(k) == jmodels.glonass_l1.carrier_frequency(k)
    assert tmodels.glonass_l1.carrier_frequency(-7) == pytest.approx(1598.0625e6)
    with pytest.raises(ValueError):
        tmodels.glonass_l1.carrier_frequency(7)


@pytest.mark.parametrize("name", sorted(jmodels.GNSS_REGISTRY))
def test_registry_matches_jax(name):
    got, want = tmodels.get_system(name), jmodels.get_system(name)
    assert got.name == want.name
    assert (got.code_length, got.code_frequency, got.center_frequency, got.codes_per_ms) == (
        want.code_length, want.code_frequency, want.center_frequency, want.codes_per_ms)
    assert got.code_period() == want.code_period()
    if want.secondary_code is None:
        assert got.secondary_code is None
    else:
        assert np.array_equal(got.secondary_code, want.secondary_code)


def test_registry_names_and_overlay_options():
    assert set(tmodels.GNSS_REGISTRY) == set(jmodels.GNSS_REGISTRY)
    assert tmodels.GalileoE1().secondary_code is None
    assert tmodels.GalileoE1(pilot=True, with_secondary=False).secondary_code is None
    assert tmodels.BeiDouB1I(with_secondary=False).secondary_code is None
    assert tmodels.get_system("GALILEOE1C").code_period() == pytest.approx(4e-3)


def test_load_primary_codes_round_trips():
    # tests/test_galileo.py:66-83: 50 rows of 4092 bits, MSB first, hex.
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(50, 4092), dtype=np.uint8)
    rows = []
    for r in bits:
        padded = np.concatenate([r, np.zeros(4, np.uint8)])
        rows.append("".join(f"{int(''.join(map(str, padded[i:i + 4])), 2):x}"
                            for i in range(0, 4096, 4)))
    table = tmodels.galileo_e1.load_primary_codes(rows)
    assert table.shape == (8184, 50)
    np.testing.assert_array_equal(table[0::2], bits.T.astype(np.float32) * 2.0 - 1.0)
    np.testing.assert_array_equal(table[1::2], -table[0::2])
    assert np.array_equal(table, jmodels.galileo_e1.load_primary_codes(rows))
    with pytest.raises(ValueError, match="rows"):
        tmodels.galileo_e1.load_primary_codes(rows[:49])
    with pytest.raises(ValueError, match="bits per row"):
        tmodels.galileo_e1.load_primary_codes(["ff"] * 50)


# --- bank correlators -----------------------------------------------------


def _oracle(system, prn, fcar, fs, signal, shifts, code_phase=0.0, carrier_phase=0.0,
            code_frequency=None):
    """float64 correlation of one channel (tests/test_glonass.py's oracle,
    with a start code phase and carrier phase)."""
    fcode = system.code_frequency if code_frequency is None else code_frequency
    n = np.arange(signal.shape[-1], dtype=np.float64)
    carrier = np.exp(1j * (2 * np.pi * fcar / fs * n + carrier_phase))
    dw = np.asarray(signal).astype(np.complex128) * np.conj(carrier)
    out = []
    for d in shifts:
        idx = np.mod(np.floor(code_phase + fcode / fs * (n + d)).astype(np.int64),
                     system.code_length)
        out.append(np.sum(dw * system.codes[idx, prn].astype(np.float64)))
    return np.array(out)


def _shifts(system, fs):
    return tuple(int(s) for s in jmodels.correlator_sample_shifts(
        system, jmodels.EPLCorrelator(3), fs))


def _fdma_case(n, fcars):
    """tests/test_glonass.py's FDMA scenario: one shared code, K carriers."""
    system = jmodels.GLONASSL1()
    mixed = np.sum([np.asarray(jmodels.gen_signal(system, 0, f, n)[0]) for f in fcars], axis=0)
    k = len(fcars)
    z = np.zeros(k, np.float32)
    return dict(system="GLONASSL1", n=n, sre=mixed.real.astype(np.float32),
                sim=mixed.imag.astype(np.float32), prn=z.astype(np.int32),
                dop=np.asarray(fcars, np.float32), cph=z,
                cf=z + np.float32(system.code_frequency), coph=z)


def _random_case(name, n, k, seed, code_phases=None):
    """tests/test_galileo.py's and test_beidou.py's randomized channels on a
    PRN-0 signal at 1500 Hz; ``code_phases`` pins the channels' code phases."""
    system = jmodels.get_system(name)
    rng = np.random.default_rng(seed)
    signal, _ = jmodels.gen_signal(system, 0, 1500.0, n)
    dop = 1500.0 + rng.uniform(-3000, 3000, k)
    cph = rng.uniform(0, 2 * np.pi, k)
    coph = rng.uniform(0, system.code_length, k) if code_phases is None else code_phases
    return dict(system=name, n=n, sre=np.array(signal.real, np.float32),
                sim=np.array(signal.imag, np.float32),
                prn=np.arange(k, dtype=np.int32), dop=dop.astype(np.float32),
                cph=cph.astype(np.float32),
                cf=np.full(k, system.code_frequency, np.float32),
                coph=np.asarray(coph, np.float32))


# name -> (case constructor, JAX algorithms held against, rtol, atol, oracle?)
BANK_CELLS = {
    "glonass_fdma_n2048": (lambda: _fdma_case(2048, [1000.0, 3000.0, 5000.0, 7000.0]),
                           ("pallas_bank",), 1e-3, 1.0, True),
    "glonass_fdma_rows_n8192": (lambda: _fdma_case(8192, [-2000.0, 1000.0, 4000.0]),
                                ("pallas_bank_rows",), 1e-3, 1.5, True),
    # The 511-chip wrap: a 2048-sample block at 2.048 MHz covers 512 chips,
    # so a start phase >= 510 chips wraps the code twice.
    "glonass_wrap_n2048": (lambda: _random_case("GLONASSL1", 2048, 4, 21,
                                                [505.0, 508.25, 510.0, 510.9]),
                           ("pallas_bank", "xla_bank"), 2e-3, 4.5, True),
    "galileo_n8192": (lambda: _random_case("GALILEOE1B", 8192, 3, 4),
                      ("pallas_bank_auto", "xla_bank"), 2e-3, 9.0, False),
    "galileo_n32768": (lambda: _random_case("GALILEOE1B", 32768, 3, 4),
                       ("xla_bank",), 2e-3, 9.0, True),
    "beidou_n8192": (lambda: _random_case("BEIDOUB1I", 8192, 3, 11),
                     ("pallas_bank_auto", "xla_bank"), 2e-3, 6.0, False),
    "beidou_n32768": (lambda: _random_case("BEIDOUB1I", 32768, 3, 11),
                      ("xla_bank",), 2e-3, 6.0, True),
}


def _run_jax(algo, c):
    system = jmodels.get_system(c["system"])
    fs = c["n"] / 1e-3
    kw = {} if algo == "xla_bank" else {"nominal_code_frequency": system.code_frequency}
    fn = jax.jit(functools.partial(
        jregistry.get(algo), sample_shifts=_shifts(system, fs),
        code_length=system.code_length, sampling_frequency=fs, **kw))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]), jnp.asarray(system.codes),
                  jnp.asarray(c["prn"]), jnp.asarray(c["dop"]),
                  carrier_phase=jnp.asarray(c["cph"]), code_frequency=jnp.asarray(c["cf"]),
                  code_phase=jnp.asarray(c["coph"]))
    return np.asarray(are) + 1j * np.asarray(aim)


@pytest.fixture(scope="module")
def jax_bank():
    """Each cell's inputs and the JAX outputs per algorithm, computed once."""
    out = {}
    for name, (build, algos, *_rest) in BANK_CELLS.items():
        c = build()
        out[name] = (c, {algo: _run_jax(algo, c) for algo in algos})
    return out


@pytest.mark.parametrize("name", sorted(BANK_CELLS))
def test_bank_matches_jax_and_oracle(jax_bank, name):
    c, want = jax_bank[name]
    *_, rtol, atol, oracle = BANK_CELLS[name]
    system = tmodels.get_system(c["system"])
    fs = c["n"] / 1e-3
    t = torch.as_tensor
    are, aim = epl_kernels.correlate_pallas_bank_auto(
        t(c["sre"]), t(c["sim"]), t(system.codes), t(c["prn"]), t(c["dop"]), fs,
        t(c["cph"]), t(c["cf"]), t(c["coph"]), _shifts(system, fs), system.code_length,
        nominal_code_frequency=system.code_frequency)
    got = are.numpy() + 1j * aim.numpy()
    assert got.shape == (len(c["prn"]), 3)
    for algo, w in want.items():
        np.testing.assert_allclose(got.real, w.real, rtol=rtol, atol=atol, err_msg=algo)
        np.testing.assert_allclose(got.imag, w.imag, rtol=rtol, atol=atol, err_msg=algo)
    if oracle:
        for k in range(len(c["prn"])):
            w = _oracle(system, int(c["prn"][k]), float(c["dop"][k]), fs,
                        c["sre"] + 1j * c["sim"], _shifts(system, fs),
                        code_phase=float(c["coph"][k]), carrier_phase=float(c["cph"][k]),
                        code_frequency=float(c["cf"][k]))
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=f"oracle {k}")
    if name.startswith("glonass_fdma"):
        assert (got[:, 1].real > 0.9 * c["n"]).all()    # each FDMA channel at full power


# Route per cell: (system, N). GLONASS at 2.048 and 8.192 MHz, E1 and B1I at
# 8.192 MHz take the transition route, the rest the rows route.
ROUTE_CELLS = [(name, n) for name in FAMILIES for n in (2048, 8192, 16384, 32768)]


@pytest.mark.parametrize("name,n", ROUTE_CELLS)
def test_bank_algorithm_for_matches_jax(name, n):
    system = tmodels.get_system(name)
    got = epl_kernels.bank_algorithm_for(n, n / 1e-3, system.code_length, system.code_frequency)
    assert got == jax_route(n, n / 1e-3, system.code_length, system.code_frequency)
    if name.startswith("GALILEO") or name == "BEIDOUB1I":
        assert got == {8192: "pallas_bank", 32768: "pallas_bank_rows"}.get(n, got)


# --- closed loops ---------------------------------------------------------


def _loop_signal(name, n, num_ms, dops, overlay, seed):
    """tests/test_galileo.py's and test_beidou.py's two-satellite captures:
    satellite ``prn`` at ``dops[prn]``, code rate scaled with its Doppler;
    ``overlay``: "symbols" (E1-B nav, one random sign per 4 ms period), or
    "secondary" (the system's overlay)."""
    system = jmodels.get_system(name)
    rng = np.random.default_rng(seed)
    total = 0
    for prn, d in enumerate(dops):
        scale = 1.0 + d / system.center_frequency
        sc = (rng.choice([-1.0, 1.0], num_ms // 4 + 2) if overlay == "symbols"
              else system.secondary_code)
        s, _ = jmodels.gen_signal(system, prn, d, n * num_ms, duration=num_ms * 1e-3,
                                  code_frequency=system.code_frequency * scale,
                                  secondary_code=sc)
        total = total + np.asarray(s)
    return (np.ascontiguousarray(total.real.reshape(num_ms, n), np.float32),
            np.ascontiguousarray(total.imag.reshape(num_ms, n), np.float32))


# name -> (system, blocks, Dopplers, start error Hz, overlay, seed, extra
# config, |P| floor as a share of N, overlay length)
LOOPS = {
    "e1b_costas": ("GALILEOE1B", 200, [600.0, -900.0], 25.0, "symbols", 8, {}, 0.6, 0),
    "e1c_cs25": ("GALILEOE1C", 240, [800.0, -1400.0], 30.0, "secondary", 0,
                 {"pll_discriminator": "atan2"}, 0.7, 100),
    "b1i_d1_nh20": ("BEIDOUB1I", 240, [800.0, -1400.0], 30.0, "secondary", 0, {}, 0.7, 20),
}
LOOP_N = 8192
PARITY_BLOCKS = 20


@pytest.fixture(scope="module")
def jax_loops():
    """Each loop's blocks and the JAX `track_bank` under `xla_bank` over the
    first PARITY_BLOCKS of them."""
    out = {}
    for name, (gnss, blocks, dops, err, overlay, seed, extra, *_r) in LOOPS.items():
        sre, sim = _loop_signal(gnss, LOOP_N, blocks, dops, overlay, seed)
        system = jmodels.get_system(gnss)
        cfg = jtracking.TrackConfig.for_system(system, LOOP_N / 1e-3, LOOP_N,
                                               algorithm="xla_bank", **extra)
        st = jtracking.init_state(np.arange(len(dops)), carrier_doppler=np.array(dops) + err)
        _, ref = jtracking.track_bank(cfg, jnp.asarray(system.codes), st,
                                      jnp.asarray(sre[:PARITY_BLOCKS]),
                                      jnp.asarray(sim[:PARITY_BLOCKS]))
        out[name] = (sre, sim, jax.tree.map(np.asarray, ref))
    return out


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_closed_loop_converges_and_matches_jax(jax_loops, name):
    gnss, blocks, dops, err, _overlay, _seed, extra, floor, overlay_len = LOOPS[name]
    sre, sim, ref = jax_loops[name]
    system = tmodels.get_system(gnss)
    cfg = ttracking.TrackConfig.for_system(system, LOOP_N / 1e-3, LOOP_N,
                                           algorithm="pallas_bank_auto", **extra)
    assert len(cfg.secondary_code) == overlay_len
    assert epl_kernels.bank_algorithm_for(LOOP_N, LOOP_N / 1e-3, system.code_length,
                                          system.code_frequency) == "pallas_bank"
    states = ttracking.init_state(np.arange(len(dops)), carrier_doppler=np.array(dops) + err,
                                  device="cpu")
    _, out = ttracking.track_bank(cfg, torch.as_tensor(system.codes), states,
                                  torch.as_tensor(sre), torch.as_tensor(sim))
    # The JAX tests' convergence checks: final Doppler within 5 Hz, |P| floor.
    final = out.carrier_doppler[-20:].double().mean(0).numpy()
    np.testing.assert_allclose(final, dops, atol=5.0)
    p = torch.hypot(out.prompt_re[-20:], out.prompt_im[-20:]).numpy()
    assert (p > floor * LOOP_N).all(), p.min()
    # The first PARITY_BLOCKS blocks against the JAX xla_bank trajectory, both
    # channels locked: prompts within rtol 5e-3 + 20 (a few +/-2 chip flips
    # between the transition route and the per-sample bank, carried through
    # the loop), Doppler within 1e-3 relative + 1 Hz.
    for field in ("prompt_re", "prompt_im"):
        np.testing.assert_allclose(getattr(out, field)[:PARITY_BLOCKS].numpy(),
                                   getattr(ref, field), rtol=5e-3, atol=20.0, err_msg=field)
    np.testing.assert_allclose(out.carrier_doppler[:PARITY_BLOCKS].numpy(),
                               ref.carrier_doppler, rtol=1e-3, atol=1.0)


def test_fdma_bank_through_the_registry():
    # The per-channel carrier is the FDMA split: xla_bank on the port's
    # GLONASS table, each slot on its own carrier, prompt at full power.
    system = tmodels.GLONASSL1()
    c = _fdma_case(2048, [1000.0, 3000.0, 5000.0, 7000.0])
    fs = 2048 / 1e-3
    t = torch.as_tensor
    are, _ = tregistry.get("xla_bank")(
        t(c["sre"]), t(c["sim"]), t(system.codes), t(np.arange(4, dtype=np.int32)),
        t(c["dop"]), fs, t(c["cph"]), t(c["cf"]), t(c["coph"]), _shifts(system, fs),
        system.code_length)
    assert (are[:, 1] > 0.9 * 2048).all()
