"""PyTorch port: the bank kernels' shared arithmetic against the forms it replaces.

The CUDA bank kernels (``csrc/bank_rows.cu``, ``csrc/bank_comp.cu``) compute
each sample's chip once into a replica row, build the carrier as the JAX
kernels' row x lane phasor product, and read bit-packed code columns. The
plain versions in `epl_kernels` and `bank_comp` do the same, and these tests
hold those pieces to the per-tap chips, the direct carrier of the JAX
``xla_bank`` arithmetic and the f32 code tables. Also here: the constructors
that default to the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu.ops import replica as jreplica
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
from gpuacceleratedtracking_tpu_torch.tracking import cn0 as tcn0
from gpuacceleratedtracking_tpu_torch.tracking import loop_filter as tlf

torch.set_num_threads(1)

SYSTEMS = {"gpsl1": tmodels.GPSL1(), "gpsl5": tmodels.GPSL5()}


def _bank(system, n, k, shifts, seed, carrier_spread=4000.0):
    """A prepared one-hot-route bank call (no envelope) on random channels,
    and its carrier frequencies and phases."""
    rng = np.random.default_rng(seed)
    f_car = rng.uniform(-carrier_spread, carrier_spread, k).astype(np.float32)
    phi_car = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
    zeros = torch.zeros(1, n)
    bank = epl_kernels.BankRowsCall(
        zeros, zeros, torch.as_tensor(system.codes),
        torch.as_tensor(rng.integers(0, system.codes.shape[1], k), dtype=torch.int32),
        torch.as_tensor(f_car), n / 1e-3, torch.as_tensor(phi_car),
        torch.as_tensor(system.code_frequency + rng.uniform(-5, 5, k), dtype=torch.float32),
        torch.as_tensor(rng.uniform(0, system.code_length, k), dtype=torch.float32),
        shifts, system.code_length, route="pallas_bank_onehot")
    return bank, f_car, phi_car


@pytest.mark.parametrize("shifts", [(-16, 0, 16), (-160, 0, 170), (-48, -32, -16, 0, 16, 32, 48),
                                    (-5, 0, 325)])
@pytest.mark.parametrize("gnss", sorted(SYSTEMS))
def test_replica_row_chips_equal_per_tap_chips(gnss, shifts):
    # The replica row evaluates floor(m * rho + frac) once per position m;
    # the kernels it replaces evaluated floor((j + delta_l) * rho + frac) per
    # tap. j + delta_l is an exact small integer in f32, so every chip agrees.
    system = SYSTEMS[gnss]
    bank, _, _ = _bank(system, 32768, 64, shifts, seed=len(shifts) + len(gnss))
    ph_car, pc_whole, pc_frac = epl_kernels._tile_phases(bank, 0, bank.num_k)
    rho = bank.params[:, 2]
    row = epl_kernels._replica_chips(rho, pc_whole, pc_frac, epl_kernels.TILE + bank.span,
                                     system.code_length)
    j = torch.arange(epl_kernels.TILE, dtype=torch.float32)
    for delta in bank.deltas:
        x = (j + float(delta)) * rho[:, None, None] + pc_frac[:, :, None]
        per_tap = torch.remainder(torch.floor(x).long() + pc_whole.long()[:, :, None],
                                  system.code_length)
        assert torch.equal(row[..., delta:delta + epl_kernels.TILE], per_tap)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("gnss", sorted(SYSTEMS))
def test_boundary_search_gives_the_per_position_chips(gnss, seed):
    # bank_rows.cu's boundary build (its plain version) against the
    # per-position formula, every kernel tile's row chip for chip: 1 ms
    # blocks from 4096 to 2^18 samples (a chip lasts under one sample to 256),
    # and channels at exactly 1/32 chip a sample whose code phases lie a
    # few f32 ulps either side of a chip boundary (one falls on sample 16 of
    # the first tile) and just below Lc.
    system = SYSTEMS[gnss]
    n = (4096, 8192, 32768, 65536, 1 << 18, 20000)[seed]
    shifts = ((-16, 0, 16), (-160, 0, 170), (-5, 0, 325))[seed % 3]
    bank, _, _ = _bank(system, n, 24, shifts, seed=100 + seed)
    f32, c = np.float32, np.float32(412)
    lc = f32(system.code_length)
    near = [np.nextafter(c, f32(0)), c, np.nextafter(c, f32(1e4)), c - 3 * np.spacing(c),
            c + 3 * np.spacing(c), np.nextafter(lc, f32(0)), lc - 4 * np.spacing(lc), f32(0)]
    bank.params[:8, 2] = 1 / 32
    bank.params[:8, 3] = torch.as_tensor(np.asarray(near, dtype=f32)) - 0.5
    _, pc_whole, pc_frac = epl_kernels._tile_phases(bank, 0, bank.num_k)
    rho = bank.params[:, 2]
    runs = epl_kernels._replica_chips_from_runs(rho, pc_whole, pc_frac, bank.span,
                                                system.code_length)
    row = epl_kernels._replica_chips(rho, pc_whole, pc_frac, epl_kernels.TILE + bank.span,
                                     system.code_length)
    width = epl_kernels.ROWS_TILE + bank.span
    assert runs.shape == (*row.shape[:2], epl_kernels.TILE // epl_kernels.ROWS_TILE, width)
    for r in range(runs.shape[2]):
        j0 = r * epl_kernels.ROWS_TILE
        assert torch.equal(runs[:, :, r], row[..., j0:j0 + width]), r


def _rows_call(system, fs, route, nominal=True):
    zeros = torch.zeros(1, 4096)
    one = torch.zeros(1)
    return epl_kernels.BankRowsCall(
        zeros, zeros, torch.as_tensor(system.codes), torch.zeros(1, dtype=torch.int32), one, fs,
        one, one + system.code_frequency, one, (-1, 0, 1), system.code_length,
        nominal_code_frequency=system.code_frequency if nominal else None, route=route)


@pytest.mark.parametrize("name,system,fs,route,boundary", [
    ("gpsl1_k1024 cell, 32 samples a chip", tmodels.GPSL1(), 32.768e6, "pallas_bank_rows", True),
    ("the paper's N=2^18, 256", tmodels.GPSL1(), 262.144e6, "pallas_bank_rows", True),
    ("the crossover", tmodels.GPSL1(), epl_kernels.MIN_CHIP_RUN * 1.023e6, "pallas_bank_rows",
     True),
    ("the rows route's top rate, ~6", tmodels.GPSL1(), 6.1e6, "pallas_bank_rows", False),
    ("GPS L1 at 4.092 MHz, transition", tmodels.GPSL1(), 4.092e6, "pallas_bank", False),
    ("GPS L5 at 32.768 MHz, transition", tmodels.GPSL5(), 32.768e6, "pallas_bank", False),
    ("the transition route's top rate", tmodels.GPSL5(), 10.26e6, "pallas_bank", False),
    ("one-hot, no nominal rate", tmodels.GPSL1(), 32.768e6, "pallas_bank_onehot", False),
])
def test_the_row_build_follows_the_samples_a_chip_lasts(name, system, fs, route, boundary):
    bank = _rows_call(system, fs, route, nominal=route != "pallas_bank_onehot")
    min_run = epl_kernels.rows_min_run(bank.rho_nom)
    assert min_run == (epl_kernels.MIN_CHIP_RUN if boundary else 0), name
    assert (min_run > 0) == (bank.rho_nom > 0 and 1 / bank.rho_nom >= epl_kernels.MIN_CHIP_RUN)


def test_a_replay_moves_the_row_build_counts_as_it_moves_the_launches(monkeypatch):
    # A stand-in capture (a plain call of the body): the body's launch at the
    # main path's rate counts one rows launch and one boundary build, which
    # `graphs.count_replays` adds per replayed block.
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    def stand_in(body, device):
        body()
        return body

    def launch():
        min_run = epl_kernels.rows_min_run(1.023e6 / 32.768e6)
        epl_kernels.correlate_pallas_bank_rows.launches += 1
        (epl_kernels.boundary_rows if min_run else epl_kernels.position_rows).launches += 1

    monkeypatch.setattr(graphs, "capture", stand_in)
    for counter in (epl_kernels.correlate_pallas_bank_rows, epl_kernels.boundary_rows,
                    epl_kernels.position_rows):
        monkeypatch.setattr(counter, "launches", 0)
    replay, launched = graphs.capture_counted(launch, torch.device("cpu"))
    assert (epl_kernels.boundary_rows.launches, epl_kernels.position_rows.launches) == (0, 0)
    graphs.count_replays(launched, 5)
    assert (epl_kernels.correlate_pallas_bank_rows.launches, epl_kernels.boundary_rows.launches,
            epl_kernels.position_rows.launches) == (5, 5, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_row_lane_carrier_matches_the_direct_carrier(seed):
    # N = 2^18 at 262.144 MHz, Dopplers within +/-5 kHz, against the JAX
    # xla_bank carrier (`replica.gen_carrier_replica`: a cos and a sin per
    # sample). Both keep f32 phases; the row x lane product adds a few ulp of
    # rounding per sample, and the two phase schemes (tile base + residual
    # vs row-wrapped cycles) part by up to ~2e-6 cycles at the block's end:
    # bound 5e-5 per component.
    n = 1 << 18
    bank, f_car, phi_car = _bank(tmodels.GPSL1(), n, 6, (-16, 0, 16), seed, carrier_spread=5000.0)
    ph_car, _, _ = epl_kernels._tile_phases(bank, 0, bank.num_k)
    cos, sin = epl_kernels._row_lane_carrier(bank.params[:, 0], ph_car)
    cos, sin = cos.reshape(bank.num_k, -1)[:, :n], sin.reshape(bank.num_k, -1)[:, :n]
    for k in range(bank.num_k):
        want_c, want_s = jreplica.gen_carrier_replica(float(f_car[k]), n / 1e-3,
                                                      float(phi_car[k]), n)
        np.testing.assert_allclose(cos[k].numpy(), np.asarray(want_c), rtol=0, atol=5e-5)
        np.testing.assert_allclose(sin[k].numpy(), np.asarray(want_s), rtol=0, atol=5e-5)
    np.testing.assert_allclose((cos ** 2 + sin ** 2).numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gnss", sorted(SYSTEMS))
def test_packed_code_columns_round_trip(gnss):
    system = SYSTEMS[gnss]
    codes = torch.as_tensor(system.codes)
    prn = torch.arange(codes.shape[1] - 1, -1, -1, dtype=torch.int32)
    packed = epl_kernels.prepare_bank_code_tiles_rows(codes, prn)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert packed.shape == (codes.shape[1], -(-system.code_length // 32))
    got = epl_kernels.unpack_code_columns(packed, system.code_length)
    assert torch.equal(got, codes.T[prn.long()])


def test_code_table_other_than_plus_minus_one_raises():
    codes = torch.as_tensor(tmodels.GPSL1().codes).clone()
    codes[17, 3] = 0.5
    epl_kernels.prepare_bank_code_tiles_rows(codes, torch.tensor([0, 1, 2]))
    with pytest.raises(ValueError, match=r"\+/-1"):
        epl_kernels.prepare_bank_code_tiles_rows(codes, torch.tensor([0, 3]))


def _constructors(device):
    system = tmodels.GPSL1()
    tree = jax.tree.map(np.asarray, jtracking.init_state(
        jnp.arange(3), carrier_doppler=jnp.array([1.0, 2.0, 3.0])))
    kw = {} if device is None else {"device": device}
    return {
        "gen_signal": lambda: tmodels.gen_signal(system, 0, 1500.0, 2048, **kw)[0],
        "gen_signal_mixed": lambda: tmodels.gen_signal_mixed(system, [0, 1], [100.0, -200.0],
                                                             2048, **kw)[0],
        "gen_carrier": lambda: tmodels.gen_carrier(2048, 1500.0, 2.048e6, 0.3, **kw),
        "init_state": lambda: ttracking.init_state(np.arange(3), carrier_doppler=250.0,
                                                   **kw).carrier_doppler,
        "state_from_numpy": lambda: ttracking.state_from_numpy(tree, **kw).carrier_doppler,
        "cn0.init": lambda: tcn0.init(20, **kw).prompts_re,
        "loop_filter.init": lambda: tlf.init(3.0, **kw).x1,
    }


CONSTRUCTORS = ["cn0.init", "gen_carrier", "gen_signal", "gen_signal_mixed", "init_state",
                "loop_filter.init", "state_from_numpy"]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructors_on_the_cpu_when_asked(name):
    # device="cpu" gives what the CPU default used to give: the JAX values.
    got = _constructors("cpu")[name]()
    assert got.device.type == "cpu"
    want = {
        "gen_signal": lambda: np.asarray(jmodels.gen_signal(jmodels.GPSL1(), 0, 1500.0, 2048)[0]),
        "gen_signal_mixed": lambda: np.asarray(jmodels.gen_signal_mixed(
            jmodels.GPSL1(), [0, 1], [100.0, -200.0], 2048)[0]),
        "gen_carrier": lambda: np.asarray(jmodels.gen_carrier(2048, 1500.0, 2.048e6, 0.3)),
        "init_state": lambda: np.full(3, 250.0, np.float32),
        "state_from_numpy": lambda: np.array([1.0, 2.0, 3.0], np.float32),
        "cn0.init": lambda: np.zeros(20, np.float32),
        "loop_filter.init": lambda: np.float32(3.0),
    }[name]()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructors_default_to_the_card(name):
    # Without a device argument they run on the card, and raise where there
    # is none: they never fall back to the CPU.
    make = _constructors(None)[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
