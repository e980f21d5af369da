"""The check that decides ``correct``, on the CPU at a tiny size: the
program's CPU path against the plain reference, the control (the reference
one precision step below f32 in the program's place) and the faults a cell
can have, each planted underneath the timed path, all read as not correct.

`tiny.MESH_CELL` runs the program on a mesh of four repeated CPU devices,
which `track_bank_sharded` takes down its one-device branch (`graphs.scan`):
these tests cover the mesh program's entry and its results, not the
staging, `graphs.scan_mesh` and the join of distinct cards, which the
`cuda` test of a four-card cell in `test_benchmark_card.py` covers."""

import importlib

import numpy as np
import pytest
import tiny
import torch

from benchmark import capture, gold, harness
from gpuacceleratedtracking_tpu_torch.ops import bank_comp, epl_kernels

# The module, not the function of that name that `tracking` exports.
port_track = importlib.import_module("gpuacceleratedtracking_tpu_torch.tracking.track")

MESH_CELL = tiny.MESH_CELL                   # off the card: a mesh of four repeated CPUs
CELLS = ["gpsl1_k1024.epoch20", "gpsl1_a4l7_k1024.epoch20", MESH_CELL]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_the_programs_cpu_path_agrees_with_the_reference(root, cell):
    result = tiny.run(root, cell)
    checks = result["checks"]
    assert result["correct"] and result["failed"] == 0, checks
    assert result["device"]["count"] == tiny.spec.load_cell(cell, root).chips
    assert checks["loop_gap"]["value"] == 0.0          # the same ops on the same device
    assert checks["accum_gap"]["value"] < 1e-5
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    spec_cell = tiny.spec.load_cell(cell, root)
    ref = spec_cell.reference
    table = torch.from_numpy(gold.code_table())
    control = ref.track_bank_control(ref.LoopConfig.from_fields(spec_cell.config["track"]),
                                     table)
    result = tiny.run(root, cell, program=control)
    checks = result["checks"]
    assert not result["correct"]
    # The bfloat16 loop fails the loop's number; the TF32 correlator reads far
    # over the program (its limit is set from readings at the cell's size).
    assert checks["loop_gap"]["value"] > 3 * checks["loop_gap"]["limit"]
    program = tiny.run(root, cell)["checks"]
    assert checks["accum_gap"]["value"] > 30 * program["accum_gap"]["value"]


def unchanged_state(config, codes, states, sre, sim, weights=None):
    """A step that returns its state unchanged."""
    _, out = port_track.track_bank(config, codes, states, sre, sim, weights)
    return states, out


def half_the_bank(plain):
    """Half of the channels left out, the mean of the rest in their place."""
    def broken(bank):
        acc_re, acc_im = plain(bank)
        half = acc_re.shape[0] // 2
        for acc in (acc_re, acc_im):
            acc[half:] = acc[:half].mean(dim=0, keepdim=True)
        return acc_re, acc_im

    return broken


def altered_answer(plain):
    """One channel's accumulators altered where they are produced."""
    def broken(bank):
        acc_re, acc_im = plain(bank)
        acc_re[1] = -acc_re[1]
        return acc_re, acc_im

    return broken


def altered_loop_output(plain):
    """One channel's carrier Doppler altered where the loop closure produces it (the
    last of the channels it closes: a shard's on a mesh)."""
    def broken(*args, **kwargs):
        state, out = plain(*args, **kwargs)
        doppler = out.carrier_doppler.clone()
        doppler[-1] += 1.0
        return state, out._replace(carrier_doppler=doppler)

    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_bank", "altered_answer",
                                   "altered_loop_output"])
def test_each_fault_reads_not_correct(root, cell, fault, monkeypatch):
    program = None
    if fault == "unchanged_state":
        program = unchanged_state
    elif fault == "altered_loop_output":
        monkeypatch.setattr(port_track, "loop_update_plain",
                            altered_loop_output(port_track.loop_update_plain))
    else:
        make = half_the_bank if fault == "half_the_bank" else altered_answer
        monkeypatch.setattr(epl_kernels, "_bank_rows_plain", make(epl_kernels._bank_rows_plain))
        monkeypatch.setattr(bank_comp, "_bank_comp_plain", make(bank_comp._bank_comp_plain))
    result = tiny.run(root, cell, program=program)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_the_mesh_program_is_the_sharded_bank_and_gives_track_banks_results_bit_for_bit(root):
    cell = tiny.spec.load_cell(MESH_CELL, root)
    cpu = torch.device("cpu")
    assert harness.cards(cell, cpu) == [cpu] * 4
    sharded, config, _ = harness.port_program(cell, cpu)
    assert sharded is not port_track.track_bank
    table = torch.from_numpy(gold.code_table())
    scenario = capture.draw_scenario(cell.config, cell.traffic, tiny.SEED)
    sre, sim = capture.synthesise(cell.config, cell.traffic, scenario, table, tiny.SEED, cpu)
    states = harness.port_state(capture.initial_state(cell.config, scenario), cpu)
    per_call = cell.traffic["blocks_per_call"]
    got = want = (states, None)
    for b0 in range(0, sre.shape[0], per_call):        # two chained calls
        got = sharded(config, table, got[0], sre[b0:b0 + per_call], sim[b0:b0 + per_call])
        want = port_track.track_bank(config, table, want[0], sre[b0:b0 + per_call],
                                     sim[b0:b0 + per_call])
        got_leaves, want_leaves = harness.flatten(got, []), harness.flatten(want, [])
        assert harness.leaf_names(*got) == harness.leaf_names(*want)
        assert all(torch.equal(g, w) for g, w in zip(got_leaves, want_leaves))
    with pytest.raises(ValueError, match="steering weights"):
        sharded(config, table, states, sre[:per_call], sim[:per_call],
                (torch.ones(1), torch.zeros(1)))


def test_the_gold_codes_match_is_gps_200():
    # IS-GPS-200 Table 3-Ia, the first 10 chips in octal.
    published = {1: 1440, 2: 1620, 3: 1710, 10: 1504, 19: 1633, 32: 1712, 37: 1713}
    assert {p: gold.first_chips_octal(p) for p in published} == published
    table = gold.code_table()
    assert table.shape == (1023, 37) and set(np.unique(table)) == {-1.0, 1.0}
    # Gold codes: nearly balanced (512 ones, 511 zeros).
    assert np.all(table.sum(axis=0) == 1.0)


def test_the_capture_is_the_seeds_and_every_seed_draws_the_same_work(root):
    cell = tiny.spec.load_cell("gpsl1_a4l7_k1024.epoch20", root)
    table = torch.from_numpy(gold.code_table())
    a = capture.draw_scenario(cell.config, cell.traffic, tiny.SEED)
    b = capture.draw_scenario(cell.config, cell.traffic, tiny.SEED)
    c = capture.draw_scenario(cell.config, cell.traffic, tiny.SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a.dopplers, c.dopplers)
    assert len(set(a.prns)) == len(a.prns) == cell.traffic["satellites"]
    sig_a = capture.synthesise(cell.config, cell.traffic, a, table, tiny.SEED, "cpu")
    sig_b = capture.synthesise(cell.config, cell.traffic, b, table, tiny.SEED, "cpu")
    assert sig_a[0].shape == (8, 4, 8192)
    assert torch.equal(sig_a[0], sig_b[0]) and torch.equal(sig_a[1], sig_b[1])
    state = capture.initial_state(cell.config, a)
    for s, prn in enumerate(a.prns):
        assert abs(state.carrier_doppler[prn] - a.dopplers[s]) <= 20.0


def live_channels(config, scenario, state):
    """The channels whose set-up Doppler is not the bank's even spread."""
    bank = config["bank"]
    spread = np.linspace(-bank["doppler_span_hz"], bank["doppler_span_hz"],
                         bank["channels"]).astype(np.float32)
    return np.flatnonzero(state.carrier_doppler != spread).tolist()


def full_size(name):
    cell = tiny.spec.load_cell(name)
    return cell.config, cell.traffic


@pytest.mark.parametrize("cell", ["gpsl1_k1024.epoch20", "gpsl1_a4l7_k1024.epoch20"])
@pytest.mark.parametrize("seed", [tiny.SEED, 7, 2**33 + 5])
def test_without_a_mesh_the_set_up_states_are_the_old_rules_bit_for_bit(cell, seed):
    config, traffic = full_size(cell)
    scenario = capture.draw_scenario(config, traffic, seed)
    state = capture.initial_state(config, scenario)
    num_k = config["bank"]["channels"]
    dops = np.linspace(-config["bank"]["doppler_span_hz"], config["bank"]["doppler_span_hz"],
                       num_k)
    phases = np.zeros(num_k)
    for s, k in enumerate(int(prn) for prn in scenario.prns):    # the old rule: k = PRN
        dops[k] = scenario.dopplers[s] + scenario.doppler_errors[s]
        phases[k] = (scenario.code_phases[s] + scenario.code_errors[s]) % 1023
    assert np.array_equal(state.carrier_doppler, dops.astype(np.float32))
    assert np.array_equal(state.pll_filter.x1, dops.astype(np.float32))
    assert np.array_equal(state.code_phase, phases.astype(np.float32))
    assert np.array_equal(state.prn, (np.arange(num_k) % config["bank"]["prn_cycle"]))
    for leaf in harness.flatten(capture.to_torch(state, "cpu"), []):
        assert leaf.shape[0] == num_k


@pytest.mark.parametrize("seed", [tiny.SEED, 7, 2**33 + 5, 11])
def test_on_a_mesh_of_four_every_shard_holds_live_channels_of_their_satellites_prns(seed):
    config, traffic = full_size("gpsl1_n262k_k2048_4card.epoch20")
    chan = config["mesh"]["chan"]
    per = config["bank"]["channels"] // chan
    scenario = capture.draw_scenario(config, traffic, seed)
    state = capture.initial_state(config, scenario)
    live = live_channels(config, scenario, state)
    assert len(live) == traffic["satellites"] == 8
    assert sorted({k // per for k in live}) == list(range(chan))
    assert [sum(k // per == c for k in live) for c in range(chan)] == [2] * chan
    for s, prn in enumerate(scenario.prns):
        k = (s % chan) * per + int(prn)
        assert k in live and state.prn[k] == prn
        assert abs(state.carrier_doppler[k] - scenario.dopplers[s]) <= 20.0


@pytest.mark.parametrize("channels", [
    2050,                       # K not divisible into 4 shards
    2064,                       # a shard of 516 holds no whole PRN cycles of 32
    64,                         # a shard of 16 has no channel of PRNs 16 to 31
])
def test_a_shard_that_cannot_hold_a_prns_channel_raises(channels):
    config, traffic = full_size("gpsl1_n262k_k2048_4card.epoch20")
    config = dict(config, bank=dict(config["bank"], channels=channels))
    scenario = capture.draw_scenario(config, traffic, tiny.SEED)
    with pytest.raises(ValueError, match="whole PRN cycles"):
        capture.initial_state(config, scenario)


def test_many_ambiguous_samples_are_read_by_their_box_which_bounds_the_search_below():
    ref = tiny.spec.load_module(tiny.ROOT / "benchmark" / "reference" / "bank_epl.py",
                                "reference")
    gen = torch.Generator().manual_seed(3)
    groups, m = 64, 10
    rows = torch.randn(groups, m, 2, generator=gen, dtype=torch.float64) * 2.0
    picks = torch.rand(groups, m, generator=gen) < 0.3
    inside = (rows * picks[..., None]).sum(1) + 1e-3 * torch.randn(groups, 2, generator=gen,
                                                                  dtype=torch.float64)
    outside = inside + 100.0
    for target in (inside, outside):
        box, best = ref._box_gap(target, rows), ref._best_subset(target, rows)
        assert bool((box <= best + 1e-12).all())
    assert float(ref._best_subset(inside, rows).max()) < 1e-2
    assert float(ref._box_gap(inside, rows).max()) == 0.0
    far = ref._box_gap(outside, rows)
    reach = rows.clamp(min=0.0).sum(1)
    assert torch.allclose(far, (outside - reach).amax(-1))
    # explained_gap searches up to SEARCH_FLIPS flips of an accumulator and
    # reads the box above
    flips = ref.Flips(channel=torch.zeros(m, dtype=torch.int64),
                      tap=torch.zeros(m, dtype=torch.int64),
                      delta_re=rows[0, :, :1], delta_im=rows[0, :, 1:])
    want = (torch.zeros(1, 1, dtype=torch.float64), torch.zeros(1, 1, dtype=torch.float64))
    got = (outside[:1, :1] - 100.0 + 3.0, outside[:1, 1:] - 100.0 + 3.0)
    searched = ref.explained_gap(got, want, flips)
    assert ref.SEARCH_FLIPS >= 20 and m <= ref.SEARCH_FLIPS
    assert float(searched) == pytest.approx(float(ref._best_subset(
        torch.cat(got, 1), rows[:1])))
    boxed = ref._box_gap(torch.cat(got, 1), rows[:1])
    old, ref.SEARCH_FLIPS = ref.SEARCH_FLIPS, m - 1
    try:
        assert float(ref.explained_gap(got, want, flips)) == pytest.approx(float(boxed))
    finally:
        ref.SEARCH_FLIPS = old


def test_a_sample_at_a_chip_boundary_counts_on_either_side_and_no_other():
    ref = tiny.spec.load_module(tiny.ROOT / "benchmark" / "reference" / "bank_epl.py",
                                "reference")
    cfg = ref.LoopConfig(code_frequency=1.023e6, code_length=1023,
                         center_frequency=1575.42e6, sampling_frequency=8.192e6,
                         num_samples=8192, sample_shifts=(-4, 0, 4))
    gen = torch.Generator().manual_seed(5)
    k = 16
    state = ref.TrackState(
        prn=torch.arange(k) % 8, carrier_doppler=torch.rand(k, generator=gen) * 8e3 - 4e3,
        carrier_phase=torch.rand(k, generator=gen) * 6.0,
        code_doppler=torch.rand(k, generator=gen) * 6 - 3,
        code_phase=torch.rand(k, generator=gen) * 1023, pll_filter=None, dll_filter=None,
        cn0=None, ms_elapsed=None, prev_prompt_re=None, prev_prompt_im=None, coh_re=None,
        coh_im=None)
    sre, sim = torch.randn(2, 8192, generator=gen)
    table = torch.from_numpy(gold.code_table())
    acc_re, acc_im, flips = ref.correlate(cfg, table, state, sre, sim, ambiguous=5e-4)
    assert 5e-4 > ref.ambiguous_chips(cfg) and len(flips.channel) > 0
    row = len(flips.channel) // 2
    ch, tap = int(flips.channel[row]), int(flips.tap[row])
    alone = ref.Flips(*(x[row:row + 1] for x in flips))
    for share, candidates in ((1.0, flips), (1.0, alone), (0.5, alone)):
        got_re, got_im = acc_re.clone(), acc_im.clone()
        got_re[ch, tap] += share * flips.delta_re[row, 0]
        got_im[ch, tap] += share * flips.delta_im[row, 0]
        gap = ref.explained_gap((got_re, got_im), (acc_re, acc_im), candidates)
        if share == 1.0:
            assert float(gap.max()) < 1e-9 * float(acc_re.abs().max())
        else:
            half = 0.5 * max(abs(float(flips.delta_re[row, 0])),
                             abs(float(flips.delta_im[row, 0])))
            assert float(gap[ch, tap]) == pytest.approx(half) and half > 0.1
