"""The yardstick's counts and peaks, and the whole-window end-to-end readers."""

import copy
import json
import statistics

import pytest
import tiny  # noqa: F401  (puts the checkout's root on the path)

from benchmark import spec, trace, yardstick
from benchmark.harness import Run

ROOT = tiny.ROOT


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_bank_correlation_counts_the_problem():
    flops, nbytes = yardstick.bank_correlation(config("gpsl1_k1024"))
    assert flops == 1024 * 1 * 32768 * (6 + 4 * 3) == 603_979_776      # 0.604 GFLOP
    # signal, the [1023, 37] f32 table, 5 NCO words a channel, [K, L] complex sums
    assert nbytes == 32768 * 8 + 1023 * 37 * 4 + 1024 * 20 + 1024 * 3 * 8
    flops4, _ = yardstick.bank_correlation(config("gpsl1_a4l7_k1024"))
    assert flops4 == 1024 * 4 * 32768 * (6 + 4 * 7) == 4_563_402_752    # 4.56 GFLOP


def test_loop_closure_counts_every_state_leaf_once_each_way():
    _, nbytes = yardstick.loop_closure(config("gpsl1_k1024"))
    state = 4 * (1 + 4 + 4 + 2 * 20 + 1 + 1 + 2 + 2 * 3)
    assert yardstick.state_bytes_per_channel(config("gpsl1_k1024")) == state
    assert nbytes == 1024 * (state + 24) + 1024 * (state - 4 + 24 + 9 * 4)


def test_least_time_takes_the_larger_bound_against_the_stated_peak():
    card = yardstick.peaks("NVIDIA H100 80GB HBM3")
    assert card["flops_per_s"]["tf32"] == 495e12 and card["bytes_per_s"] == 3.35e12
    assert yardstick.precision_key(config("gpsl1_k1024")) == "tf32"
    seconds, bound = yardstick.least_seconds(*yardstick.bank_correlation(config("gpsl1_k1024")),
                                             card, "tf32")
    assert bound == "operations" and seconds == pytest.approx(603_979_776 / 495e12)
    seconds, bound = yardstick.least_seconds(*yardstick.loop_closure(config("gpsl1_k1024")),
                                             card, "tf32")
    assert bound == "bytes"
    assert yardstick.peaks("a card the table lacks") is None


def fake_run(cell_name, window_s, calls, blocks, kernels=None, reading_window=None,
             epoch_s=None, cell=None, cards=1):
    cell = spec.load_cell(cell_name) if cell is None else cell
    reading = None
    if kernels is not None:
        reading = trace.Reading(reading_window, reading_window / 2, kernels, [], blocks,
                                {c: reading_window / 2 for c in range(cards)})
    epoch_s = (window_s / calls,) * calls if epoch_s is None else tuple(epoch_s)
    return Run(cell, yardstick.peaks("NVIDIA H100 80GB HBM3"), 9.5,
               window_s, calls, blocks, 0.25 * window_s, epoch_s, reading)


def test_roofline_reads_the_kernels_by_name_against_the_blocks_traced():
    cell = "gpsl1_k1024.epoch20"
    per_block = 0.067e-3
    run = fake_run(cell, 10.0, 100, 2000,
                   {"void (anonymous namespace)::bank_rows_kernel<1, 3>(float const*)":
                    per_block * 2000, "(anonymous namespace)::bank_rows_finish(float const*)":
                    0.0, "loop_update_kernel": 1.0}, 1.0)
    reader = spec.load_module(ROOT / "benchmark" / "metrics" / "bank_rows_roofline.py", "metric")
    want = 100 * (603_979_776 / 495e12) / per_block
    assert reader.read(run) == pytest.approx(want)
    assert 1.7 < want < 1.9
    empty = fake_run(cell, 10.0, 100, 2000, {"loop_update_kernel": 1.0}, 1.0)
    assert reader.read(empty) is None                   # nothing to read: no value, never 0
    assert reader.read(fake_run(cell, 10.0, 100, 2000)) is None


def test_a_four_card_cell_reads_one_cards_share_and_the_peak_of_all_four():
    # gpsl1_k1024 cut over four cards at ten times its channels, 10240 a card:
    # each card's kernel takes 0.6 ms a block, and its time summed over the
    # cards against the whole bank's work at one card's peak is the share
    # each card's own kernel reads.
    base = spec.load_cell("gpsl1_k1024.epoch20")
    config = copy.deepcopy(base.config)
    config["bank"]["channels"] = 40960
    config["mesh"] = {"chan": 4, "time": 1}
    cell = base._replace(name="four_cards", chips=4, config=config)
    per_card_block = 0.6e-3
    run = fake_run(None, 10.0, 100, 2000,
                   {"bank_rows_kernel<1, 3>": 4 * per_card_block * 2000,
                    "Memcpy PtoP (Device -> Device)": 2e-3,
                    "Memcpy DtoH (Device -> Pinned)": 1.0}, 1.5, cell=cell, cards=4)
    metrics = ROOT / "benchmark" / "metrics"
    rows = spec.load_module(metrics / "bank_rows_roofline.py", "metric")
    one_card = 100 * (10240 / 1024) * (603_979_776 / 495e12) / per_card_block
    assert rows.read(run) == pytest.approx(one_card)
    mfu = spec.load_module(metrics / "step_mfu.py", "metric")
    flops = 40 * 603_979_776 * 2000
    assert mfu.read(run) == pytest.approx(100 * flops / (1.5 * 4 * 495e12))


def test_rates_take_all_the_work_over_all_the_time_so_a_stall_shows():
    # 500 epochs of 2 ms, one of which stalls for 1 s: a median of 10-epoch
    # chunks does not move, the whole window's rate does.
    epochs = [2e-3] * 500
    stalled = list(epochs)
    stalled[250] += 1.0
    chunk = lambda xs: statistics.median(sum(xs[i:i + 10]) for i in range(0, len(xs), 10))  # noqa: E731
    assert chunk(epochs) == pytest.approx(chunk(stalled))
    metrics = ROOT / "benchmark" / "metrics"
    rate = spec.load_module(metrics / "realtime_channels.py", "metric")
    steady = fake_run("gpsl1_k1024.epoch20", sum(epochs), 500, 500 * 20)
    stall = fake_run("gpsl1_k1024.epoch20", sum(stalled), 500, 500 * 20)
    assert rate.read(steady) == pytest.approx(1024 * 20 * 1e-3 / 2e-3)
    assert rate.read(stall) == pytest.approx(1024 * 10000 * 1e-3 / 2.0)
    assert rate.read(steady) / rate.read(stall) == pytest.approx(2.0)


def test_the_epoch_tail_is_the_percentile_of_every_epoch_so_a_stall_shows():
    # 500 epochs of 2 ms, of which 40 in a row (8 %) take 10 ms: the median
    # of 10-epoch chunks does not move, the 95th percentile of every epoch
    # does.
    epochs = [2e-3] * 500
    stalled = [10e-3 if 200 <= i < 240 else 2e-3 for i in range(500)]
    chunk = lambda xs: statistics.median(sum(xs[i:i + 10]) for i in range(0, len(xs), 10))  # noqa: E731
    assert chunk(epochs) == pytest.approx(chunk(stalled))
    tail = spec.load_module(ROOT / "benchmark" / "metrics" / "epoch_p95_ms.py", "metric")
    cell = "gpsl1_k1024.epoch20"
    assert tail.read(fake_run(cell, sum(epochs), 500, 10000, epoch_s=epochs)) == pytest.approx(2.0)
    assert tail.read(fake_run(cell, sum(stalled), 500, 10000, epoch_s=stalled)) == \
        pytest.approx(10.0)
    # The inclusive 95th percentile of 1..100 ms: 95.05 ms.
    ramp = [i * 1e-3 for i in range(1, 101)]
    assert tail.read(fake_run(cell, sum(ramp), 100, 2000, epoch_s=ramp)) == pytest.approx(95.05)
