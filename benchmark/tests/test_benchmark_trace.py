"""The trace's arithmetic on a synthetic Chrome trace: the traced wall span,
the device's busy union and idle share, kernel time by name, the idle gaps
with the host work in them, and the guard against a session that lost its
first device events."""

import pytest
import tiny  # noqa: F401

from benchmark import spec, trace


def X(name, cat, ts, dur, card=None):
    event = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if card is not None:
        event.update(pid=card, args={"device": card})
    return event


def session(lost_first=False):
    events = [
        X("spin_kernel", "kernel", 0.0, 100.0),
        X("spin_kernel", "kernel", 100.0, 100.0),
        X(trace.WINDOW, "user_annotation", 300.0, 1000.0),
        X("track_bank", "cpu_op", 310.0, 80.0),
        X("cudaGraphLaunch", "cuda_runtime", 320.0, 10.0),
        X("bank_rows_kernel<1, 3>", "kernel", 400.0, 300.0),
        X("loop_update_kernel", "kernel", 650.0, 100.0),    # overlaps the bank kernel
        X("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 900.0, 100.0),
        X("aten::copy_", "cpu_op", 760.0, 130.0),
        X("cudaDeviceSynchronize", "cuda_runtime", 1000.0, 250.0),
        X("spin_kernel", "kernel", 1400.0, 100.0),
    ]
    if lost_first:
        events = [e for e in events if not (e["name"] == "spin_kernel" and e["ts"] < 300)]
    return {"traceEvents": events}


def test_idle_share_is_taken_over_the_traced_wall_span():
    device, hosts, window = trace.read_events(session())
    assert window == (300.0, 1300.0)
    assert trace.live(device)
    reading = trace.reduce(device, hosts, window, blocks=40)
    # busy: [400, 750] and [900, 1000]; the span before the first launch and
    # after the last copy is idle, as a first-to-last window would not count it
    assert reading.window_s == pytest.approx(1000e-6)
    assert reading.busy_s == pytest.approx(450e-6)
    assert reading.busy_by_card == {0: pytest.approx(450e-6)}
    assert reading.kernel_seconds(r"bank_rows_") == pytest.approx(300e-6)
    assert reading.kernel_seconds(r"spin") == 0.0            # the markers are left out
    gaps = [(round(s * 1e6), names) for s, names in reading.gaps]
    assert [g for g, _ in gaps] == [300, 150, 100]
    assert gaps[0][1][0] == "cudaDeviceSynchronize"            # [1000, 1300)
    assert gaps[1][1][0] == "aten::copy_"                      # [750, 900)
    idle = spec.load_module(tiny.ROOT / "benchmark" / "metrics" / "device_idle_pct.epoch20.py",
                            "metric")

    class Run:
        pass

    run = Run()
    run.reading = reading
    assert idle.read(run) == pytest.approx(55.0)
    parts = trace.breakdown(reading)
    assert parts["device_ops"][0] == ["bank_rows_kernel<1, 3>", pytest.approx(300e-6)]
    assert len(parts["idle_gaps"]) == 3 and len(parts["device_ops"]) == 3


def two_cards(lost_second=False):
    """A session on cards 0 and 1: card 1 busy [400, 500] and [600, 1000],
    a peer-to-peer copy on each card."""
    events = [X("spin_kernel", "kernel", ts, 100.0, card)
              for card in (0, 1) for ts in (0.0, 100.0, 1400.0)]
    events += [
        X(trace.WINDOW, "user_annotation", 300.0, 1000.0),
        X("cudaDeviceSynchronize", "cuda_runtime", 1000.0, 250.0),
        X("bank_rows_kernel<1, 3>", "kernel", 400.0, 300.0, 0),
        X("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 900.0, 100.0, 0),
        X("bank_rows_kernel<1, 3>", "kernel", 400.0, 100.0, 1),
        X("loop_update_kernel", "kernel", 600.0, 300.0, 1),
        X("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 850.0, 150.0, 1),
    ]
    if lost_second:
        events = [e for e in events if not (e["name"] == "spin_kernel" and e["ts"] < 300
                                             and e["pid"] == 1)]
    return {"traceEvents": events}


def test_each_card_is_read_on_its_own_and_the_busy_time_averaged_over_the_cards():
    device, hosts, window = trace.read_events(two_cards())
    assert {card for *_, card in device} == {0, 1}
    assert trace.live(device, (0, 1))
    reading = trace.reduce(device, hosts, window, blocks=40, cards=(0, 1))
    assert reading.busy_by_card == {0: pytest.approx(400e-6), 1: pytest.approx(500e-6)}
    assert reading.busy_s == pytest.approx(450e-6)          # the mean over the two cards
    assert reading.kernel_seconds(r"bank_rows_") == pytest.approx(400e-6)   # summed
    assert reading.kernel_seconds(r"^Memcpy PtoP") == pytest.approx(250e-6)
    # the idle gaps are the first card's: [300, 400), [700, 900), [1000, 1300)
    assert sorted(round(s * 1e6) for s, _ in reading.gaps) == [100, 200, 300]
    # a card whose opening spins were lost makes the session not live, on
    # that card alone
    device, _, _ = trace.read_events(two_cards(lost_second=True))
    assert trace.live(device, (0,)) and not trace.live(device, (0, 1))


def test_the_card_of_an_event_is_its_device_else_its_pid():
    assert trace.card_of({"args": {"device": 3}, "pid": 1}) == 3
    assert trace.card_of({"pid": 2}) == 2
    assert trace.card_of({}) == 0


def test_a_session_that_lost_its_opening_events_is_not_live():
    device, _, _ = trace.read_events(session(lost_first=True))
    assert not trace.live(device)


def test_union_merges_overlaps():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]


def test_peer_copies_are_summed_over_the_cards_and_read_per_traced_call():
    reader = spec.load_module(tiny.ROOT / "benchmark" / "metrics" / "peer_copy_ms.epoch20.py",
                              "metric")
    cell = spec.load_cell("gpsl1_n262k_k2048_4card.epoch20")

    class Run:
        pass

    run = Run()
    run.cell = cell
    device, hosts, window = trace.read_events(two_cards())
    # 40 blocks are two calls of 20; card 0 copied 100 us, card 1 150 us
    run.reading = trace.reduce(device, hosts, window, blocks=40, cards=(0, 1))
    assert reader.read(run) == pytest.approx(1e3 * 250e-6 / 2)
    # two cards with no peer copy, one card, no trace: nothing to read
    run.reading = trace.reduce([e for e in device if "PtoP" not in e[2]], hosts, window,
                               blocks=40, cards=(0, 1))
    assert reader.read(run) is None
    device, hosts, window = trace.read_events(session())
    run.reading = trace.reduce(device, hosts, window, blocks=40)
    assert reader.read(run) is None
    run.reading = None
    assert reader.read(run) is None
