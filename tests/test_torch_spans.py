"""PyTorch port, the call path's spans (`tracking.spans`) and `graphs.scan`'s
counters on the CPU, and the benchmark's readers of them.

A span records only while a profiler session does or inside
`spans.recording()`; off, a span site enters no record function. On, each
lands in the profiler's Chrome trace as a ``user_annotation`` event
and adds to its name's totals, whose self time leaves out its child spans'.
The captured path runs here with its capture swapped for a plain call of
the body, as in `test_torch_graph.py`.
"""

import json
import types

import numpy as np
import pytest
import torch

from benchmark import spec
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.tracking import graphs, spans

torch.set_num_threads(1)

BLOCKS = 7            # over two chunks of CHUNK_BLOCKS and a short tail
CHUNK_BLOCKS = 3
METRICS = spec.ROOT / "benchmark" / "metrics"
PHASES = {"call_self_ms.epoch20": None,
          "state_load_ms.epoch20": ("scan.load", "scan.prologue", "scan.next_chunk"),
          "replay_issue_ms.epoch20": ("scan.replay",),
          "result_copy_ms.epoch20": ("scan.collect", "scan.results")}


def _plain_capture(body, device):
    body()

    def replay():
        counts = graphs._counts()
        body()
        graphs._set_counts(counts)

    return replay


@pytest.fixture
def captured(monkeypatch):
    """`graphs.scan` takes its captured path on CPU tensors."""
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER)
    monkeypatch.setattr(graphs, "capture", _plain_capture)
    monkeypatch.setattr(graphs, "CHUNK", CHUNK_BLOCKS)
    graphs.clear()
    yield graphs._ENTRIES
    graphs.clear()


@pytest.fixture
def clean_spans():
    spans.reset()
    yield
    spans.reset()


def _bank_call(blocks=BLOCKS, k=4, n=2048, fs=2.048e6, algorithm="xla_bank"):
    """A K-channel GPS L1 `track_bank` call over ``blocks`` blocks of noise."""
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm=algorithm)
    gen = torch.Generator().manual_seed(0)
    sre, sim = (torch.randn((blocks, n), generator=gen) for _ in range(2))
    states = ttracking.init_state(np.arange(k) % 32, carrier_doppler=np.linspace(-500, 500, k),
                                  code_phase=np.linspace(0, 900, k), device="cpu", num_taps=3)
    codes = torch.as_tensor(system.codes)
    return lambda st=states: ttracking.track_bank(config, codes, st, sre, sim)


def _reader(metric):
    return spec.load_module(METRICS / f"{metric}.py", "metric")


def _traced():
    """A stand-in for a run whose traced sub-window was read."""
    return types.SimpleNamespace(reading=object())


def test_spans_off_record_nothing_and_enter_no_record_function(monkeypatch, clean_spans,
                                                                captured):
    def refuse(*args, **kwargs):
        raise AssertionError("a record function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    call = _bank_call()
    call()
    call()
    with graphs.eager():
        call()
    assert spans.span("track_bank") is spans.span("scan.load")      # the shared no-op
    assert spans.totals() == {}


def test_recording_nests_spans_and_takes_self_time(monkeypatch, clean_spans):
    entered, exited = [], []

    def enter(name, *args):
        entered.append(name)
        return len(entered)

    clock = iter(range(100))
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", enter)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_exit", exited.append)
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    with spans.recording():
        for _ in range(2):
            with spans.span("root"):              # 0 .. 9
                with spans.span("a"):             # 1 .. 4
                    with spans.span("b"):         # 2 .. 3
                        pass
                with spans.span("a"):             # 5 .. 6
                    pass
                with spans.span("c"):             # 7 .. 8
                    pass
    with spans.span("root"):                       # off again
        pass
    totals = spans.totals()
    assert totals["root"] == spans.Total(2, 18.0, 18.0 - 2 * (3 + 1 + 1))
    assert totals["a"] == spans.Total(4, 8.0, 8.0 - 2 * 1)
    assert totals["b"] == spans.Total(2, 2.0, 2.0)
    assert totals["c"] == spans.Total(2, 2.0, 2.0)
    assert entered == ["root", "a", "b", "a", "c"] * 2
    assert exited == [3, 2, 4, 5, 1, 8, 7, 9, 10, 6]           # each handle closed, innermost first
    spans.reset()
    assert spans.totals() == {}


def test_a_span_closes_when_its_body_raises(clean_spans):
    with spans.recording():
        with pytest.raises(ValueError):
            with spans.span("root"):
                with spans.span("inner"):
                    raise ValueError("a failing phase")
        with spans.span("next"):
            pass
    totals = spans.totals()
    assert totals["root"].count == totals["inner"].count == totals["next"].count == 1
    assert totals["next"].seconds == totals["next"].self_seconds      # a root of its own


def test_a_profiled_call_exports_its_root_and_phase_spans_nested(tmp_path, captured,
                                                                 clean_spans):
    call = _bank_call()
    state, _ = call()                                  # the capture
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(state)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (root,) = [e for e in events if e["name"] == "track_bank"]
    phases = [e for e in events if e["name"].startswith("scan.")]
    assert {e["name"] for e in phases} == {"scan.load", "scan.prologue", "scan.replay",
                                           "scan.next_chunk", "scan.collect", "scan.results"}
    for e in phases:
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"], e
    totals = spans.totals()
    assert totals["track_bank"].count == 1
    assert totals["track_bank"].self_seconds == pytest.approx(
        totals["track_bank"].seconds - sum(t.seconds for name, t in totals.items()
                                           if name.startswith("scan.")))


@pytest.mark.parametrize("blocks", [1, CHUNK_BLOCKS, BLOCKS])
def test_a_captured_call_spans_its_phases_and_the_readers_sum_to_the_root(captured,
                                                                          clean_spans, blocks):
    call = _bank_call(blocks)
    state, _ = call()                                  # the capture
    with spans.recording():
        first = spans.totals()
        call(state)
        call(state)
    assert first == {}
    totals = spans.totals()
    chunks = -(-blocks // CHUNK_BLOCKS)
    counts = {"track_bank": 2, "scan.load": 2, "scan.prologue": 2, "scan.replay": 2 * chunks,
              "scan.next_chunk": 2 * (chunks - 1), "scan.collect": 2 * chunks,
              "scan.results": 2}
    assert {name: t.count for name, t in totals.items()} == {
        name: count for name, count in counts.items() if count}
    root = totals["track_bank"]
    phases = sum(t.seconds for name, t in totals.items() if name != "track_bank")
    assert root.self_seconds == pytest.approx(root.seconds - phases)
    run = _traced()
    values = {metric: _reader(metric).read(run) for metric in PHASES}
    assert sum(values.values()) == pytest.approx(1e3 * root.seconds / root.count)
    assert values["call_self_ms.epoch20"] == pytest.approx(1e3 * root.self_seconds / 2)


def test_an_eager_call_records_its_root_span_alone(clean_spans):
    graphs.clear()
    with spans.recording():
        _bank_call()()
        with graphs.eager():
            _bank_call()()
    totals = spans.totals()
    assert list(totals) == ["track_bank"] and totals["track_bank"].count == 2
    assert totals["track_bank"].seconds == totals["track_bank"].self_seconds


@pytest.mark.parametrize("on", [False, True])
def test_spanned_calls_its_function_as_the_span(monkeypatch, clean_spans, on):
    entered = []

    def enter(name, *args):
        entered.append(name)
        return name

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", enter)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_exit", lambda handle: None)

    @spans.spanned("entry")
    def entry(a, b=1):
        """An entry point."""
        with spans.span("phase"):
            return a + b

    assert entry.__name__ == "entry" and entry.__doc__ == "An entry point."
    with spans.recording() if on else spans._OFF:
        assert entry(2, b=3) == 5
    assert entered == (["entry", "phase"] if on else [])
    totals = spans.totals()
    if on:
        assert (totals["entry"].count, totals["phase"].count) == (1, 1)
        assert totals["entry"].self_seconds == pytest.approx(
            totals["entry"].seconds - totals["phase"].seconds)
    else:
        assert totals == {}


def test_scan_counts_its_entries_and_one_replay_a_block(captured, monkeypatch):
    for name in ("captures", "evictions", "replays", "replayed_nodes"):
        monkeypatch.setattr(graphs.scan, name, 0)
    call = _bank_call()
    with graphs.uncounted():
        state, _ = call()
        call(state)
    (entry,) = captured[torch.device("cpu")].values()
    assert entry.nodes == 0                            # a stand-in replay is no CUDA graph
    assert (graphs.scan.captures, graphs.scan.replays) == (1, 2 * BLOCKS)
    monkeypatch.setattr(entry, "nodes", 5)
    call(state)
    assert graphs.scan.replays == 3 * BLOCKS
    assert graphs.scan.replayed_nodes == 5 * BLOCKS
    assert (graphs.scan.captures, graphs.scan.evictions) == (1, 0)


@pytest.mark.parametrize("store", ["_ENTRIES", "_KEPT"])
def test_cached_counts_the_captured_entries_made_and_dropped(monkeypatch, store):
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 1)
    monkeypatch.setattr(graphs, store, {})
    monkeypatch.setattr(graphs.scan, "captures", 0)
    monkeypatch.setattr(graphs.scan, "evictions", 0)
    cache = getattr(graphs, store)
    counted = store == "_ENTRIES"                      # `kept` values are no entries
    assert graphs._cached(cache, "card", "a", lambda: 1) == 1
    assert graphs._cached(cache, "card", "a", lambda: 2) == 1
    assert (graphs.scan.captures, graphs.scan.evictions) == (counted, 0)
    assert graphs._cached(cache, "card", "b", lambda: 3) == 3
    assert (graphs.scan.captures, graphs.scan.evictions) == (2 * counted, counted)
    assert list(cache["card"]) == ["b"]


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_each_span_reader_takes_its_phases_mean_per_call(monkeypatch, metric):
    totals = {"track_bank": spans.Total(4, 0.0100, 0.0020),
              "scan.load": spans.Total(4, 0.0030, 0.0030),
              "scan.prologue": spans.Total(4, 0.0004, 0.0004),
              "scan.next_chunk": spans.Total(0, 0.0, 0.0),
              "scan.replay": spans.Total(4, 0.0016, 0.0016),
              "scan.collect": spans.Total(4, 0.0022, 0.0022),
              "scan.results": spans.Total(4, 0.0008, 0.0008)}
    monkeypatch.setattr(spans, "totals", lambda: dict(totals))
    reader = _reader(metric)
    names = PHASES[metric]
    want = (0.0020 if names is None else sum(totals[n].seconds for n in names)) / 4 * 1e3
    assert reader.read(_traced()) == pytest.approx(want)
    assert reader.read(types.SimpleNamespace(reading=None)) is None    # no traced window
    monkeypatch.setattr(spans, "totals", lambda: {})
    assert reader.read(_traced()) is None                              # no spans recorded


def test_the_block_graph_nodes_reader_takes_nodes_per_replayed_block(monkeypatch):
    reader = _reader("block_graph_nodes")
    monkeypatch.setattr(graphs.scan, "replays", 0)
    monkeypatch.setattr(graphs.scan, "replayed_nodes", 0)
    assert reader.read(_traced()) is None                              # nothing replayed
    monkeypatch.setattr(graphs.scan, "replays", 40)
    monkeypatch.setattr(graphs.scan, "replayed_nodes", 160)
    assert reader.read(_traced()) == 4.0
    assert reader.read(types.SimpleNamespace(reading=None)) is None


def test_the_graph_captures_reader_takes_entries_made_and_dropped(monkeypatch):
    reader = _reader("graph_captures")
    monkeypatch.setattr(graphs.scan, "captures", 1)
    monkeypatch.setattr(graphs.scan, "evictions", 0)
    assert reader.read(_traced()) == 1                                  # a steady run
    monkeypatch.setattr(graphs.scan, "captures", 3)
    monkeypatch.setattr(graphs.scan, "evictions", 2)
    assert reader.read(_traced()) == 5
    assert reader.read(types.SimpleNamespace(reading=None)) is None
    monkeypatch.delattr(graphs.scan, "captures")                        # a program without it
    assert reader.read(_traced()) is None
