"""Every cell through the command on the card, briefly: it prints one result
line, ``correct`` true, the metrics its mode asks for, and the numbers
compared as the last lines of standard error. A tiny four-card cell reads
the fullest card's peak, and a fault planted in the join of its distinct
cards reads not correct. Skips without a card, and a cell on more cards
than there are; on the card: ``python -m pytest -m cuda benchmark/tests``."""

import importlib
import json
import subprocess
import sys

import pytest
import tiny
import torch

from benchmark import harness

sharded_bank = importlib.import_module("gpuacceleratedtracking_tpu_torch.parallel.bank")

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
CHIPS = {w["name"]: w["chips"] for w in BENCH["workloads"]}


def needs_cards(count: int) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} CUDA devices, torch sees {torch.cuda.device_count()}")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_of_each_cell_is_correct(cell, trace):
    needs_cards(CHIPS[cell])
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(tiny.SEED), "--seconds", "1", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=1200, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert result["device"]["count"] == CHIPS[cell]
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
             if ("layer" in m) == bool(trace) and cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == names
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    last = out.stderr.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[0] for line in last] == list(result["checks"])


@pytest.mark.cuda
def test_a_tiny_four_card_cell_is_correct_and_reads_the_fullest_cards_peak(tmp_path, monkeypatch):
    needs_cards(4)
    root = tiny.tiny_root(tmp_path)
    cell = tiny.spec.load_cell(tiny.MESH_CELL, root)
    assert cell.chips == 4 and cell.config["mesh"] == {"chan": 4, "time": 1}
    judge, peaks = harness.judge, []

    def judged(*args, **kwargs):
        # The check starts after the peaks are read and the program is freed;
        # a peak never falls, so each card's reads here what the run read.
        peaks.extend(torch.cuda.max_memory_allocated(i) for i in range(4))
        return judge(*args, **kwargs)

    monkeypatch.setattr(harness, "judge", judged)
    result = harness.run(cell, tiny.SEED, 0.5, True, "cuda", log=lambda _: None)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert all(peak > 0 for peak in peaks)
    assert result["device"]["memory_peak_bytes"] == max(peaks)
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def last_card_left_out(results):
    """The join without the last card's results: the first card's in their place."""
    return results[:-1] + results[:1]


def last_card_altered(results):
    """The last card's carrier Doppler altered, on that card, before the join."""
    results[-1][1].carrier_doppler.add_(1.0)
    return results


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [last_card_left_out, last_card_altered])
def test_a_fault_in_the_join_of_four_distinct_cards_reads_not_correct(tmp_path, monkeypatch,
                                                                        fault):
    # Planted on the path that only distinct cards take: the channel shards'
    # results from `graphs.scan_mesh`, on their cards, as the join takes them.
    needs_cards(4)
    root = tiny.tiny_root(tmp_path)
    cell = tiny.spec.load_cell(tiny.MESH_CELL, root)
    join, joined = sharded_bank._join_channels, []

    def broken(results, device):
        joined.append(len(results))
        return join(fault(list(results)), device)

    monkeypatch.setattr(sharded_bank, "_join_channels", broken)
    result = harness.run(cell, tiny.SEED, 0.5, False, "cuda", log=lambda _: None)
    assert joined and set(joined) == {4}
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
