"""Every cell through the command on the card, briefly: it prints one result
line, ``correct`` true, the metrics its mode asks for, and the numbers
compared as the last lines of standard error. Skips without a card; on the
card: ``python -m pytest -m cuda benchmark/tests``."""

import json
import subprocess
import sys

import pytest
import tiny
import torch

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_of_each_cell_is_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(tiny.SEED), "--seconds", "1", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=1200, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
             if ("layer" in m) == bool(trace) and cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == names
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    last = out.stderr.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[0] for line in last] == list(result["checks"])
