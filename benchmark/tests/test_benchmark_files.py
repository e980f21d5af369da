"""`BENCHMARK.json` against the benchmark's contract, the harness's discovery of
files a later change adds, and the imports the benchmark may make."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import tiny

from benchmark import capture, harness, spec

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and w["name"] == f"{w['config']}.{w['traffic']}"
        reported = [m for m in spec.cell_metrics(BENCH, w["name"])]
        assert "setup_s" in {m["name"] for m in reported}
        assert any("layer" not in m and m["name"] != "setup_s" for m in reported)
        assert any("layer" in m for m in reported)
        for m in reported:
            if "layer" in m:
                assert m["moves"] in {r["name"] for r in reported if "layer" not in r}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_each_metric_has_a_reader_that_declares_what_benchmark_json_says(metric):
    entry = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}[metric]
    reader = spec.load_module(ROOT / "benchmark" / "metrics" / f"{metric}.py", "metric")
    assert reader.UNIT == entry["unit"] and reader.SOURCE == entry["source"]
    if "layer" in entry:
        assert (reader.LAYER, reader.MOVES) == (entry["layer"], entry["moves"])
    else:
        assert reader.BETTER == entry["better"]
    # Which cells report a metric is said in BENCHMARK.json alone.
    assert not hasattr(reader, "WORKLOADS")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_parses_and_states_what_benchmark_json_says(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert {"deployment", "precision", "reference", "bank", "track", "routes_to",
            "assumed"} <= set(config)
    assert (ROOT / "benchmark" / "reference" / f"{config['reference']}.py").exists()
    assert {"channels", "antennas", "prn_cycle", "doppler_span_hz", "table_prns"} <= set(
        config["bank"])
    cells = [w for w in BENCH["workloads"] if w["config"] == entry["name"]]
    assert cells
    layout = config.get("mesh", {"chan": 1, "time": 1})
    assert all(w["chips"] == layout["chan"] * layout["time"] for w in cells)
    for w in cells:
        traffic = spec.load_cell(w["name"]).traffic
        scenario = capture.draw_scenario(config, traffic, tiny.SEED)
        assert capture.initial_state(config, scenario).prn.shape == (
            config["bank"]["channels"],)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cells_limits_parse_and_lie_between_their_readings(cell):
    limits = spec.load_cell(cell).limits
    assert set(limits) == {"accum_gap", "loop_gap"}
    for v in limits.values():
        assert v["lower"] <= v["limit"] < v["upper"] and v["from"]


@pytest.mark.parametrize("layout", [None, {"chan": 4, "time": 1}])
def test_a_configuration_a_traffic_mix_a_metric_and_a_cell_added_as_files(tmp_path, layout):
    root = tiny.tiny_root(tmp_path)
    bench_dir = root / "benchmark"
    config = json.loads((bench_dir / "configs" / "gpsl1_k1024.json").read_text())
    config.update(name="gpsl1_k16_l5")
    if layout is not None:
        config["mesh"] = layout                        # the bank over four cards
        config["bank"]["prn_cycle"] = 4                # a shard of 4 channels holds the cycle
    config["bank"]["channels"] = 16
    config["track"]["sample_shifts"] = [-8, -4, 0, 4, 8]
    (bench_dir / "configs" / "gpsl1_k16_l5.json").write_text(json.dumps(config))
    traffic = json.loads((bench_dir / "traffic" / "epoch20.json").read_text())
    traffic.update(blocks_per_call=1)                  # an epoch of one block
    (bench_dir / "traffic" / "epoch1.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "blocks_per_call.py").write_text(
        'LAYER = "entry and graph replay"\nUNIT, SOURCE, MOVES = "blocks", "program_counter", '
        '"realtime_channels"\n\n\ndef read(run):\n'
        '    return run.blocks / run.calls\n')
    limits = json.loads((bench_dir / "limits" / "gpsl1_k1024.epoch20.json").read_text())
    (bench_dir / "limits" / "gpsl1_k16_l5.epoch1.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gpsl1_k16_l5", "source": "a test",
                             "file": "benchmark/configs/gpsl1_k16_l5.json", "reduced": [],
                             "why": "a test"})
    chips = 1 if layout is None else layout["chan"] * layout["time"]
    bench["workloads"].append({"name": "gpsl1_k16_l5.epoch1", "config": "gpsl1_k16_l5",
                               "traffic": "epoch1", "chips": chips, "why": "a test"})
    bench["per_layer"].append({"name": "blocks_per_call", "unit": "blocks", "better": "higher",
                               "source": "program_counter", "layer": "entry and graph replay",
                               "moves": "realtime_channels", "workloads": ["gpsl1_k16_l5.epoch1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("gpsl1_k16_l5.epoch1", root)
    assert [m["name"] for m in cell.metrics] == ["realtime_channels", "setup_s",
                                                 "blocks_per_call"]
    result = tiny.run(root, "gpsl1_k16_l5.epoch1")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"realtime_channels", "setup_s"}
    assert result["device"]["count"] == chips
    layer = harness.run(cell, tiny.SEED, 0.2, True, "cpu", log=lambda _: None)
    assert layer["metrics"]["blocks_per_call"]["value"] == 1.0


def imports_of(path: pathlib.Path) -> set:
    """Top-level names of the modules that a Python file imports (relative
    imports are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_imports_no_program():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not imports_of(path) & set(harness.FORBIDDEN), path
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert imports_of(path) <= {"__future__", "dataclasses", "functools", "math", "typing",
                                    "numpy", "torch"}, path
    for path in ["capture.py", "gold.py", "trace.py", "yardstick.py"]:
        assert "gpuacceleratedtracking_tpu_torch" not in imports_of(ROOT / "benchmark" / path)


def test_a_run_loads_no_forbidden_module_whole_names_compared(tmp_path):
    root = tiny.tiny_root(tmp_path)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, "
            f"{str(ROOT / 'benchmark' / 'tests')!r}); import pathlib, tiny; "
            f"from benchmark import harness; "
            f"r = tiny.run(pathlib.Path({str(root)!r}), 'gpsl1_k1024.epoch20', 0.1); "
            f"assert r['correct']; print(harness.forbidden_modules()); "
            f"print(sorted(m for m in sys.modules if m.startswith('gpuacceleratedtracking_tpu'))[:1])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    forbidden, port = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert port.startswith("['gpuacceleratedtracking_tpu_torch")     # whole names: not forbidden
    sys.modules.setdefault("gpuacceleratedtracking_tpu.fake", object())
    try:
        assert "gpuacceleratedtracking_tpu.fake" in harness.forbidden_modules()
    finally:
        del sys.modules["gpuacceleratedtracking_tpu.fake"]


def test_the_command_without_a_card_exits_non_zero_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "gpsl1_k1024.epoch20", "--seed", str(tiny.SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
