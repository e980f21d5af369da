"""PyTorch port, the scripts layer (CPU): the port's entry points in
``gpuacceleratedtracking_tpu_torch/scripts/`` against the JAX scripts.

Their grids equal the JAX scripts' with "TPU" mapped to "GPU"; one cut cell
of each sweep runs on the CPU and writes its record under the JAX savename
with the JAX record's keys; `bench.profile.extract_device_times` on a
hand-made trace and on a real CPU profile; the cold-start captures against
the JAX `gen_signal` through the same int8 quantizer; and no module of the
layer imports jax or the JAX package.
"""

import ast
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from gpuacceleratedtracking_tpu import bench as jbench
from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu_torch.bench import run_sweep
from gpuacceleratedtracking_tpu_torch.bench.profile import extract_device_times, profile_calls
from gpuacceleratedtracking_tpu_torch.scripts import (
    benchmark_reduction,
    benchmark_replica,
    eval_summary,
    plot_benchmarks,
    profile_trace,
    run_benchmarks_acquire,
    run_benchmarks_gpsl1,
    run_benchmarks_gpsl5,
    run_benchmarks_track,
    run_coldstart,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_SCRIPTS = ROOT / "scripts"
PORT_SCRIPTS = ROOT / "gpuacceleratedtracking_tpu_torch" / "scripts"

torch.set_num_threads(1)

# analog module -> the names of the JAX script's sweep dicts
SWEEP_DICTS = {
    run_benchmarks_gpsl1: ("params", "cpu_params"),
    run_benchmarks_gpsl5: ("params", "cpu_params"),
    run_benchmarks_track: ("params", "m4_params", "glonass_params", "galileo_params",
                           "beidou_params", "dual_params", "dual_params_wide", "wide_params",
                           "wide_fallback_params"),
    run_benchmarks_acquire: ("params", "l5_params", "beidou_params"),
    benchmark_reduction: ("params",),
    benchmark_replica: ("params",),
}


def _name(module) -> str:
    return module.__name__.rsplit(".", 1)[1]


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", JAX_SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tpu_to_gpu(value):
    if isinstance(value, dict):
        return {k: _tpu_to_gpu(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_tpu_to_gpu(v) for v in value]
    return "GPU" if value == "TPU" else value


def _assigned_literals(path: pathlib.Path, names) -> dict:
    """Module-level assignments of ``names`` in a script, without running the
    script: each right-hand side is evaluated alone, with builtins only."""
    found = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id in names:
            code = compile(ast.Expression(node.value), str(path), "eval")
            found[node.targets[0].id] = eval(code, {})
    return found


@pytest.mark.parametrize("module", list(SWEEP_DICTS), ids=_name)
def test_sweep_dicts_equal_the_jax_scripts(module):
    jax_script = _load_jax_script(_name(module))
    for dict_name in SWEEP_DICTS[module]:
        assert getattr(module, dict_name) == _tpu_to_gpu(getattr(jax_script, dict_name)), dict_name


def test_coldstart_truth_and_seeds_equal_the_jax_script():
    # The JAX script parses argv when imported: read its constants instead.
    path = JAX_SCRIPTS / "run_coldstart.py"
    truth = _assigned_literals(path, {"L1", "L5", "B1I"})
    assert truth == {"L1": run_coldstart.L1, "L5": run_coldstart.L5, "B1I": run_coldstart.B1I}
    seeds = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("synthesize_"):
            calls = [c for c in ast.walk(node) if isinstance(c, ast.Call)]
            write = [c for c in calls if getattr(c.func, "id", None) == "_write_int8"]
            rng = [c for c in calls if getattr(c.func, "attr", None) == "default_rng"]
            seeds[node.name] = ([kw.value.value for c in write for kw in c.keywords
                                 if kw.arg == "seed"],
                                [ast.literal_eval(c.args[0]) for c in rng])
    assert seeds == {"synthesize_l1": ([run_coldstart.NOISE_SEEDS["l1"]], []),
                     "synthesize_l5": ([run_coldstart.NOISE_SEEDS["l5"]], [run_coldstart.NAV_SEED]),
                     "synthesize_b1i": ([run_coldstart.NOISE_SEEDS["b1i"]],
                                        [run_coldstart.BITS_SEED])}


@pytest.mark.parametrize("script,names", [
    ("profile_trace", {"REPS"}),
    ("plot_track_convergence", {"NUM_MS", "N", "DOPPLER_ERR"}),
    ("benchmark_accuracy", {"K", "SIGMA", "ENVELOPE"}),
])
def test_script_constants_equal_the_jax_scripts(script, names):
    want = _assigned_literals(JAX_SCRIPTS / f"{script}.py", names)
    module = importlib.import_module(f"gpuacceleratedtracking_tpu_torch.scripts.{script}")
    assert len(want) == len(names)
    assert {name: getattr(module, name) for name in names} == want


def _cut(cell: dict) -> dict:
    """One configuration cut to a CPU test's size: on the CPU, the least
    reps, blocks and trials."""
    cut = dict(cell, processor="CPU", trials=1)
    for key, value in (("reps", 2), ("blocks", 1)):
        if key in cut:
            cut[key] = value
    return cut


# sweep -> (analog dict, runner kind, the JAX runner's stand-in algorithm for
# the keys: the track cells' Pallas kernels would run in interpret mode)
CUT_CELLS = {
    "gpsl1": (run_benchmarks_gpsl1, "cpu_params", "kernel", None),
    "gpsl5": (run_benchmarks_gpsl5, "cpu_params", "kernel", None),
    "track": (run_benchmarks_track, "params", "track", "xla_bank"),
    "dual": (run_benchmarks_track, "dual_params", "dual", "xla_bank"),
    "acquire": (run_benchmarks_acquire, "params", "acquire", None),
    "reduction": (benchmark_reduction, "params", "reduction", None),
    "replica": (benchmark_replica, "params", "replica", None),
}
JAX_RUNNERS = {"kernel": jbench.run_kernel_benchmark, "track": jbench.run_track_benchmark,
               "dual": jbench.run_dual_track_benchmark, "acquire": jbench.run_acquire_benchmark,
               "reduction": jbench.run_reduction_benchmark,
               "replica": jbench.run_replica_benchmark}


@pytest.mark.parametrize("sweep", sorted(CUT_CELLS))
def test_one_cut_cell_writes_the_jax_record(sweep, tmp_path):
    module, dict_name, kind, jax_algorithm = CUT_CELLS[sweep]
    grid = getattr(module, dict_name)
    cell = _cut(chip_smoke.first_cell(grid))
    if kind == "dual":
        cell["num_channels"] = 2
    runner, prefix = {kind: (runner, prefix)
                      for _, _, runner, prefix, kind in chip_smoke.analog_sweeps()}[kind]
    (path,) = run_sweep(cell, runner, tmp_path, prefix=prefix, progress=False,
                        skip_errors=False)
    record = json.loads(path.read_text())
    # The JAX script's cell, cut alike, with the processor replaced.
    jax_grid = _tpu_to_gpu(getattr(_load_jax_script(_name(module)), dict_name))
    jax_cell = _cut(chip_smoke.first_cell(jax_grid))
    if kind == "dual":
        jax_cell["num_channels"] = 2
    assert jax_cell == cell
    assert path.name == jbench.savename(prefix, jax_cell)
    assert "error" not in record and record["processor"] == "CPU" and record["backend"] == "cpu"
    # The JAX harness's record of the same cell (its Pallas bank on the
    # plain oracle) has no key the port's lacks but the JAX version.
    want = JAX_RUNNERS[kind](dict(cell, algorithm=jax_algorithm) if jax_algorithm else cell)
    assert set(want) - {"jax_version"} <= set(record)
    assert set(chip_smoke.JAX_RECORD_KEYS[kind]) == set(want) - set(cell) - {"jax_version"}
    assert record["Median"] >= 0 and len(record["times"]) == 1
    if kind in ("track", "dual"):
        assert record["peak_memory_bytes"] is None          # measured on the card only


def test_every_analog_sweep_is_in_the_smoke_phase():
    # Phase S runs one cell of each dict of each sweep analog.
    names = [entry[0] for entry in chip_smoke.analog_sweeps()]
    assert len(names) == len(set(names)) == 2 * 2 + 9 + 3 + 1 + 1


def _hand_trace():
    def x(cat, name, ts, dur, pid=0):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid}

    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "host"}},
        x("user_annotation", "label", 0.0, 300.0),          # around every call: no gap's host
        x("kernel", "kernel_a", 100.0, 10.0, 1),
        x("gpu_memcpy", "Memcpy HtoD", 110.0, 5.0, 1),
        x("cpu_op", "aten::copy_", 112.0, 28.0),            # covers the 115..135 gap
        x("kernel", "kernel_b", 135.0, 15.0, 1),
        x("cpu_op", "aten::add", 150.0, 30.0),              # 30 us of the 150..190 gap
        x("cuda_runtime", "cudaLaunchKernel", 185.0, 10.0),  # 5 us of it
        x("kernel", "kernel_a", 190.0, 10.0, 1),
        x("gpu_user_annotation", "label", 100.0, 100.0, 1),  # not a device op
        {"ph": "i", "name": "marker", "ts": 120.0},
    ]}


def test_extract_device_times_on_a_hand_made_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_hand_trace()))
    for trace in (_hand_trace(), path):
        got = extract_device_times(trace, reps=2)
        assert got["rows"] == {
            "kernel_a": {"total_ms": 0.02, "calls": 2, "per_call_ms": 0.01},
            "kernel_b": {"total_ms": 0.015, "calls": 1, "per_call_ms": 0.015},
            "Memcpy HtoD": {"total_ms": 0.005, "calls": 1, "per_call_ms": 0.005},
        }
        assert got["device_events"] == 4
        assert got["device_per_call_ms"] == 0.02          # 40 us over 2 reps
        assert got["window_per_call_ms"] == 0.05          # 100..200 us over 2 reps
        assert got["busy_share"] == 0.4
        assert [(g["start_ms"], g["ms"]) for g in got["gaps"]] == [(0.05, 0.04), (0.015, 0.02)]
        assert got["gaps"][0]["hosts"] == [{"name": "aten::add", "overlap_ms": 0.03},
                                           {"name": "cudaLaunchKernel", "overlap_ms": 0.005}]
        assert got["gaps"][1]["hosts"] == [{"name": "aten::copy_", "overlap_ms": 0.02}]
    assert extract_device_times(path, 2)["trace_file"] == str(path)


def test_extract_device_times_splits_the_cards():
    # Two cards: card 0 a kernel and a peer copy, card 1 (named by
    # args.device, its pid another) a kernel; each card's idle time and busy
    # share over the window of both, 100..200 us, over 2 reps.
    def x(cat, name, ts, dur, card, pid=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": card if pid is None else pid, "args": {"device": card}}

    trace = {"traceEvents": [
        x("kernel", "bank", 100.0, 20.0, 0),
        x("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 120.0, 10.0, 0),
        x("kernel", "bank", 110.0, 30.0, 1, pid=7),
        x("kernel", "finish", 190.0, 10.0, 1, pid=7),
    ]}
    got = extract_device_times(trace, reps=2)
    assert got["busy_share"] == 0.5 and got["window_per_call_ms"] == 0.05
    assert got["per_device"] == {
        "0": {"device_events": 2, "device_per_call_ms": 0.015, "copy_per_call_ms": 0.005,
              "idle_per_call_ms": 0.035, "busy_share": 0.3},
        "1": {"device_events": 2, "device_per_call_ms": 0.02, "copy_per_call_ms": 0.0,
              "idle_per_call_ms": 0.03, "busy_share": 0.4},
    }


def test_profile_of_cpu_calls_has_the_keys_and_no_device_rows(tmp_path):
    a = torch.randn(64, 64)
    got = profile_calls(lambda x: x @ x, (a,), reps=3, label="matmul", trace_path=tmp_path / "t.json")
    assert got["reps"] == 3 and got["wall_s"] > 0 and (tmp_path / "t.json").exists()
    assert 0 < got["host_per_call_ms"] <= got["per_call_ms"]
    line = got["device_timeline"]
    assert set(line) == {"trace_file", "device_events", "rows", "device_per_call_ms",
                         "window_per_call_ms", "busy_share", "gaps", "per_device"}
    assert line["device_events"] == 0 and line["rows"] == {} and line["gaps"] == []
    assert line["per_device"] == {}
    assert line["busy_share"] is None and line["device_per_call_ms"] is None
    assert profile_calls(lambda: a + 1, reps=1)["device_timeline"]["trace_file"] is None


def test_profile_trace_writes_its_summary_on_the_cpu(tmp_path):
    summary = profile_trace.run("pallas_bank_auto", 4096, 8, tmp_path, device="cpu", reps=2)
    saved = json.loads((tmp_path / "summary.json").read_text())
    assert saved == json.loads(json.dumps(summary))
    assert (tmp_path / profile_trace.TRACE_NAME).exists()
    assert saved["algorithm"] == "pallas_bank_auto" and saved["processor"] == "CPU"
    assert saved["num_channels"] == 8 and saved["reps"] == 2
    assert saved["device_timeline"]["rows"] == {}


def _jax_signal(leg: str, ms: int) -> np.ndarray:
    """The JAX script's synthesis of leg ``leg`` over ``ms`` milliseconds (its
    planted nav data drawn for the whole capture, as the port's)."""
    c = {"l1": run_coldstart.L1, "l5": run_coldstart.L5, "b1i": run_coldstart.B1I}[leg]
    total = None
    if leg == "l1":
        system = jmodels.GPSL1()
        for prn, dop, phi in zip(c["prns"], c["dops"], c["phases"]):
            s, _ = jmodels.gen_signal(system, prn, dop, c["n"] * ms, duration=ms * 1e-3,
                                      start_code_phase=phi, code_frequency=system.code_frequency
                                      * (1.0 + dop / system.center_frequency))
            total = s if total is None else total + s
        return np.asarray(total)
    if leg == "l5":
        sys_i, sys_q = jmodels.GPSL5(), jmodels.GPSL5(quadrature=True)
        nav = np.repeat(np.random.default_rng(55).choice([-1.0, 1.0], c["ms"] // 10), 10)[:ms]
        for prn, dop, phi, nh0 in zip(c["prns"], c["dops"], c["phases"], c["nh_phase"]):
            common = dict(duration=ms * 1e-3, start_code_phase=phi,
                          code_frequency=sys_i.code_frequency
                          * (1.0 + dop / sys_i.center_frequency))
            nh10 = np.asarray(sys_i.secondary_code, np.float32)
            overlay = nh10[(np.arange(ms) + nh0) % 10] * nav
            s_i, _ = jmodels.gen_signal(sys_i, prn, dop, c["n"] * ms, secondary_code=overlay,
                                        **common)
            s_q, _ = jmodels.gen_signal(sys_q, prn, dop, c["n"] * ms,
                                        secondary_code=sys_q.secondary_code, secondary_phase=nh0,
                                        start_carrier_phase=np.pi / 2, **common)
            s = np.asarray(s_i) + np.asarray(s_q)
            total = s if total is None else total + s
        return total
    system = jmodels.BeiDouB1I(with_secondary=False)
    nh20 = np.asarray(jmodels.BeiDouB1I().secondary_code, np.float32)
    rng = np.random.default_rng(77)
    for prn, dop, phi, nh0 in zip(c["prns"], c["dops"], c["phases"], c["nh_phase"]):
        bits = rng.choice([-1.0, 1.0], c["ms"] // 20 + 2)
        p = np.arange(ms)
        overlay = nh20[(p + nh0) % 20] * bits[(p + nh0) // 20]
        s, _ = jmodels.gen_signal(system, prn, dop, c["n"] * ms, duration=ms * 1e-3,
                                  start_code_phase=phi, code_frequency=system.code_frequency
                                  * (1.0 + dop / system.center_frequency),
                                  secondary_code=overlay)
        total = s if total is None else total + s
    return np.asarray(total)


@pytest.mark.parametrize("leg", ["l1", "l5", "b1i"])
def test_coldstart_capture_matches_the_jax_synthesis(leg, tmp_path):
    ms = 5
    truth, signal = run_coldstart.LEGS[leg]
    seed = run_coldstart.NOISE_SEEDS[leg]
    path = tmp_path / "capture.int8"
    run_coldstart.synthesize(leg, path, device="cpu", ms=ms)
    got = np.fromfile(path, np.int8)
    assert np.array_equal(got, run_coldstart.quantize(signal(ms, "cpu"), truth["sigma"],
                                                      truth["scale"], seed))
    want = run_coldstart.quantize(_jax_signal(leg, ms), truth["sigma"], truth["scale"], seed)
    assert got.shape == want.shape == (2 * truth["n"] * ms,)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # The same noise through the same quantizer: the f32 signals differ by
    # float rounding, which moves a sample across a rounding edge rarely.
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-4 * diff.size


def test_coldstart_planted_data_is_the_whole_captures():
    nav = run_coldstart.l5_nav()
    assert nav.shape == (run_coldstart.L5["ms"],) and set(np.unique(nav)) == {-1.0, 1.0}
    assert np.array_equal(nav[::10].repeat(10), nav)
    bits = run_coldstart.b1i_bits()
    assert [b.shape for b in bits] == [(run_coldstart.B1I["ms"] // 20 + 2,)] * 2
    # Block-aligned tracking: past half a code period the next NH sign rules.
    assert run_coldstart._block_dominant(run_coldstart.B1I, 2046) == [5, 13]
    assert run_coldstart.symbols_match([1.0, -1.0], np.array([1.0, 1.0, -1.0, 1.0]))
    assert run_coldstart.symbols_match([-1.0, 1.0], np.array([1.0, -1.0, 1.0]))
    assert not run_coldstart.symbols_match([1.0, 1.0, 1.0], np.array([1.0, -1.0, 1.0]))


def test_figures_and_tables_from_records(tmp_path, capsys, monkeypatch):
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    records = tmp_path / "benchmarks"
    cell = _cut(chip_smoke.first_cell(run_benchmarks_gpsl1.cpu_params))
    for n in (2048, 4096):
        run_sweep(dict(cell, num_samples=n), chip_smoke.analog_sweeps()[1][2], records / "kernel",
                  progress=False)
    written = plot_benchmarks.main(records, tmp_path / "img")
    assert [pathlib.Path(p).name for p in written] == ["kernel_benchmarks.png"]
    assert (tmp_path / "img" / "kernel_benchmarks.png").stat().st_size > 10_000
    monkeypatch.setattr(eval_summary, "BENCHMARKS", records)
    eval_summary.main()
    out = capsys.readouterr().out
    assert "fused_xla: host CPU vs the card" in out and "| CPU |" in out


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_scripts_layer_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT_SCRIPTS.glob("*.py")) + [
        ROOT / "gpuacceleratedtracking_tpu_torch" / "bench" / "profile.py"]
    assert len(files) >= 14
    for path in files:
        bad = {name for name in _imports(path)
               if name.split(".")[0] in ("jax", "gpuacceleratedtracking_tpu")}
        assert not bad, (path.name, bad)


@pytest.mark.parametrize("n", [2048, 6144, 10240, 14336])
def test_replica_experiment_matches_the_jax_table_to_a_chip(n):
    # The port's chip rate is the correctly rounded f32 quotient, at most 1 ulp
    # from the JAX `precise_div` (ops/replica.py), which can move one chip
    # boundary by a sample: at N=10240 the exact replicas differ in one chip.
    # So each block's mismatch count may differ from the JAX one by one chip
    # per replica, and by no more.
    jax_script = _load_jax_script("code_replica_experiment")
    from gpuacceleratedtracking_tpu_torch.scripts import code_replica_experiment

    got = code_replica_experiment.run(start=n, stop=n, step=2048, phase_bits=(8, 12),
                                      device="cpu")
    want = jax_script.run(start=n, stop=n, step=2048, phase_bits=(8, 12))
    assert got.keys() == want.keys()
    for bits in want:
        assert got[bits].keys() == want[bits].keys()
        for stat, pct in want[bits].items():
            assert abs(got[bits][stat] - pct) * n / 100.0 <= 2.0 + 1e-9, (bits, stat)
