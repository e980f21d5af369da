"""PyTorch port, benchmark harness (CPU): the five ported benchmarks end to end
on tiny configs, as tests/test_bench.py runs the JAX ones, with the JAX
harness's result keys; sweeps and their file names against the JAX package.
"""

import json

import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import bench as jbench
from gpuacceleratedtracking_tpu_torch import bench as tbench
from gpuacceleratedtracking_tpu_torch.bench import harness as tharness
from gpuacceleratedtracking_tpu_torch.bench import timing as ttiming
from gpuacceleratedtracking_tpu_torch.ops import channel_kernels

torch.set_num_threads(1)

STATS = {"Minimum", "Median", "Mean", "Std", "Maximum", "times"}
METADATA = {"os", "cpu_model", "backend", "device_kind", "torch_version", "cuda_version",
            "gpu_name", "power_limit", "processor", "algorithm", "git_sha"}


def _kernel_config(algorithm, **kw):
    return dict({"GNSS": "GPSL1", "num_samples": 2048, "num_ants": 1,
                 "num_correlators": 3, "algorithm": algorithm, "processor": "CPU",
                 "reps": 2, "trials": 2}, **kw)


def _check_stats(res):
    assert STATS <= set(res)
    assert 0 <= res["Minimum"] <= res["Median"] <= res["Maximum"]
    assert len(res["times"]) == res.get("trials", 7)
    assert METADATA <= set(res)
    assert res["backend"] == "cpu" and res["processor"] == "CPU"
    assert res["gpu_name"] is None and res["torch_version"] == torch.__version__


@pytest.mark.parametrize("algorithm,ants,taps", [
    ("fused_xla", 1, 3), ("unfused_xla", 4, 7), ("pallas_taps", 4, 7),
    ("pallas_fused", 1, 7), ("pallas_bank_onehot", 1, 3), ("pallas_bank", 1, 3),
])
def test_kernel_benchmark(algorithm, ants, taps):
    res = tbench.run_kernel_benchmark(_kernel_config(algorithm, num_ants=ants,
                                                     num_correlators=taps))
    _check_stats(res)
    assert res["algorithm"] == algorithm and res["reps_resolved"] == 2
    assert res["reps_mode"] == "calls"
    assert res["samples_per_s"] > 0 and res["realtime_ratio"] > 0
    # On the CPU the kernel algorithms run their plain versions.
    assert channel_kernels.correlate_pallas_fused.launches == 0


def test_kernel_benchmark_result_keys_match_jax():
    config = _kernel_config("fused_xla")
    want = jbench.run_kernel_benchmark(config)
    got = tbench.run_kernel_benchmark(config)
    jax_only = {"jax_version"}
    assert set(want) - jax_only <= set(got)
    assert set(got) - set(want) == METADATA - set(want)
    assert got["reps_resolved"] == want["reps_resolved"] == 2


def test_auto_reps_follow_the_jax_rule():
    res = tbench.run_kernel_benchmark(_kernel_config("pallas_fused", reps="auto",
                                                     trials=1, num_samples=1 << 16))
    assert res["reps_resolved"] == 64


@pytest.mark.parametrize("algorithm,ants", [("pallas_bank", 1), ("pallas_fused", 2)])
def test_track_benchmark(algorithm, ants):
    res = tbench.run_track_benchmark({
        "GNSS": "GPSL1", "num_samples": 2048, "num_channels": 3, "num_ants": ants,
        "algorithm": algorithm, "processor": "CPU", "blocks": 2, "trials": 2})
    _check_stats(res)
    assert res["realtime_channels"] >= 0 and res["algorithm"] == algorithm


def test_dual_track_benchmark():
    res = tbench.run_dual_track_benchmark({
        "GNSS": "GPSL5", "num_samples": 4096, "num_channels": 2, "algorithm": "xla_bank",
        "processor": "CPU", "blocks": 2, "trials": 2})
    _check_stats(res)
    assert res["bank_channels"] == 4 and res["realtime_channels"] >= 0


@pytest.mark.parametrize("algorithm", ["pure", "cplx", "cplx_multi"])
def test_reduction_benchmark(algorithm):
    res = tbench.run_reduction_benchmark({
        "num_samples": 1024, "num_ants": 2, "num_correlators": 3, "algorithm": algorithm,
        "processor": "CPU", "reps": 2, "trials": 2})
    _check_stats(res)


@pytest.mark.parametrize("algorithm", ["exact", "quantized"])
def test_replica_benchmark(algorithm):
    res = tbench.run_replica_benchmark({
        "GNSS": "GPSL1", "num_samples": 2048, "algorithm": algorithm, "processor": "CPU",
        "reps": 2, "trials": 2})
    _check_stats(res)


def test_processor_must_be_gpu_or_cpu():
    with pytest.raises(ValueError, match="GPU' or 'CPU"):
        tbench.run_kernel_benchmark(_kernel_config("fused_xla", processor="TPU"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tbench.run_kernel_benchmark(_kernel_config("fused_xla", processor="GPU"))
    assert tharness.resolve_device("cpu") == torch.device("cpu")


def test_timing_protocols_on_cpu():
    x = torch.ones(1000)
    stats = ttiming.benchmark(lambda: x.sum(), trials=3, reps=2)
    assert len(stats.times) == 3 and stats.minimum <= stats.median <= stats.maximum
    stats = ttiming.benchmark_pipelined(lambda y: y * 2, [(x,), (x + 1,)], trials=2)
    assert len(stats.times) == 2
    d = stats.to_dict()
    assert set(d) == STATS
    assert ttiming._device_of(({"a": [None, x]},)) == torch.device("cpu")


@pytest.mark.parametrize("params", [
    {"a": [1, 2], "b": ["x", "y"], "c": 7},
    {"num_samples": [2 ** e for e in range(11, 14)], "num_ants": (1, 4),
     "algorithm": ["fused_xla", "pallas_fused"], "processor": "GPU", "reps": "auto"},
    {"n": np.arange(3), "fixed": 1.5},
])
def test_dict_list_and_savename_match_jax(params):
    got, want = tbench.dict_list(params), jbench.dict_list(params)
    assert got == want
    assert [tbench.savename("K", c) for c in got] == [jbench.savename("K", c) for c in want]


def test_run_sweep_resume(tmp_path):
    calls = []

    def runner(config):
        calls.append(config["n"])
        if config["n"] == 3:
            raise ValueError("no such cell")
        return {"n": config["n"], "Minimum": 1.0, "value": np.float32(0.5)}

    params = {"n": [1, 2, 3]}
    paths = tbench.run_sweep(params, runner, tmp_path, prefix="T", progress=False)
    assert len(paths) == 3 and all(p.exists() for p in paths)
    assert calls == [1, 2, 3]
    assert json.loads(paths[2].read_text())["error"].startswith("ValueError")
    tbench.run_sweep(params, runner, tmp_path, prefix="T", progress=False)
    assert calls == [1, 2, 3]
    assert json.loads(paths[0].read_text())["value"] == 0.5
    with pytest.raises(ValueError):
        tbench.run_sweep({"n": [3]}, runner, tmp_path / "strict", progress=False,
                         skip_errors=False)


def test_collect_and_eval(tmp_path):
    def runner(config):
        t = 1e-4 * config["num_samples"] / 2048
        return {"GNSS": "GPSL1", "algorithm": "pallas_fused",
                "num_samples": config["num_samples"], "Minimum": t, "Median": t}

    tbench.run_sweep({"num_samples": [2048, 4096]}, runner, tmp_path, progress=False)
    df = tbench.collect_results(tmp_path)
    assert len(df) == 2
    summary = tbench.eval_results(df)
    assert "realtime_x" in summary.columns
