"""PyTorch port, the figure layer (`bench.plots`) on the Agg backend.

The four figures are drawn from synthetic frames (as tests/test_plots.py
draws the JAX package's) and from the port's own benchmark records on the
CPU; each PNG must exceed 10 KB.
"""

import json

import matplotlib
import numpy as np
import pandas as pd
import pytest

from gpuacceleratedtracking_tpu.bench import plots as jplots
from gpuacceleratedtracking_tpu_torch.bench import (collect_results, run_kernel_benchmark,
                                                    run_sweep, run_track_benchmark)
from gpuacceleratedtracking_tpu_torch.bench import plots


def _kernel_frame(processors=("GPU",)):
    rows = []
    for proc in processors:
        for algo in ["pallas_fused", "fused_xla"]:
            for ants in [1, 4]:
                for n in [2048, 8192, 32768]:
                    rows.append({
                        "GNSS": "GPSL1", "num_ants": ants, "num_correlators": 3,
                        "num_samples": n, "algorithm": algo, "processor": proc,
                        "Median": 1e-6 * n / 2048 * (1 if algo.startswith("p") else 3)
                        * (10 if proc == "CPU" else 1),
                    })
    return pd.DataFrame(rows)


def _track_frame():
    rows = []
    for algo, scale in (("pallas_bank_auto", 1.0), ("xla_bank", 4.0)):
        for k in (64, 256, 1024):
            rows.append({"GNSS": "GPSL1", "algorithm": algo, "num_samples": 32768,
                         "num_channels": k, "num_ants": 1, "num_correlators": 3,
                         "Median": scale * 2e-6 * k})
    for k in (16, 64):       # a dual-component row: K dual channels, a 2K bank
        rows.append({"GNSS": "GPSL5", "algorithm": "pallas_bank_auto", "num_samples": 32768,
                     "num_channels": k, "bank_channels": 2 * k, "num_ants": 1,
                     "num_correlators": 3, "Median": 3e-6 * k})
    return pd.DataFrame(rows)


@pytest.fixture
def drawn(monkeypatch):
    """The figures drawn during a test, captured as they are closed."""
    import matplotlib.pyplot as plt

    figs = []
    close = plt.close

    def keep(fig=None):
        figs.append(fig)
        close(fig)

    monkeypatch.setattr(plt, "close", keep)
    return figs


def _labels(fig):
    return sorted({line.get_label() for ax in fig.axes for line in ax.get_lines()})


def test_kernel_figure(tmp_path, drawn):
    out = plots.plot_kernel_benchmarks(_kernel_frame(("GPU", "CPU")),
                                       str(tmp_path / "kernel.png"), title="t")
    assert out == str(tmp_path / "kernel.png")
    assert (tmp_path / "kernel.png").stat().st_size > 10_000
    assert matplotlib.get_backend().lower() == "agg"
    (fig,) = drawn
    assert len([ax for ax in fig.axes if ax.get_lines()]) == 2   # panels M=1, M=4
    assert _labels(fig) == ["fused_xla", "fused_xla (CPU)", "pallas_fused",
                            "pallas_fused (CPU)", "real-time"]


def test_kernel_figure_without_a_processor_column_draws_gpu_lines(tmp_path, drawn):
    df = _kernel_frame().drop(columns="processor")
    plots.plot_kernel_benchmarks(df, str(tmp_path / "kernel.png"))
    assert (tmp_path / "kernel.png").stat().st_size > 10_000
    assert _labels(drawn[0]) == ["fused_xla", "pallas_fused", "real-time"]
    assert all(line.get_linestyle() == "-" for ax in drawn[0].axes
               for line in ax.get_lines() if line.get_label() != "real-time")


def test_reduction_figure(tmp_path):
    df = pd.DataFrame({
        "algorithm": ["pure", "cplx", "cplx_multi"] * 2,
        "num_samples": [2048] * 3 + [4096] * 3,
        "Median": [6e-5, 7e-6, 1e-6, 1.2e-4, 1.4e-5, 2e-6],
    })
    plots.plot_reduction_benchmark(df, str(tmp_path / "red.png"))
    assert (tmp_path / "red.png").stat().st_size > 10_000


def test_replica_figure(tmp_path):
    df = pd.DataFrame({
        "algorithm": ["exact"] * 3 + ["quantized"] * 3,
        "num_samples": [2048, 8192, 32768] * 2,
        "Median": [1e-4, 1.5e-4, 1.8e-4, 0.8e-4, 1.2e-4, 1.5e-4],
    })
    plots.plot_replica_benchmark(df, str(tmp_path / "rep.png"))
    assert (tmp_path / "rep.png").stat().st_size > 10_000


def test_track_figure(tmp_path, drawn):
    plots.plot_track_benchmark(_track_frame(), str(tmp_path / "track.png"))
    assert (tmp_path / "track.png").stat().st_size > 10_000
    assert _labels(drawn[0]) == ["L5-dual pallas_bank_auto @ 32.768 MHz",
                                 "pallas_bank_auto @ 32.768 MHz", "real-time",
                                 "xla_bank @ 32.768 MHz"]


@pytest.mark.parametrize("dropped", [["num_correlators"], ["num_ants", "num_correlators", "GNSS"]])
def test_track_figure_without_defaulted_columns(tmp_path, dropped):
    # ADVICE.md:4: the JAX figure reads num_correlators unguarded and raises
    # on a frame without it; the port fills the default, as for num_ants.
    df = _track_frame().drop(columns=dropped)
    if dropped == ["num_correlators"]:
        with pytest.raises(AttributeError):
            jplots.plot_track_benchmark(df, str(tmp_path / "jax.png"))
    plots.plot_track_benchmark(df, str(tmp_path / "track.png"))
    assert (tmp_path / "track.png").stat().st_size > 10_000


def test_figures_from_the_ports_own_records(tmp_path):
    # Records as the harness writes them (here on the CPU, at tiny sizes),
    # through run_sweep and collect_results, as chip_smoke.py draws them.
    params = {"GNSS": "GPSL1", "num_samples": [2048, 4096], "num_ants": 1,
              "num_correlators": 3, "algorithm": ["fused_xla", "pallas_fused"],
              "processor": "CPU", "reps": 1, "trials": 1}
    run_sweep(params, run_kernel_benchmark, tmp_path / "kernel", resume=False, progress=False,
              skip_errors=False)
    df = collect_results(tmp_path / "kernel")
    assert len(df) == 4 and np.isfinite(df.Median).all()
    plots.plot_kernel_benchmarks(df, str(tmp_path / "kernel.png"))
    assert (tmp_path / "kernel.png").stat().st_size > 10_000
    rows = [run_track_benchmark({"GNSS": "GPSL1", "num_samples": 2048, "num_channels": k,
                                 "algorithm": "xla_bank", "processor": "CPU", "blocks": 1,
                                 "trials": 1}) for k in (2, 4)]
    plots.plot_track_benchmark(pd.DataFrame(rows), str(tmp_path / "track.png"))
    assert (tmp_path / "track.png").stat().st_size > 10_000


def test_command_line_draws_from_record_directories(tmp_path):
    # `python -m gpuacceleratedtracking_tpu_torch.bench.plots`: the figures
    # from directories of one-record JSON files, as chip_smoke.py leaves them.
    for name, frame in (("kernel", _kernel_frame(("GPU", "CPU"))), ("track", _track_frame())):
        (tmp_path / name).mkdir()
        for i, row in enumerate(frame.to_dict("records")):
            (tmp_path / name / f"r{i}.json").write_text(json.dumps(row))
    assert plots.main(["--kernel", str(tmp_path / "kernel"), "--track", str(tmp_path / "track"),
                       "--out", str(tmp_path / "figs")]) == 0
    for png in ("kernel_benchmarks.png", "track_benchmarks.png"):
        assert (tmp_path / "figs" / png).stat().st_size > 10_000
