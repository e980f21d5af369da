"""Benchmark figures: processing time against the 1 ms real-time bound.

Port of `gpuacceleratedtracking_tpu.bench.plots`. Four figure families, each
with the real-time bound drawn as a horizontal line:

- `plot_kernel_benchmarks`: processing time vs sampling frequency per
  algorithm (the paper's grid of GNSS x antenna/correlator panels),
- `plot_reduction_benchmark`: grouped bars of pure/cplx/cplx_multi,
- `plot_replica_benchmark`: log-log replica generation time, exact vs
  quantized NCO,
- `plot_track_benchmark`: closed-loop time per block vs channel count.

Each takes a pandas DataFrame of result records (`sweep.collect_results`)
and writes a PNG with matplotlib's Agg backend; matplotlib is imported when a
figure is drawn, not when this module is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .harness import REALTIME_BOUND_S

# Times below this are clipped so that a log axis can draw them.
_FLOOR_S = 2e-6


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, plt, out_path: str) -> str:
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_kernel_benchmarks(df, out_path: str, title: Optional[str] = None):
    """Grid of processing-time-vs-sampling-rate curves, one panel per
    (GNSS, num_ants, num_correlators), one line per algorithm (and per
    processor: CPU rows dashed beside the GPU ones)."""
    plt = _mpl()
    panels = sorted(
        df.groupby(["GNSS", "num_ants", "num_correlators"]).groups.keys()
    )
    ncols = min(3, len(panels))
    nrows = (len(panels) + ncols - 1) // ncols
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(5 * ncols, 3.6 * nrows), squeeze=False
    )
    for ax_idx, (gnss, ants, corrs) in enumerate(panels):
        ax = axes[ax_idx // ncols][ax_idx % ncols]
        panel = df[
            (df.GNSS == gnss)
            & (df.num_ants == ants)
            & (df.num_correlators == corrs)
        ]
        keys = ["algorithm"]
        if "processor" in panel.columns:
            keys.append("processor")
        for gkey, grp in panel.groupby(keys):
            # pandas >= 3.0 yields 1-tuples even for single-key groupbys.
            if not isinstance(gkey, tuple):
                gkey = (gkey,)
            algo, proc = gkey if len(gkey) == 2 else (gkey[0], "GPU")
            grp = grp.sort_values("num_samples")
            fs_mhz = grp.num_samples / 1e3  # N per 1 ms -> kHz -> MHz
            t = grp.Median.clip(lower=_FLOOR_S)
            is_cpu = str(proc).upper() == "CPU"
            ax.loglog(
                fs_mhz, t, marker="o", ms=3, ls="--" if is_cpu else "-",
                alpha=0.6 if is_cpu else 1.0,
                label=f"{algo} (CPU)" if is_cpu else algo,
            )
        ax.axhline(REALTIME_BOUND_S, color="k", ls="--", lw=1, label="real-time")
        ax.set_title(f"{gnss}  M={ants}  L={corrs}", fontsize=10)
        ax.set_xlabel("sampling rate [MHz]")
        ax.set_ylabel("time per 1 ms block [s]")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=7)
    for j in range(len(panels), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if title:
        fig.suptitle(title)
    return _finish(fig, plt, out_path)


def plot_reduction_benchmark(df, out_path: str):
    """Grouped bars of reduction time per fusion degree vs N."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4))
    sizes = sorted(df.num_samples.unique())
    algos = [a for a in ("pure", "cplx", "cplx_multi") if a in set(df.algorithm)]
    width = 0.8 / max(len(algos), 1)
    x = np.arange(len(sizes))
    for i, algo in enumerate(algos):
        grp = (
            df[df.algorithm == algo]
            .groupby("num_samples")["Median"]
            .min()
            .reindex(sizes)
        )
        ax.bar(x + i * width, grp.clip(lower=_FLOOR_S).values * 1e6, width,
               label=algo)
    ax.set_xticks(x + width * (len(algos) - 1) / 2)
    ax.set_xticklabels([f"2^{int(np.log2(s))}" for s in sizes])
    ax.set_xlabel("num samples")
    ax.set_ylabel("reduction time [µs]")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    return _finish(fig, plt, out_path)


def plot_replica_benchmark(df, out_path: str):
    """Log-log replica generation time vs sampling rate, exact vs quantized."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    for algo, grp in df.groupby("algorithm"):
        grp = grp.sort_values("num_samples")
        ax.loglog(
            grp.num_samples / 1e3, grp.Median.clip(lower=_FLOOR_S),
            marker="o", ms=3, label=algo,
        )
    ax.axhline(REALTIME_BOUND_S, color="k", ls="--", lw=1, label="real-time")
    ax.set_xlabel("sampling rate [MHz]")
    ax.set_ylabel("replica generation time [s]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    return _finish(fig, plt, out_path)


def plot_track_benchmark(df, out_path: str):
    """Closed-loop bank: time per block vs channel count, one line per
    algorithm, rate and configuration, with the 1 ms real-time bound."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7.5, 4.4))
    # Records that leave a defaulted key out (num_ants for M=1 rows, L=3) read
    # back as NaN or lack the column, and a groupby drops NaN keys, which would
    # remove those lines: fill the defaults.
    defaults = {"num_ants": 1, "num_correlators": 3, "GNSS": "GPSL1"}
    df = df.assign(**{key: value for key, value in defaults.items() if key not in df})
    df = df.assign(
        num_ants=df.num_ants.fillna(1),
        num_correlators=df.num_correlators.fillna(3),
    )
    # Mixed-constellation rows (no num_channels axis) are not K-sweeps.
    df = df[df.num_channels.notna()] if "num_channels" in df else df
    if "bank_channels" not in df:
        df = df.assign(bank_channels=float("nan"))
    keys = ["GNSS", "algorithm", "num_samples", "num_ants", "num_correlators"]
    for (gnss, algo, n, m, l), grp in df.groupby(keys):
        grp = grp.sort_values("num_channels")
        label = f"{algo} @ {n / 1e3:g} MHz"
        if grp.bank_channels.notna().any():
            # Dual-component rows: K counts DUAL channels (a 2K-channel bank).
            label = f"{gnss[3:]}-dual {label}"
        elif gnss != "GPSL1":
            label = f"{gnss} {label}"
        if (m, l) != (1, 3):
            label += f" M={m} L={l}"
        ax.loglog(
            grp.num_channels, grp.Median.clip(lower=_FLOOR_S),
            marker="o", ms=4, label=label,
        )
    ax.axhline(REALTIME_BOUND_S, color="k", ls="--", lw=1, label="real-time")
    ax.set_xlabel("channels K")
    ax.set_ylabel("closed-loop time per 1 ms block [s]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7)
    return _finish(fig, plt, out_path)


def main(argv=None) -> int:
    """Draw the kernel and track figures from directories of result records,
    one JSON file per record as `run_sweep` writes them (``chip_smoke.py``
    leaves its sweep in ``kernel_sweep/`` and its closed-loop records in
    ``figures/track_records/`` beside its ``--out``)."""
    import argparse
    import pathlib

    from .sweep import collect_results

    parser = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    parser.add_argument("--kernel", help="directory of run_kernel_benchmark records")
    parser.add_argument("--track", help="directory of run_track_benchmark records")
    parser.add_argument("--out", required=True, help="directory for the PNG files")
    args = parser.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.kernel:
        print(plot_kernel_benchmarks(collect_results(args.kernel),
                                     str(out / "kernel_benchmarks.png")))
    if args.track:
        print(plot_track_benchmark(collect_results(args.track), str(out / "track_benchmarks.png")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
