"""Results evaluation: a copy of `gpuacceleratedtracking_tpu.bench.results`.

``df`` is a pandas DataFrame (`sweep.collect_results`)."""

from __future__ import annotations

from typing import Optional


def eval_results(df, group_keys: Optional[list[str]] = None):
    """Summarize a results DataFrame: min-time stats per configuration group.

    Prints a compact table and returns the summary frame. The default
    grouping is the sweep's scenario keys.
    """
    if group_keys is None:
        group_keys = [
            k
            for k in ("GNSS", "processor", "algorithm", "num_ants",
                      "num_correlators", "num_samples")
            if k in df.columns
        ]
    cols = [c for c in ("Minimum", "Median", "Mean", "Std", "Maximum") if c in df.columns]
    summary = (
        df.groupby(group_keys)[cols].min().reset_index().sort_values(group_keys)
    )
    if "Median" in summary.columns:
        # Median, not minimum: differential timings can clamp a noisy minimum
        # to zero, and the median is the robust central estimate there.
        summary["realtime_x"] = 1e-3 / summary["Median"].clip(lower=1e-9)
    print(summary.to_string(index=False))
    return summary
