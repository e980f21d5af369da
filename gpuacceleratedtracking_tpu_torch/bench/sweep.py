"""Parameter sweeps with per-config persistence and resume.

A copy of `gpuacceleratedtracking_tpu.bench.sweep` (that package imports jax):
list-valued keys are expanded cartesian-style, each finished config is
written immediately as a JSON file named from its parameters, and an
interrupted sweep resumes at config granularity by skipping existing files.
pandas is imported only by `collect_results`.
"""

from __future__ import annotations

import itertools
import json
import pathlib
from typing import Callable

import numpy as np


def dict_list(params: dict) -> list[dict]:
    """Expand list/tuple/ndarray-valued keys into the cartesian product."""
    listy = {
        k: list(v)
        for k, v in params.items()
        if isinstance(v, (list, tuple, np.ndarray, range))
    }
    fixed = {k: v for k, v in params.items() if k not in listy}
    if not listy:
        return [dict(fixed)]
    keys = sorted(listy)
    return [
        {**fixed, **dict(zip(keys, combo))}
        for combo in itertools.product(*(listy[k] for k in keys))
    ]


def savename(prefix: str, config: dict) -> str:
    """Deterministic filename from the swept parameters (savename analog)."""
    parts = "_".join(
        f"{k}={config[k]}" for k in sorted(config) if not isinstance(config[k], dict)
    )
    return f"{prefix}_{parts}.json"


def _to_jsonable(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj)}")


def run_sweep(
    params: dict,
    runner: Callable[[dict], dict],
    out_dir: str | pathlib.Path,
    prefix: str = "KernelBenchmark",
    resume: bool = True,
    progress: bool = True,
    skip_errors: bool = True,
) -> list[pathlib.Path]:
    """Run ``runner`` over every expanded config; save each result as JSON.

    With ``skip_errors`` a failing config records an ``{"error": ...}`` JSON
    and the sweep continues (a toolchain crash on one kernel/shape must not
    lose the rest of a long sweep). Returns all result file paths.
    """
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    configs = dict_list(params)
    paths = []
    for i, config in enumerate(configs):
        path = out / savename(prefix, config)
        paths.append(path)
        if resume and path.exists():
            if progress:
                print(f"[{i + 1}/{len(configs)}] skip (exists): {path.name}")
            continue
        if progress:
            print(f"[{i + 1}/{len(configs)}] run: {path.name}", flush=True)
        try:
            result = runner(config)
        except Exception as e:  # noqa: BLE001 - record and continue
            if not skip_errors:
                raise
            result = dict(config)
            result["error"] = f"{type(e).__name__}: {e}"[:2000]
            if progress:
                print(f"  ERROR: {result['error'][:200]}", flush=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(result, default=_to_jsonable, indent=1))
        tmp.rename(path)
    return paths


def collect_results(out_dir: str | pathlib.Path, pattern: str = "*.json"):
    """Load every saved result into a pandas DataFrame."""
    import pandas as pd

    rows = []
    for p in sorted(pathlib.Path(out_dir).glob(pattern)):
        rows.append(json.loads(p.read_text()))
    return pd.DataFrame(rows)
