"""Finding a cell's pieces by name: `BENCHMARK.json` at the checkout's root
names the cells, and each cell's configuration, traffic mix, metrics and
limits are files of their own under ``benchmark/``:

- ``configs/<config>.json``: the configuration (its ``file`` in `BENCHMARK.json`);
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``metrics/<metric>.py``: one reader per metric, end to end or per layer;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``reference/<name>.py``: the plain reference a configuration names.

Adding any of them is adding a file and an entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from typing import NamedTuple

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list            # the entries of every metric the cell reports, end to end first
    readers: dict            # metric name -> its reader module
    limits: dict             # number compared -> {"limit": ..., ...}
    reference: object        # the configuration's reference module


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path, kind: str):
    """The Python file ``path`` as a module of its own (a metric's name may hold dots)."""
    if not path.exists():
        raise FileNotFoundError(f"no {kind} {path}")
    name = f"benchmark_{kind}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module          # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports, then its per-layer metrics:
    those that list the cell, or list no cells and move an end-to-end metric
    the cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]
    return e2e + layer


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files."""
    here = root / "benchmark"
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    metrics = cell_metrics(bench, workload)
    readers = {m["name"]: load_module(here / "metrics" / f"{m['name']}.py", "metric")
               for m in metrics}
    limits = load_json(here / "limits" / f"{workload}.json")
    reference = load_module(here / "reference" / f"{config['reference']}.py", "reference")
    return Cell(workload, int(entry["chips"]), config, traffic, metrics, readers, limits,
                reference)
