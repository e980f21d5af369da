"""Helpers of the benchmark's CPU tests: a copy of the benchmark whose cells are
cut to a size the CPU runs in a second, and a run of one of them."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, spec  # noqa: E402

SEED = 2**31 + 12345          # larger than 32 signed bits hold
MESH_CELL = "gpsl1_k1024_4card.epoch20"      # `add_mesh_cell`'s


def copy_benchmark(dest: pathlib.Path) -> pathlib.Path:
    """``BENCHMARK.json`` and ``benchmark/`` copied under ``dest``."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def shrink(root: pathlib.Path, channels: int = 8, blocks: int = 8) -> pathlib.Path:
    """Cut every configuration and traffic mix under ``root`` to a CPU's size:
    K=8 channels a channel shard (8 without a mesh, 32 on a mesh of 4), each
    shard every PRN of a cycle of 8, at 8.192 MHz (N = 8192, taps every 4
    samples, still the rows and composite routes), 3 satellites, an 8-block
    capture, 4 blocks to an epoch20 call, no warm-up time."""
    for path in (root / "benchmark" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        taps = len(config["track"]["sample_shifts"])
        shards = int(config.get("mesh", {}).get("chan", 1))
        config["bank"].update(channels=channels * shards, prn_cycle=channels)
        config["track"].update(sampling_frequency=8.192e6, num_samples=8192,
                               sample_shifts=[4 * (i - taps // 2) for i in range(taps)])
        path.write_text(json.dumps(config))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(satellites=3, capture_blocks=blocks, warm_calls=1, warm_seconds=0.0,
                       check_calls=3, check_blocks=4)
        if traffic["blocks_per_call"] > 1:
            traffic["blocks_per_call"] = 4
        path.write_text(json.dumps(traffic))
    return root


def add_mesh_cell(root: pathlib.Path, base: str = "gpsl1_k1024.epoch20") -> pathlib.Path:
    """Add `MESH_CELL` to the copy at ``root``: ``base``'s configuration with
    a ``mesh`` of four cards (chan 4, time 1) and four times its channels, so
    that each channel shard holds ``base``'s PRN cycle, ``base``'s traffic and
    limits, on 4 chips, reporting what ``base`` reports. Off the card its mesh is
    four repeated CPU devices, which `track_bank_sharded` runs on its
    one-device branch (`graphs.scan`); only a run on four distinct cards
    takes the staging, `graphs.scan_mesh` and the join."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    entry = cells[base]
    name, traffic = MESH_CELL.split(".", 1)
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    config.update(name=name, mesh={"chan": 4, "time": 1})
    config["bank"]["channels"] *= 4
    path = root / "benchmark" / "configs" / f"{name}.json"
    path.write_text(json.dumps(config))
    shutil.copy(root / "benchmark" / "limits" / f"{base}.json",
                root / "benchmark" / "limits" / f"{MESH_CELL}.json")
    bench["configs"].append(dict(configs[entry["config"]], name=name,
                                 file=f"benchmark/configs/{name}.json"))
    bench["workloads"].append(dict(entry, name=MESH_CELL, config=name, chips=4))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if base in metric.get("workloads", ()):
            metric["workloads"].append(MESH_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def tiny_root(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark cut to a CPU's size, with `MESH_CELL` added."""
    return add_mesh_cell(shrink(copy_benchmark(tmp)))


def run(root: pathlib.Path, workload: str, seconds: float = 0.3, seed: int = SEED, **kwargs):
    """One run of ``workload`` of the copy at ``root`` on the CPU."""
    cell = spec.load_cell(workload, root)
    return harness.run(cell, seed, seconds, False, "cpu", log=lambda _: None, **kwargs)
