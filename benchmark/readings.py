#!/usr/bin/env python3
"""The readings a cell's limits are set from: the numbers that decide
``correct`` for the program on many seeds and for the control (the reference
in the program's place, one precision step below f32) on a few, all in one
process at the cell's own size on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 101 102 ... \
        --control-seeds 201 202 203 --seconds 2 [--out readings.json]

The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control-seconds", type=float, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from benchmark import gold, harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    ref = cell.reference
    table = torch.from_numpy(gold.code_table()).to("cuda")
    control = ref.track_bank_control(ref.LoopConfig.from_fields(cell.config["track"]), table)
    judge, judge_s = harness.judge, []

    def timed_judge(*args, **kwargs):
        start = time.perf_counter()
        try:
            return judge(*args, **kwargs)
        finally:
            judge_s.append(time.perf_counter() - start)

    harness.judge = timed_judge
    rows = []
    for side, seeds, program, seconds in (
            ("program", args.seeds, None, args.seconds),
            ("control", args.control_seeds, control, args.control_seconds or args.seconds)):
        for seed in seeds:
            result = harness.run(cell, seed, seconds, False, "cuda", program=program,
                                 log=lambda _: None)
            row = {"side": side, "seed": seed, "correct": result["correct"],
                   "attempted": result["attempted"], "check_s": judge_s[-1],
                   **{name: v["value"] for name, v in result["checks"].items()}}
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = {}
    for side in ("program", "control"):
        for name in cell.limits:
            values = [r[name] for r in rows if r["side"] == side]
            if values:
                summary[f"{side}.{name}"] = {"min": min(values), "max": max(values)}
    print(json.dumps({"summary": summary, "card": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary},
                                                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
