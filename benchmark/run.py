#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (a traced sub-window after the
measured one). The last line of standard output is one JSON object; the last
lines of standard error are the numbers that decide ``correct``, each beside
its limit. It exits non-zero, with no result, where the card is missing or
too few, and where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded
at the end.
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


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True,
                        help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def err(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)    # one process, few threads: the host paces part of each epoch

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        err("no CUDA device: torch.cuda.is_available() is false")
        return 2
    if torch.cuda.device_count() < cell.chips:
        err(f"{args.workload} needs {cell.chips} cards, torch sees {torch.cuda.device_count()}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_start=T_START, log=err)
    found = harness.forbidden_modules()
    if found:
        err(f"modules that must not load were loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
