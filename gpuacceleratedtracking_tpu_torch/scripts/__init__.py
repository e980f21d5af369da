"""The port's entry points: counterparts of the JAX package's ``scripts/``.

Each module has the file name of its JAX counterpart and runs as
``python -m gpuacceleratedtracking_tpu_torch.scripts.<name>``. They run on
the card unless the caller asks for the CPU (the sweeps' ``cpu_params``, or
``--cpu`` where the JAX script has it or a host default), and write to the
port's own directories, never over the JAX records: records under
``data/torch/``, figures under ``img/torch/``.
"""

import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
DATA = ROOT / "data" / "torch"
BENCHMARKS = DATA / "benchmarks"
IMG = ROOT / "img" / "torch"
