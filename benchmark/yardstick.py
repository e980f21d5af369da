"""The yardstick: the problem's operations and bytes, and the chip's peaks.

Counts are of the problem, not of any kernel, so a later kernel of another
formulation is read against the same work:

- the bank correlation of one block: ``K * A * N * (6 + 4 L)`` flops, the
  complex carrier wipe-off of every (channel, antenna, sample) (4 multiplies,
  2 adds) and a code-weighted complex accumulate per tap (2 multiplies, 2
  adds); bytes: the block's signal, the code table and the channels' NCO state
  read once, the ``[K, A, L]`` complex accumulators written once;
- the loop closure of one block: its bytes alone (a few hundred flops a
  channel): every state leaf and the accumulators read once, every state leaf
  but the PRN and every output leaf written once.

Peaks are in ``peaks.json`` beside this file, by the name
``torch.cuda.get_device_name()`` gives.
"""

from __future__ import annotations

import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
F32 = 4
# The loop's per-channel output scalars beside the accumulators: prompt re/im,
# carrier and code Doppler, carrier and code phase, PLL and DLL error, C/N0.
OUTPUT_SCALARS = 9


def shape(config: dict) -> tuple[int, int, int, int]:
    """``(K, A, N, L)`` of a configuration."""
    bank, track = config["bank"], config["track"]
    return (int(bank["channels"]), int(bank["antennas"]), int(track["num_samples"]),
            len(track["sample_shifts"]))


def bank_correlation(config: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of one block of the bank correlation."""
    k, a, n, taps = shape(config)
    table = int(config["track"]["code_length"]) * int(config["bank"]["table_prns"]) * F32
    flops = float(k * a * n * (6 + 4 * taps))
    signal = a * n * 2 * F32
    nco = k * 5 * F32                       # PRN, carrier Doppler and phase, code Doppler and phase
    accumulators = k * a * taps * 2 * F32
    return flops, float(signal + table + nco + accumulators)


def state_bytes_per_channel(config: dict) -> int:
    """Bytes of one channel's tracking state: PRN, four NCO values, two loop
    filters of two integrators, the C/N0 window's prompts and count, the block
    count, the previous prompt and the coherent sums of every tap."""
    taps = len(config["track"]["sample_shifts"])
    window = int(config["track"]["cn0_window"])
    return F32 * (1 + 4 + 4 + 2 * window + 1 + 1 + 2 + 2 * taps)


def loop_closure(config: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of one block of the loop closure; flops are not counted."""
    k, a, _, taps = shape(config)
    state = state_bytes_per_channel(config)
    accumulators = a * taps * 2 * F32
    weights = a * 2 * F32 if a > 1 else 0
    read = k * (state + accumulators) + weights
    written = k * (state - F32 + accumulators + OUTPUT_SCALARS * F32)
    return 0.0, float(read + written)


def peaks(kind: str) -> dict | None:
    """The peak rates of the card named ``kind``, or None for a card the table lacks."""
    table = json.loads((HERE / "peaks.json").read_text())
    return table["cards"].get(kind)


def precision_key(config: dict) -> str:
    """The peak a configuration's stated precision is read against: for f32,
    the dense TF32 rate, the fastest the card multiplies f32 operands."""
    table = json.loads((HERE / "peaks.json").read_text())
    return table["precision_of"][config["precision"]]


def least_seconds(flops: float, nbytes: float, card: dict, precision: str) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    compute = flops / float(card["flops_per_s"][precision])
    memory = nbytes / float(card["bytes_per_s"])
    return (compute, "operations") if compute >= memory else (memory, "bytes")


def roofline_pct(run, pattern: str, counts: tuple[float, float]) -> float | None:
    """A kernel's share of its roofline in a traced run, in percent: the least
    time of its blocks' work (``counts`` per block) over the summed device
    time of the ops whose name matches ``pattern``. None where the run has no
    trace, the card is not in the table, or no such op ran."""
    if run.reading is None or run.card is None:
        return None
    seconds = run.reading.kernel_seconds(pattern)
    if seconds <= 0.0:
        return None
    least, _ = least_seconds(*counts, run.card, precision_key(run.cell.config))
    return 100.0 * least * run.reading.blocks / seconds
