"""The whole step's share of the card's peak, in percent: the bank
correlation's operations (`yardstick.bank_correlation`) of every block of the
traced sub-window over its wall span and the peak of the configuration's
precision. It bounds the kernels' shares from above, so a kernel taken off
the path cannot leave a gain unbounded."""

from benchmark import yardstick

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "realtime_channels"
WORKLOADS = ["gpsl1_k1024.epoch20", "gpsl1_a4l7_k1024.epoch20"]


def read(run):
    if run.reading is None or run.card is None or run.reading.window_s <= 0.0:
        return None
    flops, _ = yardstick.bank_correlation(run.cell.config)
    peak = float(run.card["flops_per_s"][yardstick.precision_key(run.cell.config)])
    return 100.0 * flops * run.reading.blocks / (run.reading.window_s * peak)
