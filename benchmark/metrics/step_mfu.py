"""The whole step's share of the cell's peak, in percent: the bank
correlation's operations (`yardstick.bank_correlation`) of every block of the
traced sub-window over its wall span and the peak of the configuration's
precision on each card the trace read, times their number. It bounds the
kernels' shares from above, so a kernel taken off the path cannot leave a
gain unbounded."""

from benchmark import yardstick

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "realtime_channels"


def read(run):
    if run.reading is None or run.card is None or run.reading.window_s <= 0.0:
        return None
    flops, _ = yardstick.bank_correlation(run.cell.config)
    precision = yardstick.precision_key(run.cell.config)
    peak = len(run.reading.busy_by_card) * float(run.card["flops_per_s"][precision])
    return 100.0 * flops * run.reading.blocks / (run.reading.window_s * peak)
