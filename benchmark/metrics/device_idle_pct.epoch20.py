"""The device's idle share of the traced sub-window, in percent:
1 - (the union of a card's kernels, copies and fills) / (the traced wall
span), averaged over the cell's cards (`trace.Reading.busy_s`)."""

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "realtime_channels"


def read(run):
    if run.reading is None or run.reading.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.reading.busy_s / run.reading.window_s)
