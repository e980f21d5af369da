"""The device's idle share of the traced sub-window, in percent:
1 - (the union of its kernels, copies and fills) / (the traced wall span)."""

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "realtime_channels"
WORKLOADS = ["gpsl1_k1024.epoch20", "gpsl1_a4l7_k1024.epoch20"]


def read(run):
    if run.reading is None or run.reading.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.reading.busy_s / run.reading.window_s)
