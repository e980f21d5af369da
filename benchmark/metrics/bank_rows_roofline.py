"""``csrc/bank_rows.cu``'s share of its roofline (its kernel and its finish),
against the bank correlation's own count (`yardstick.bank_correlation`)."""

from benchmark import yardstick

LAYER = "bank correlator kernel"
UNIT, SOURCE, MOVES = "%", "device_trace", "realtime_channels"
KERNELS = r"\bbank_rows_(kernel|finish)\b"


def read(run):
    return yardstick.roofline_pct(run, KERNELS, yardstick.bank_correlation(run.cell.config))
