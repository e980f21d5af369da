"""The host's time in the port's state load, in milliseconds, a mean per
``track_bank`` call over the traced sub-window: the ``scan.load`` (the
carry, constants and first chunk copied into the entry), ``scan.prologue``
(its replay) and ``scan.next_chunk`` spans (`tracking.spans`, recorded only
while the profiler does); a program without them reads None."""

LAYER = "entry and graph replay"
UNIT, SOURCE, MOVES = "ms", "program_span", "epoch_p95_ms"
SPANS = ("scan.load", "scan.prologue", "scan.next_chunk")


def read(run):
    if run.reading is None:
        return None
    try:
        from gpuacceleratedtracking_tpu_torch.tracking import spans
    except ImportError:
        return None
    totals = spans.totals()
    root = totals.get("track_bank")
    if root is None or root.count == 0:
        return None
    return 1e3 * sum(totals[name].seconds for name in SPANS if name in totals) / root.count
