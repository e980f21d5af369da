"""The host's time copying out the port's results, in milliseconds, a mean
per ``track_bank`` call over the traced sub-window: the ``scan.collect``
(each chunk's outputs, and the final carry, copied into the call's fresh
buffers) and ``scan.results`` spans (`tracking.spans`, recorded only while
the profiler does); a program without them reads None."""

LAYER = "entry and graph replay"
UNIT, SOURCE, MOVES = "ms", "program_span", "epoch_p95_ms"
SPANS = ("scan.collect", "scan.results")


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
