"""The host's time issuing the port's block replays, in milliseconds, a mean
per ``track_bank`` call over the traced sub-window: the ``scan.replay``
spans, one per chunk of blocks (`tracking.spans`, recorded only while the
profiler does); a program without them reads None."""

LAYER = "entry and graph replay"
UNIT, SOURCE, MOVES = "ms", "program_span", "epoch_p95_ms"
SPANS = ("scan.replay",)


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
