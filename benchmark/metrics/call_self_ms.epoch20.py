"""The self time of the port's ``track_bank`` span, in milliseconds, a mean
per call over the traced sub-window: the call's argument handling, closures,
signature and cache lookup, and `graphs.scan`'s bookkeeping around its
phases (the span's time less its ``scan.*`` child spans'). The spans record
only while the profiler does (`tracking.spans`); a program without them
reads None."""

LAYER = "entry and graph replay"
UNIT, SOURCE, MOVES = "ms", "program_span", "epoch_p95_ms"


def read(run):
    if run.reading is None:
        return None
    try:
        from gpuacceleratedtracking_tpu_torch.tracking import spans
    except ImportError:
        return None
    root = spans.totals().get("track_bank")
    if root is None or root.count == 0:
        return None
    return 1e3 * root.self_seconds / root.count
