"""Cache entries the port's ``graphs.scan`` made and dropped over the run:
its counters ``graphs.scan.captures`` plus ``graphs.scan.evictions``, read
after the traced sub-window. A cell calls one signature, captured once at
set-up, so a steady run reads 1; a call that captured again, or an entry
dropped, reads more. A program without the counters reads None."""

LAYER = "entry and graph replay"
UNIT, SOURCE, MOVES = "entries", "program_counter", "realtime_channels"


def read(run):
    if run.reading is None:
        return None
    try:
        from gpuacceleratedtracking_tpu_torch.tracking import graphs
    except ImportError:
        return None
    captures = getattr(graphs.scan, "captures", None)
    if captures is None:
        return None
    return captures + graphs.scan.evictions
