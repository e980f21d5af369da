"""Device ops a replayed block runs: the port's ``graphs.scan.replayed_nodes``
over ``graphs.scan.replays`` (each body graph's node count, read once at its
capture, per block replayed), counters of the whole run, read after the
traced sub-window. A program without the counters, or one that replayed no
block, reads None."""

LAYER = "entry and graph replay"
UNIT, SOURCE, MOVES = "nodes", "program_counter", "realtime_channels"


def read(run):
    if run.reading is None:
        return None
    try:
        from gpuacceleratedtracking_tpu_torch.tracking import graphs
    except ImportError:
        return None
    replays = getattr(graphs.scan, "replays", 0)
    if not replays:
        return None
    return graphs.scan.replayed_nodes / replays
