"""The device's time in copies between cards, in milliseconds, a mean per
traced call: Kineto's ``Memcpy PtoP`` events (the call's blocks and each
shard's carry from the first card to the others, each shard's results back
onto it), summed over the cell's cards. A cell on one card, or a trace with
no such copy, reads None."""

LAYER = "cross-card staging and join"
UNIT, SOURCE, MOVES = "ms", "device_trace", "realtime_channels"
COPIES = r"^Memcpy PtoP"


def read(run):
    if run.reading is None:
        return None
    seconds = run.reading.kernel_seconds(COPIES)
    if seconds <= 0.0:
        return None
    calls = run.reading.blocks / int(run.cell.traffic["blocks_per_call"])
    return 1e3 * seconds / calls
