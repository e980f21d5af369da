"""The host's time in a call of the entry point, from its start until it
returns (before the consumer's read-back and synchronise), summed over the
window's calls and divided by their count: the benchmark's own span around
`tracking.track_bank` -> `tracking.graphs.scan`, in milliseconds."""

LAYER = "entry and graph replay"
UNIT, SOURCE, MOVES = "ms", "program_span", "epoch_p95_ms"


def read(run):
    return 1e3 * run.host_call_s / run.calls
