"""The 95th percentile, over every epoch of the window, of the time from the
call's start to its outputs and final state in host memory (after the
consumer's synchronise), in milliseconds, on the host clock. A tail of all
the window's epochs, not of chunks."""

import statistics

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    if len(run.epoch_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.epoch_s, n=20, method="inclusive")[-1]
