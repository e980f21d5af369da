"""Set-up: process start to the first timed call (imports, the card's
context, the kernel libraries, the capture's synthesis, graph capture and
the warm calls of the cell's own shape)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
