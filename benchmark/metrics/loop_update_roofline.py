"""``csrc/loop_update.cu``'s share of its roofline, against the loop
closure's own bytes (`yardstick.loop_closure`): the kernel is bound by them."""

from benchmark import yardstick

LAYER = "loop closure kernel"
UNIT, SOURCE, MOVES = "%", "device_trace", "realtime_channels"
KERNELS = r"\bloop_update_kernel\b"


def read(run):
    return yardstick.roofline_pct(run, KERNELS, yardstick.loop_closure(run.cell.config))
