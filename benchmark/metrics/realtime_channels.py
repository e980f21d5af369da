"""Channels tracked in real time: K x (blocks completed in the window x the
block's duration) / the window's wall time. All the work over all the time,
on the host clock."""

UNIT, BETTER, SOURCE = "channels", "higher", "host_clock"


def read(run):
    track = run.cell.config["track"]
    block_s = float(track["num_samples"]) / float(track["sampling_frequency"])
    return int(run.cell.config["bank"]["channels"]) * run.blocks * block_s / run.window_s
