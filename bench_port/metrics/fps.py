"""Frames analysed a second: the input frames of every job the window
ran, over the window's wall time (from the first job's start to the end
of the last, which ends the first whole cycle after --seconds)."""


def read(run):
    return run["frames"] / run["window_s"] if run["frames"] else None
