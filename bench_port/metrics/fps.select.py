"""Frames analysed a second, as metrics/fps.py reads it, in the traced
run of a cell whose runs spread too widely with the host's speed for
`fps` to be bounded there: the rate is kept for the record, and the
profiler's cost on the host lowers it a little."""


def read(run):
    return run["frames"] / run["window_s"] if run["frames"] else None
