"""Host entropy decode (the port's codec, C++ over ctypes): the
pipeline's `StageTimers.entropy_decode`, a host clock around each chunk's
decode, summed over the window's jobs, per input frame.

The same reading as metrics/entdec_ms_per_frame.py, for cells that bound
card_ms_per_frame rather than fps."""


def read(run):
    if not run["frames"]:
        return None
    return 1e3 * sum(j.result.timers.entropy_decode for j in run["jobs"]) / run["frames"]
