"""Host tracking (tracker/host.py CC + SORT, scheduler/, the selector's
feed): the pipeline's `StageTimers.host_mirror`, per input frame. It
includes the wait for each chunk's masks to land in host memory, since
the timer opens before that copy is waited for."""


def read(run):
    if not run["frames"]:
        return None
    return 1e3 * sum(j.result.timers.host_mirror for j in run["jobs"]) / run["frames"]
