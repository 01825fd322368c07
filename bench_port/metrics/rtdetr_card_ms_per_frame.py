"""The oracle RT-DETR (models/rtdetr.py through the shared wrapper:
the planes' upload, the preprocessing, the network with K11, the
post-processing): device time of the operations launched from the
calling thread during each detector call (bench_port/windows.py; the
call sits inside the harness's `bench.oracle` range, which the profiler
does not record on the pixel stage's threads), per oracle frame."""

from bench_port import windows


def read(run):
    if not run["oracle_frames"]:
        return None
    us = windows.issued_in(run, "oracle")
    return us / 1e3 / run["oracle_frames"] if us else None
