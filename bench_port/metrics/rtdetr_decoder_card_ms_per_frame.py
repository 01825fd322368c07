"""RT-DETR's decoder (six layers of self-attention, the value projection,
K11, the FFN and the box refinement, the last layer's class head): device
time of the operations launched inside the model's `decode`
(oracles/rtdetr.py marks it `bench.rtdetr.decoder` and keeps its window;
bench_port/windows.py), per oracle frame."""

from bench_port import windows


def read(run):
    if not run["oracle_frames"]:
        return None
    us = windows.issued_in(run, "bench.rtdetr.decoder")
    return us / 1e3 / run["oracle_frames"] if us else None
