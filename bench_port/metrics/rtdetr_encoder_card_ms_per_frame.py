"""RT-DETR's hybrid encoder through query selection (AIFI, CCFM, the
decoder's input projections, the anchors' mask, the heads over 8400
tokens and the top 300): device time of the operations launched inside
the model's `encode` (oracles/rtdetr.py marks it `bench.rtdetr.encoder`
and keeps its window; bench_port/windows.py), per oracle frame."""

from bench_port import windows


def read(run):
    if not run["oracle_frames"]:
        return None
    us = windows.issued_in(run, "bench.rtdetr.encoder")
    return us / 1e3 / run["oracle_frames"] if us else None
